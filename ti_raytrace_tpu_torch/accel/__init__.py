"""Tracer dispatch (twin of ti_raytrace_tpu/accel/__init__.py).

Two tracers share one contract, and the scene's primitive count picks
one: scenes of at most DENSE_MAX_PRIMS primitives take the dense planar
sweep (ops/dense_trace.py), larger ones the cluster tracer
(ops/cluster_trace.py); each runs its kernel on CUDA tensors and its
plain PyTorch version on CPU tensors.  `trace` returns
(t, prim); `trace_shaded` adds the barycentrics and the packed shading
attributes.  Planar convention: rays are (3, N).
"""

DENSE_MAX_PRIMS = 4096


def trace(scene, origin, direction, sort_rays: bool = True, sort_small: bool = False,
          tile_order: bool = False, tmax=None, active=None, cap_frac=None):
    """Planar closest hit: origin/direction (3, N) -> (t, prim).

    sort_rays=False skips the coherence sort/unsort (the wavefront is
    already coherent); sort_small=True sorts even wavefronts narrower
    than the tracer's SMALL_WAVEFRONT (NEE shadow rays of compacted
    phases).

    tmax: optional (N,) shadow-ray distance bound: the cluster tracer
    reports hits at t >= tmax as misses; the dense tracer ignores it and
    returns the true closest hit.  Exact under both for `prim == target`
    / within-bound predicates.  active + cap_frac: occupancy packing (the
    cluster tracer's sorted mode, the dense tracer's capped sweep);
    inactive lanes' results are undefined across the tracers (misses
    under the cluster tracer, real hits or misses under the dense one),
    so callers read only the lanes they marked active."""
    if scene.n_prims <= DENSE_MAX_PRIMS:
        from ti_raytrace_tpu_torch.ops.dense_trace import trace_planar, trace_planar_capped

        if active is not None and cap_frac is not None:
            return trace_planar_capped(scene, origin, direction, active, cap_frac)
        return trace_planar(scene, origin, direction)
    from ti_raytrace_tpu_torch.ops.cluster_trace import trace_clustered

    t, prim, _ = trace_clustered(scene, origin, direction, sort_rays=sort_rays,
                                 sort_small=sort_small, tile_order=tile_order,
                                 tmax=tmax, active=active, cap_frac=cap_frac)
    return t, prim


def trace_capacity(scene, n: int, cap_frac: float):
    """Lanes that `trace(..., active=, cap_frac=)` runs on for a wavefront
    of n lanes of this scene, or None where it runs on all of them (the
    cluster tracer below its sort threshold).  Active lanes beyond the
    capacity come back as misses: callers count them as kills."""
    if scene.n_prims <= DENSE_MAX_PRIMS:
        from ti_raytrace_tpu_torch.ops.dense_trace import capacity_lanes

        return capacity_lanes(n, cap_frac)
    from ti_raytrace_tpu_torch.ops.cluster_trace import SMALL_WAVEFRONT, capacity_lanes

    return capacity_lanes(n, cap_frac) if n > SMALL_WAVEFRONT else None


def trace_shaded(scene, origin, direction, sort_rays: bool = True, sort_small: bool = False,
                 shared_origin=None, tile_order: bool = False, active=None, cap_frac=None):
    """Planar closest hit + shading pack -> (t, prim, uv_bary, attr).

    shared_origin: (3,) common ray origin (pinhole camera wavefronts) —
    one shared front-to-back cluster order and the shared-origin narrow
    phase.  tile_order: per-tile front-to-back order for a presorted
    wavefront (sort_rays=False).  active + cap_frac: as in `trace`, for
    the cluster tracer only.  The dense tracer takes none of these."""
    if scene.n_prims <= DENSE_MAX_PRIMS:
        from ti_raytrace_tpu_torch.ops.dense_trace import trace_shaded as dense_shaded

        return dense_shaded(scene, origin, direction)
    from ti_raytrace_tpu_torch.ops.cluster_trace import trace_clustered

    return trace_clustered(scene, origin, direction, sort_rays=sort_rays, want_attr=True,
                           sort_small=sort_small, shared_origin=shared_origin,
                           tile_order=tile_order, active=active, cap_frac=cap_frac)


def needs_presort(scene) -> bool:
    """Does this scene use the cluster tracer (which wants morton-presorted
    wavefronts)?"""
    return scene.n_prims > DENSE_MAX_PRIMS
