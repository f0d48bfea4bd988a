"""Tracer dispatch (twin of ti_raytrace_tpu/accel/__init__.py).

Scenes above DENSE_MAX_PRIMS primitives use the cluster tracer
(ops/cluster_trace.py), whose kernel runs on CUDA tensors and whose plain
PyTorch version runs on CPU tensors.  The dense tracer for smaller scenes
is not ported yet.  `trace` returns (t, prim); `trace_shaded` adds the
barycentrics and the packed shading attributes.  Planar convention: rays
are (3, N).
"""

DENSE_MAX_PRIMS = 4096


def _check_cluster_scene(scene):
    if scene.n_prims <= DENSE_MAX_PRIMS:
        raise NotImplementedError(
            "the dense tracer (scenes of at most 4096 prims) is outside the "
            "ported slice (ROADMAP 'to port': the dense tracer + the "
            "cornell/single_model slice)")


def trace(scene, origin, direction, sort_rays: bool = True, sort_small: bool = False,
          tile_order: bool = False, tmax=None, active=None, cap_frac=None):
    """Planar closest hit: origin/direction (3, N) -> (t, prim).

    sort_rays=False skips the coherence sort/unsort (the wavefront is
    already coherent); sort_small=True sorts even wavefronts narrower
    than the tracer's SMALL_WAVEFRONT (NEE shadow rays of compacted
    phases).  tmax / active / cap_frac belong to the BDPT slice and
    raise."""
    _check_cluster_scene(scene)
    from ti_raytrace_tpu_torch.ops.cluster_trace import trace_clustered

    t, prim, _ = trace_clustered(scene, origin, direction, sort_rays=sort_rays,
                                 sort_small=sort_small, tile_order=tile_order,
                                 tmax=tmax, active=active, cap_frac=cap_frac)
    return t, prim


def trace_shaded(scene, origin, direction, sort_rays: bool = True, sort_small: bool = False,
                 shared_origin=None, tile_order: bool = False):
    """Planar closest hit + shading pack -> (t, prim, uv_bary, attr).

    shared_origin: (3,) common ray origin (pinhole camera wavefronts) —
    one shared front-to-back cluster order and the shared-origin narrow
    phase.  tile_order: per-tile front-to-back order for a presorted
    wavefront (sort_rays=False)."""
    _check_cluster_scene(scene)
    from ti_raytrace_tpu_torch.ops.cluster_trace import trace_clustered

    return trace_clustered(scene, origin, direction, sort_rays=sort_rays, want_attr=True,
                           sort_small=sort_small, shared_origin=shared_origin,
                           tile_order=tile_order)


def needs_presort(scene) -> bool:
    """Does this scene use the cluster tracer (which wants morton-presorted
    wavefronts)?"""
    return scene.n_prims > DENSE_MAX_PRIMS
