"""Tracer dispatch (twin of ti_raytrace_tpu/accel/__init__.py).

Scenes above DENSE_MAX_PRIMS primitives use the cluster tracer
(ops/cluster_trace.py), whose kernel runs on CUDA tensors and whose plain
PyTorch version runs on CPU tensors.  The dense tracer for smaller scenes
is not ported yet.  Planar convention: rays are (3, N).
"""

DENSE_MAX_PRIMS = 4096


def trace_shaded(scene, origin, direction, shared_origin=None, tile_order: bool = False):
    """Planar closest hit + shading pack -> (t, prim, uv_bary, attr) of a
    coherent wavefront (static morton camera lanes or a presorted carry).

    shared_origin: (3,) common ray origin (pinhole camera wavefronts) —
    one shared front-to-back cluster order and the shared-origin narrow
    phase.  tile_order: per-tile front-to-back order for a presorted
    wavefront."""
    if scene.n_prims <= DENSE_MAX_PRIMS:
        raise NotImplementedError(
            "the dense tracer (scenes of at most 4096 prims) is outside the "
            "ported slice (ROADMAP 'to port': the dense tracer + the "
            "cornell/single_model slice)")
    from ti_raytrace_tpu_torch.ops.cluster_trace import trace_clustered

    return trace_clustered(scene, origin, direction, sort_rays=False, want_attr=True,
                           shared_origin=shared_origin, tile_order=tile_order)


def needs_presort(scene) -> bool:
    """Does this scene use the cluster tracer (which wants morton-presorted
    wavefronts)?"""
    return scene.n_prims > DENSE_MAX_PRIMS
