"""Stackless BVH traversal over whole ray wavefronts (twin of
ti_raytrace_tpu/accel/traverse.py): the closest-hit oracle that the
cluster tracer is held against.  It shares nothing with the cluster
tracer but the triangles: its own tree (accel/lbvh.py, threaded layout),
its own slab test and intersection (scene/intersect.py).  It is a test
and smoke oracle; `accel.trace` never dispatches to it.

Every ray carries one node cursor: descending moves to idx + 1, skipping
a subtree jumps to escape[idx], and each iteration moves every ray one
node.  The loop's only host sync is its termination test, made every
CHECK_EVERY iterations (a finished lane's cursor no longer moves, so
the spacing changes no result); at that test the lanes still walking are
packed together once they are at most half of the working set, which
changes no result either (lanes never interact).
"""

import torch

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.scene.intersect import intersect_prim_any
from ti_raytrace_tpu_torch.utils.geometry import slabs

CHECK_EVERY = 16


def trace_closest(scene, origin, direction, stats=None):
    """Closest hit over the scene's BVH: origin/direction (N, 3) ->
    (t, prim_id), t = INF and prim_id = -1 on a miss.  A primitive is
    accepted at t > 0 and t < best.  stats: a dict that gains
    "iterations", the loop's trip count."""
    n_nodes = scene.n_nodes
    N = origin.shape[0]
    dev = origin.device
    t_out = torch.full((N,), C.INF, dtype=torch.float32, device=dev)
    p_out = torch.full((N,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(N, device=dev)
    idx = torch.zeros((N,), dtype=torch.int64, device=dev)
    best_t, best_prim = t_out.clone(), p_out.clone()
    o, d = origin, direction
    it = 0
    while True:
        if it % CHECK_EVERY == 0:
            walking = idx < n_nodes
            n_walk = int(walking.sum())
            if n_walk == 0:
                break
            if n_walk <= lane.shape[0] // 2:  # pack the lanes still walking
                t_out[lane], p_out[lane] = best_t, best_prim
                keep = torch.nonzero(walking).squeeze(1)
                lane, idx, best_t, best_prim, o, d = (
                    x[keep] for x in (lane, idx, best_t, best_prim, o, d))
        active = idx < n_nodes
        nidx = torch.clamp(idx, 0, n_nodes - 1)
        prim = scene.bvh_prim[nidx]
        is_leaf = prim >= 0
        box_hit, _ = slabs(o, d, scene.bvh_min[nidx], scene.bvh_max[nidx], t_max=best_t)

        # leaf: distance-only primitive test
        t = intersect_prim_any(scene, o, d, torch.clamp(prim, min=0))
        closer = active & is_leaf & box_hit & (t > 0.0) & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_prim = torch.where(closer, prim, best_prim)

        descend = active & ~is_leaf & box_hit
        nxt = torch.where(descend, nidx + 1, scene.bvh_escape[nidx].long())
        idx = torch.where(active, nxt, idx)
        it += 1
    t_out[lane], p_out[lane] = best_t, best_prim
    if stats is not None:
        stats["iterations"] = it
    return t_out, p_out


def trace_closest_masked(scene, origin, direction, mask):
    """trace_closest for the lanes of `mask`; the others miss at once."""
    t, prim = trace_closest(
        scene,
        torch.where(mask[:, None], origin, torch.zeros_like(origin)),
        torch.where(mask[:, None], direction, torch.ones_like(direction)),
    )
    return torch.where(mask, t, C.INF), torch.where(mask, prim, -1)


def trace_brute_force(scene, origin, direction):
    """Every primitive for every ray, in blocks of 512 primitives: the
    oracle of the traversal itself.  (N, 3) -> (t, prim_id); the lowest
    index wins a tie."""
    block = 512
    N = origin.shape[0]
    P = scene.n_prims
    dev = origin.device
    best_t = torch.full((N,), C.INF, dtype=torch.float32, device=dev)
    best_prim = torch.full((N,), -1, dtype=torch.int32, device=dev)
    for p0 in range(0, P, block):
        pid = p0 + torch.arange(block, dtype=torch.int32, device=dev)
        pvalid = pid < P
        pid_c = torch.clamp(pid, 0, P - 1)
        t = intersect_prim_any(scene, origin[:, None, :], direction[:, None, :],
                               pid_c[None, :].expand(N, block))  # (N, block)
        t = torch.where(pvalid[None, :] & (t > 0.0), t, C.INF)
        arg = torch.argmin(t, dim=1)
        tmin = torch.gather(t, 1, arg[:, None])[:, 0]
        closer = tmin < best_t
        best_t = torch.where(closer, tmin, best_t)
        best_prim = torch.where(closer, pid_c[arg], best_prim)
    return best_t, best_prim
