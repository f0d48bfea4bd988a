"""Surface-area-heuristic BVH builder on the host (twin of
ti_raytrace_tpu/accel/sah.py, numpy): a full-sweep SAH (cost = 0.125 +
p_below * n_below + p_above * n_above) with vectorised prefix scans per
axis.  `build_bvh_sah` emits the threaded compact layout of
accel/lbvh.build_bvh (preorder nodes + escape indices), so the BVH
oracle (accel/traverse.py) takes either tree; it trades a slower host
build for better trees on irregular geometry.
"""

import sys

import numpy as np

TRAVERSAL_COST = 0.125


def _surface(bmin, bmax):
    e = np.maximum(bmax - bmin, 0.0)
    return 2.0 * (
        e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] + e[..., 2] * e[..., 0]
    )


def build_bvh_sah(prim_min: np.ndarray, prim_max: np.ndarray) -> dict:
    """Full-sweep SAH build -> threaded compact arrays (same contract as
    lbvh.build_bvh): dict(bvh_min, bvh_max, bvh_prim, bvh_escape)."""
    n = int(prim_min.shape[0])
    prim_min = np.asarray(prim_min, np.float64)
    prim_max = np.asarray(prim_max, np.float64)
    centroid = 0.5 * (prim_min + prim_max)
    order = tuple(np.argsort(centroid[:, a], kind="stable") for a in range(3))

    nodes_min: list = []
    nodes_max: list = []
    nodes_prim: list = []

    sys.setrecursionlimit(max(10000, 10 * n))

    def rec(ids3):
        """Emit subtree in preorder; returns subtree node count."""
        ids = ids3[0]
        m = ids.shape[0]
        bmin = prim_min[ids].min(0)
        bmax = prim_max[ids].max(0)
        if m == 1:
            nodes_min.append(bmin)
            nodes_max.append(bmax)
            nodes_prim.append(int(ids[0]))
            return 1

        best = None
        inv_sa = 1.0 / max(_surface(bmin, bmax), 1e-20)
        for a in range(3):
            ida = ids3[a]
            lo = prim_min[ida]
            hi = prim_max[ida]
            pre_min = np.minimum.accumulate(lo, axis=0)
            pre_max = np.maximum.accumulate(hi, axis=0)
            suf_min = np.minimum.accumulate(lo[::-1], axis=0)[::-1]
            suf_max = np.maximum.accumulate(hi[::-1], axis=0)[::-1]
            i = np.arange(1, m)
            cost = TRAVERSAL_COST + inv_sa * (
                _surface(pre_min[:-1], pre_max[:-1]) * i
                + _surface(suf_min[1:], suf_max[1:]) * (m - i)
            )
            k = int(np.argmin(cost))
            if best is None or cost[k] < best[0]:
                best = (float(cost[k]), a, k + 1)
        _, axis, split = best

        in_left = np.zeros(n, bool)
        in_left[ids3[axis][:split]] = True
        left3 = tuple(ida[in_left[ida]] for ida in ids3)
        right3 = tuple(ida[~in_left[ida]] for ida in ids3)

        nodes_min.append(bmin)
        nodes_max.append(bmax)
        nodes_prim.append(-1)
        lsz = rec(left3)
        rsz = rec(right3)
        return 1 + lsz + rsz

    rec(order)

    bvh_prim = np.asarray(nodes_prim, np.int32)
    K = bvh_prim.shape[0]
    escape = np.zeros((K,), np.int32)
    _fill_escape(bvh_prim, escape, 0, K)
    return dict(
        bvh_min=np.asarray(nodes_min, np.float32),
        bvh_max=np.asarray(nodes_max, np.float32),
        bvh_prim=bvh_prim,
        bvh_escape=escape,
    )


def _fill_escape(prim: np.ndarray, escape: np.ndarray, i: int, esc: int) -> int:
    """Preorder escape fill: escape[x] = DFS index after subtree(x).
    Returns subtree size."""
    escape[i] = esc
    if prim[i] >= 0:
        return 1
    # left subtree escapes to the start of the right subtree, which is
    # only known after sizing the left subtree: size it via a scan first
    lsz = _subtree_size(prim, i + 1)
    right_start = i + 1 + lsz
    _fill_escape(prim, escape, i + 1, right_start)
    rsz = _fill_escape(prim, escape, right_start, esc)
    return 1 + lsz + rsz


def _subtree_size(prim: np.ndarray, i: int) -> int:
    if prim[i] >= 0:
        return 1
    l = _subtree_size(prim, i + 1)
    r = _subtree_size(prim, i + 1 + l)
    return 1 + l + r
