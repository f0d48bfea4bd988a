"""Cluster acceleration structure: median-split blocks of 128 triangles
(host numpy; twin of ti_raytrace_tpu/accel/clusters.py, median method).

Each cluster stores its AABB (`cluster_bounds` (8, C): rows 0:3 min,
3:6 max, 6 validity) and a planar triangle block (`cluster_tri`
(12, C*B): rows 0:3 v0, 3:6 e1, 6:9 e2, 9 prim id as float, 10:12 pad).
`cluster_attr` (C*B, A) keeps prim_attr in cluster-slot order so host
dicts stay byte-equal to the reference's; the port's tracer fetches
attributes by prim id instead and never reads it.  The reference's
matmul-form table `cluster_mt` is not built: only its disabled MT_MXU
kernel mode reads it.
"""

import numpy as np

from reference.plain.core import constants as C

CLUSTER_B = 128  # triangles per cluster
TRI_ROWS = 12
CHUNK_PAD = 128  # cluster count padded to this multiple


def _median_split_order(pmin, pmax, block: int) -> np.ndarray:
    """Recursive longest-axis median split into runs of <= block tris;
    internal splits are block multiples, so clusters never straddle
    leaves."""
    centroid = 0.5 * (pmin + pmax)
    out = []
    stack = [np.arange(pmin.shape[0])]
    while stack:
        ids = stack.pop()
        if ids.shape[0] <= block:
            out.append(ids)
            continue
        c = centroid[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        half = (ids.shape[0] // (2 * block) + (ids.shape[0] % (2 * block) > 0)) * block
        half = min(half, ids.shape[0] - 1)
        part = np.argpartition(c[:, axis], half)
        stack.append(ids[part[half:]])
        stack.append(ids[part[:half]])
    return np.concatenate(out)


def _empty_bounds(n: int) -> np.ndarray:
    """Padding-cluster bounds.  A branchless slab test cannot represent
    'never hit' with min > max, so row 6 is an explicit validity flag."""
    bounds = np.zeros((8, n), np.float32)
    bounds[0:3, :] = 1e30
    bounds[3:6, :] = -1e30
    return bounds


def build_clusters(host: dict, block: int = CLUSTER_B) -> dict:
    """cluster_bounds (8, C), cluster_tri (12, C*block) and cluster_attr
    (C*block, A) from the host scene dict; C is a multiple of CHUNK_PAD and
    at least one chunk (degenerate if the scene has no triangles)."""
    A = host["prim_attr"].shape[0]
    tri_ids = np.nonzero(host["prim_type"] == C.PRIM_TRI)[0]
    T = tri_ids.shape[0]

    if T == 0:
        tri = np.zeros((TRI_ROWS, CHUNK_PAD * block), np.float32)
        tri[9, :] = -1.0
        return dict(cluster_bounds=_empty_bounds(CHUNK_PAD), cluster_tri=tri,
                    cluster_attr=np.zeros((CHUNK_PAD * block, A), np.float32))

    v0 = host["tri_v0"][tri_ids]
    e1 = host["tri_e1"][tri_ids]
    e2 = host["tri_e2"][tri_ids]
    v1 = v0 + e1
    v2 = v0 + e2
    pmin = np.minimum(np.minimum(v0, v1), v2)
    pmax = np.maximum(np.maximum(v0, v1), v2)
    order = _median_split_order(pmin, pmax, block)

    leaves = [order[i:i + block] for i in range(0, T, block)]
    n_real = len(leaves)
    n_clusters = ((n_real + CHUNK_PAD - 1) // CHUNK_PAD) * CHUNK_PAD
    P_pad = n_clusters * block
    slot = np.full(P_pad, -1, np.int64)
    for i, leaf in enumerate(leaves):
        slot[i * block:i * block + leaf.shape[0]] = leaf

    valid = slot >= 0
    src = np.where(valid, slot, 0)
    vm = valid.astype(np.float32)
    tri = np.zeros((TRI_ROWS, P_pad), np.float32)
    tri[0:3] = v0[src].T * vm
    tri[3:6] = e1[src].T * vm
    tri[6:9] = e2[src].T * vm
    tri[9] = np.where(valid, tri_ids[src].astype(np.float32), -1.0)

    attr = np.zeros((P_pad, A), np.float32)
    attr[valid] = host["prim_attr"][:, tri_ids[src[valid]]].T

    bounds = _empty_bounds(n_clusters)
    for c in range(n_real):
        sel = leaves[c]
        bounds[0:3, c] = pmin[sel].min(0)
        bounds[3:6, c] = pmax[sel].max(0)
    bounds[6, :n_real] = 1.0
    return dict(cluster_bounds=bounds, cluster_tri=tri, cluster_attr=attr)
