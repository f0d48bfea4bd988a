"""Linear BVH, Karras 2012 (twin of ti_raytrace_tpu/accel/lbvh.py).

`build_lbvh_device` runs on the device of its input tensors: morton codes
(utils/morton.morton3d), one stable sort, the Karras topology vectorised
over all internal nodes with fixed-trip loops, and the bottom-up AABB fit
as a fixpoint loop (at most tree-height iterations, each ending in one
host test of termination).  `flatten_threaded` turns the fat tree into
the threaded layout on the host: DFS preorder nodes, where descending
moves to idx + 1 and skipping a subtree jumps to escape[idx], so
traversal (accel/traverse.py) keeps one cursor per ray and no stack.

Equal morton codes take the augmented delta: delta(i, j) =
clz(code_i ^ code_j), or 32 + clz(i ^ j) on a tie.  Every gather clips
its index first: the range search probes far past n - 1.
"""

import math

import numpy as np
import torch

from ti_raytrace_tpu_torch.utils.morton import clz32, morton3d


def _delta(codes, i, j, n):
    """Karras delta with index augmentation on equal codes; -1 where i or
    j lies outside [0, n - 1]."""
    valid = (j >= 0) & (j < n) & (i >= 0) & (i < n)
    ic = torch.clamp(i, 0, n - 1)
    jc = torch.clamp(j, 0, n - 1)
    ci = codes[ic]
    cj = codes[jc]
    base = clz32(torch.bitwise_xor(ci, cj))
    tie = 32 + clz32(torch.bitwise_xor(ic, jc))
    d = torch.where(ci == cj, tie, base)
    return torch.where(valid, d, -1)


def _karras_topology(codes, n: int):
    """Children (left, right) of the n - 1 internal nodes, as node ids:
    internal nodes are [0, n - 2], leaf k is node (n - 1) + k."""
    K = max(1, math.ceil(math.log2(max(n, 2))))
    i = torch.arange(n - 1, dtype=torch.int64, device=codes.device)

    d_next = _delta(codes, i, i + 1, n)
    d_prev = _delta(codes, i, i - 1, n)
    d = torch.where(d_next > d_prev, 1, -1)
    dmin = _delta(codes, i, i - d, n)

    # exponential expansion of the range length's upper bound
    l_max = torch.full_like(i, 2)
    grow = torch.ones_like(i, dtype=torch.bool)
    for _ in range(K + 2):
        c = grow & (_delta(codes, i, i + l_max * d, n) > dmin)
        l_max = torch.where(c, l_max * 2, l_max)
        grow = c

    # binary search for the other end
    length = torch.zeros_like(i)
    for k in range(K + 1, -1, -1):
        t = 1 << k
        c = ((2 * t) <= l_max) & (_delta(codes, i, i + (length + t) * d, n) > dmin)
        length = torch.where(c, length + t, length)
    j = i + length * d
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    # the split: highest differing bit within [first, last]
    d_node = _delta(codes, first, last, n)
    split = first
    stride = last - first
    active = torch.ones_like(i, dtype=torch.bool)
    for _ in range(K + 1):
        stride = (stride + 1) >> 1
        cand = split + stride
        c = active & (cand < last) & (_delta(codes, first, cand, n) > d_node)
        split = torch.where(c, cand, split)
        active = active & (stride > 1)

    leaf_base = n - 1
    left = torch.where(split == first, leaf_base + split, split)
    right = torch.where(split + 1 == last, leaf_base + split + 1, split + 1)
    return left.to(torch.int32), right.to(torch.int32)


def _maximum(a, b):
    """Elementwise max with -0 < +0 (IEEE 754-2019 `maximum`, as XLA
    computes it; torch's pick between zeros of two signs varies with the
    device and the vector path).  For two zeros, a + b is their maximum."""
    return torch.where((a == 0) & (b == 0), a + b, torch.maximum(a, b))


def _minimum(a, b):
    """Elementwise min with -0 < +0; for two zeros, -(-a + -b)."""
    return torch.where((a == 0) & (b == 0), -(-a + -b), torch.minimum(a, b))


def _fit_aabbs(left, right, leaf_min, leaf_max, n: int):
    """Bottom-up AABB fit as a fixpoint: a node's box is set once both
    children are ready.  Returns (int_min, int_max, ready, iterations)."""
    n_int = n - 1
    big = 3.4e38
    dev = leaf_min.device

    def child_box(c, int_min, int_max, ready):
        is_leaf = c >= n_int
        li = torch.clamp(c - n_int, 0, n - 1).long()
        ii = torch.clamp(c, 0, max(n_int - 1, 0)).long()
        cmin = torch.where(is_leaf[:, None], leaf_min[li], int_min[ii])
        cmax = torch.where(is_leaf[:, None], leaf_max[li], int_max[ii])
        return cmin, cmax, is_leaf | ready[ii]

    ready = torch.zeros((n_int,), dtype=torch.bool, device=dev)
    int_min = torch.full((n_int, 3), big, dtype=torch.float32, device=dev)
    int_max = torch.full((n_int, 3), -big, dtype=torch.float32, device=dev)
    it = 0
    while it < n_int + 1 and not bool(ready.all()):
        lmin, lmax, lready = child_box(left, int_min, int_max, ready)
        rmin, rmax, rready = child_box(right, int_min, int_max, ready)
        now = lready & rready & ~ready
        int_min = torch.where(now[:, None], _minimum(lmin, rmin), int_min)
        int_max = torch.where(now[:, None], _maximum(lmax, rmax), int_max)
        ready = ready | now
        it += 1
    return int_min, int_max, ready, it


def build_lbvh_device(prim_min, prim_max, scene_min, scene_max):
    """The fat tree of per-primitive AABBs prim_min/prim_max (n, 3) f32,
    built on their device: dict(n, sorted_idx, left, right, leaf_min,
    leaf_max, int_min, int_max, ready, iterations) of tensors (`ready`
    and `iterations`, the fit's count of fixpoint steps, absent at n = 1)."""
    n = int(prim_min.shape[0])
    dev = prim_min.device
    centroid = 0.5 * (prim_min + prim_max)
    extent = torch.clamp(scene_max - scene_min, min=1e-12)
    q = (centroid - scene_min) / extent
    codes = morton3d(q[..., 0], q[..., 1], q[..., 2])

    sorted_codes, order = torch.sort(codes, stable=True)
    sorted_idx = order.to(torch.int32)
    leaf_min = prim_min[order]
    leaf_max = prim_max[order]

    if n == 1:
        return dict(
            n=1, sorted_idx=sorted_idx,
            left=torch.zeros((0,), dtype=torch.int32, device=dev),
            right=torch.zeros((0,), dtype=torch.int32, device=dev),
            leaf_min=leaf_min, leaf_max=leaf_max,
            int_min=torch.zeros((0, 3), dtype=torch.float32, device=dev),
            int_max=torch.zeros((0, 3), dtype=torch.float32, device=dev),
        )

    left, right = _karras_topology(sorted_codes, n)
    int_min, int_max, ready, iterations = _fit_aabbs(left, right, leaf_min, leaf_max, n)
    return dict(n=n, sorted_idx=sorted_idx, left=left, right=right, leaf_min=leaf_min,
                leaf_max=leaf_max, int_min=int_min, int_max=int_max, ready=ready,
                iterations=iterations)


def flatten_threaded(tree) -> dict:
    """Host DFS flatten of the fat tree into threaded compact nodes, all
    of length 2n - 1 in preorder: bvh_min/bvh_max (K, 3) f32, bvh_prim
    int32 (the original primitive id at a leaf, -1 inside), bvh_escape
    int32 (the DFS index after the node's subtree; K ends traversal)."""
    n = int(tree["n"])
    sorted_idx = _np(tree["sorted_idx"])
    leaf_min = _np(tree["leaf_min"])
    leaf_max = _np(tree["leaf_max"])
    K = 2 * n - 1
    if n == 1:
        return dict(bvh_min=leaf_min[:1].astype(np.float32),
                    bvh_max=leaf_max[:1].astype(np.float32),
                    bvh_prim=sorted_idx[:1].astype(np.int32),
                    bvh_escape=np.ones((1,), np.int32))

    left = _np(tree["left"]).tolist()
    right = _np(tree["right"]).tolist()
    n_int = n - 1
    sizes = _subtree_sizes(left, right, n_int).tolist()

    # preorder walk carrying the escape index down: escape(left child) =
    # the right child's DFS start, escape(right child) = escape(parent)
    node_of = [0] * K
    escape = [0] * K
    out = 0
    pending = [(0, K)]  # (node id, escape index)
    while pending:
        node_id, esc = pending.pop()
        node_of[out] = node_id
        escape[out] = esc
        if node_id < n_int:
            l, r = left[node_id], right[node_id]
            right_start = out + 1 + (1 if l >= n_int else sizes[l])
            pending.append((r, esc))
            pending.append((l, right_start))
        out += 1
    assert out == K, (out, K)

    node_of = np.asarray(node_of, np.int64)
    leaf = node_of >= n_int
    k = np.where(leaf, node_of - n_int, 0)
    inner = np.where(leaf, 0, node_of)
    all_min = np.where(leaf[:, None], leaf_min[k], _np(tree["int_min"])[inner])
    all_max = np.where(leaf[:, None], leaf_max[k], _np(tree["int_max"])[inner])
    return dict(
        bvh_min=all_min.astype(np.float32),
        bvh_max=all_max.astype(np.float32),
        bvh_prim=np.where(leaf, sorted_idx[k], -1).astype(np.int32),
        bvh_escape=np.asarray(escape, np.int32),
    )


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _subtree_sizes(left, right, n_int: int) -> np.ndarray:
    """Node count of every internal subtree by one iterative post-order
    pass (a degenerate morton chain needs no recursion)."""
    sizes = [0] * max(n_int, 1)
    stack = [(0, False)]
    while stack:
        nd, expanded = stack.pop()
        if nd >= n_int:
            continue
        l, r = int(left[nd]), int(right[nd])
        if expanded:
            sizes[nd] = 1 + (1 if l >= n_int else sizes[l]) + (1 if r >= n_int else sizes[r])
        else:
            stack.append((nd, True))
            stack.append((l, False))
            stack.append((r, False))
    return np.asarray(sizes, np.int64)


def build_bvh(prim_min, prim_max, scene_min, scene_max, device="cuda") -> dict:
    """The whole build: morton codes, sort, topology and fit on `device`,
    then the host's threaded flatten.  Inputs are numpy arrays or
    tensors; returns the numpy compact arrays (flatten_threaded)."""
    def f32(x):
        return torch.as_tensor(_np(x), dtype=torch.float32).to(device)

    tree = build_lbvh_device(f32(prim_min), f32(prim_max), f32(scene_min), f32(scene_max))
    return flatten_threaded(tree)


# ---------------------------------------------------------------------------
# validation predicates over the compact arrays
# ---------------------------------------------------------------------------

def check_containment(compact) -> bool:
    """Every inner node's box contains both children's (to 1e-4)."""
    bmin = np.asarray(compact["bvh_min"])
    bmax = np.asarray(compact["bvh_max"])
    esc = np.asarray(compact["bvh_escape"])
    prim = np.asarray(compact["bvh_prim"])
    eps = 1e-4
    inner = np.flatnonzero(prim < 0)
    for c in (inner + 1, esc[inner + 1]):  # left child, then right (the left's escape)
        if not (np.all(bmin[inner] <= bmin[c] + eps) and np.all(bmax[inner] >= bmax[c] - eps)):
            return False
    return True


def check_coverage(compact, n_prims: int) -> bool:
    """Every primitive appears in exactly one leaf."""
    prim = np.asarray(compact["bvh_prim"])
    leaves = np.sort(prim[prim >= 0])
    return leaves.shape[0] == n_prims and np.array_equal(
        leaves, np.arange(n_prims, dtype=leaves.dtype))


def dump_nodes(compact, path: str) -> None:
    """Write every compact node to a text file, one line each."""
    bmin = np.asarray(compact["bvh_min"])
    bmax = np.asarray(compact["bvh_max"])
    prim = np.asarray(compact["bvh_prim"])
    esc = np.asarray(compact["bvh_escape"])
    with open(path, "w") as f:
        for i in range(prim.shape[0]):
            kind = "leaf" if prim[i] >= 0 else "node"
            f.write(
                f"{i} {kind} prim={prim[i]} escape={esc[i]} "
                f"min=({bmin[i,0]:.6f},{bmin[i,1]:.6f},{bmin[i,2]:.6f}) "
                f"max=({bmax[i,0]:.6f},{bmax[i,1]:.6f},{bmax[i,2]:.6f})\n"
            )
