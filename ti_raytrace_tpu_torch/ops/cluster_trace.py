"""Cluster-stream closest-hit tracer: host side, the CUDA kernel's wrapper
and its plain PyTorch version (twin of ti_raytrace_tpu/ops/cluster_trace.py).

Rays are split into tiles of TILE lanes.  Each tile walks the clusters
(128-triangle blocks, accel/clusters.py) in a front-to-back order; a ray
tests a cluster's triangles only if it enters the cluster box closer than
its current best hit.  Orders:
  * `_point_order` — one shared order from a single origin (pinhole camera
    wavefronts), paired with the shared-origin Moller-Trumbore table
    `_origin_mt_table`;
  * `_tile_order_from_cent` — a per-tile order from each tile's mean
    origin (morton-presorted deep wavefronts), generic Moller-Trumbore;
  * `_static_order` — the clusters' build order, for anything else.

Candidacy is re-derived per cluster from each ray's current best hit, so
there is no candidate-refresh period to clamp (the reference's REFRESH);
ties resolve as in the reference: first cluster in order with the
minimal t, then the lowest triangle slot.  Every order runs whole
superclusters (GROUP consecutive clusters, `_expand_supers`), and the
kernel skips a supercluster that no ray of a warp enters before its best
hit, reading the scene's `super_table` (built once, scene/data.py).

`cluster_trace` dispatches on the tensors' device: CPU tensors take
`cluster_trace_plain`, CUDA tensors take the kernel in
csrc/cluster_trace.cu (built at first use) — no fallback between them.
The kernel returns (t, prim, u, v) per lane; the winner's attributes are
then gathered from prim_attr by prim id (exact, replacing the reference's
in-kernel one-hot matmul), and the analytic spheres are traced densely.

Sorted mode (`sort_rays=True`, the un-presorted deep bounces, NEE
shadow rays and BDPT's walk and shadow wavefronts): the lanes are
stable-sorted by their coherence key (`_coherence_order`: `sort_key`,
one launch of csrc/coherence_key.cu on CUDA tensors and its plain twin on
CPU ones, then torch.sort), gathered into planar sorted order, traced
with a per-tile order from the sorted tiles' mean origins, and the hit
record is gathered back through the inverse permutation.  The reference's row-record ray layout was a TPU BlockSpec
artefact; the kernel takes the same planar operands in every mode.

Shadow rays (BDPT) add a per-lane `tmax` bound, which seeds the kernel's
best hit (hits at or beyond it come back as misses), and `active` +
`cap_frac` occupancy packing in sorted mode: inactive lanes take the
padding key, so the kernel runs on the first `capacity_lanes` sorted
lanes only and the cut tail unsorts as a miss.

The reference's tuning flags (TSKIP, NSUB, MT_MXU, ATTR_*, DEFER_ATTR,
BF16_SLAB, TILE_WIDE*, ...) are measured-loss or diagnostic paths of the
TPU kernel and stay there.
"""

import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.ops.cuda_build import I32, I64, PTR, Launcher

TILE = 256       # rays per tile (one CUDA block)
GROUP = 32       # clusters per supercluster of the front-to-back order
CLUSTER_B = 128  # triangles per cluster (accel/clusters.CLUSTER_B)
SMALL_WAVEFRONT = 32768  # the reference skips its sort below this width

PAD_KEY = 1 << 62  # coherence key of padding lanes: after every 60-bit key


# --------------------------------------------------------------- orders

def _coherence_key(scene, o, d):
    """30-bit morton codes (int64) of the origin in the scene box and of
    the direction: the wavefront's coherence sort key (origin-major)."""
    from ti_raytrace_tpu_torch.utils.morton import morton3d

    lo = scene.aabb_min
    span = torch.clamp(scene.aabb_max - scene.aabb_min, min=1e-12)
    q = [(o[k] - lo[k]) / span[k] for k in range(3)]
    code_o = morton3d(q[0], q[1], q[2])
    code_d = morton3d(d[0] * 0.5 + 0.5, d[1] * 0.5 + 0.5, d[2] * 0.5 + 0.5)
    return code_o, code_d


def coherence_key60_plain(scene, o, d):
    """The two coherence keys as one int64 (origin morton << 30 |
    direction morton): ascending order of it is the reference's two-key
    (origin, direction) lexicographic order.  The plain twin of
    csrc/coherence_key.cu (~130 torch calls)."""
    key_o, key_d = _coherence_key(scene, o, d)
    return (key_o << 30) | key_d


def _sort_key_plain(scene, o, d, n_pad=None, active=None, alive=None):
    """sort_key in torch ops: coherence_key60_plain, the dead bit, PAD_KEY
    outside `active` and on the padding lanes."""
    key = coherence_key60_plain(scene, o, d)
    if alive is not None:
        key = ((~alive).to(torch.int64) << 60) | key
    if active is not None:
        key = torch.where(active, key, PAD_KEY)
    if n_pad is not None:
        key = torch.nn.functional.pad(key, (0, n_pad - o.shape[1]), value=PAD_KEY)
    return key


class _CoherenceKeyKernel(Launcher):
    """csrc/coherence_key.cu: the sort key of a wavefront in one launch."""

    SOURCE = "coherence_key.cu"
    ENTRIES = {"coherence_key_launch": [PTR, I64, I64, PTR, I64, I64, PTR, I64, PTR, I64,
                                        PTR, I64, PTR, I64, PTR, I64, I64, PTR]}
    ERROR = "coherence_key_error_string"

    @staticmethod
    def check(o, d, lo, hi, n_pad, active, alive):
        """The CUDA device and N of a valid call; ValueError otherwise."""
        named = (("o", o, torch.float32), ("d", d, torch.float32),
                 ("aabb_min", lo, torch.float32), ("aabb_max", hi, torch.float32),
                 ("active", active, torch.bool), ("alive", alive, torch.bool))
        for name, x, _ in named:
            if x is not None and not isinstance(x, torch.Tensor):
                raise ValueError(f"coherence key: {name} must be a tensor, got "
                                 f"{type(x).__name__}")
        device, n = o.device, o.shape[-1]
        for name, x, dtype in named:
            if x is None:
                continue
            if x.dtype != dtype:
                raise ValueError(f"coherence key: {name} must be {dtype}, got {x.dtype}")
            if x.device != device:
                raise ValueError(f"coherence key: {name} must lie on {device}, got {x.device}")
            want = (3, n) if name in ("o", "d") else (3,) if name.startswith("aabb") else (n,)
            if tuple(x.shape) != want:
                raise ValueError(f"coherence key: {name} must be {want}, got {tuple(x.shape)}")
        if n_pad < n:
            raise ValueError(f"coherence key: n_pad {n_pad} is below the {n} lanes")
        if device.type != "cuda":
            raise ValueError(f"coherence key: the kernel runs on a CUDA device, got {device}")
        return device, n

    def __call__(self, o, d, lo, hi, n_pad=None, active=None, alive=None):
        """The sort key (n_pad,) int64 (n_pad None: N) of the planar wavefront
        o, d (3, N) in the box lo, hi (3,), read by their strides, by one
        launch; zero lanes launch nothing."""
        n_pad = o.shape[-1] if n_pad is None else n_pad
        device, n = self.check(o, d, lo, hi, n_pad, active, alive)
        key = torch.empty(n_pad, dtype=torch.int64, device=device)
        if n_pad:
            masks = []
            for m in (active, alive):
                masks += (0, 0) if m is None else (m.data_ptr(), m.stride()[0])
            self.launch("coherence_key_launch", device, o.data_ptr(), *o.stride(),
                        d.data_ptr(), *d.stride(), lo.data_ptr(), lo.stride()[0],
                        hi.data_ptr(), hi.stride()[0], *masks, key.data_ptr(), n, n_pad)
        return key


COHERENCE_KERNEL = _CoherenceKeyKernel()


def key_route(x) -> str:
    """The coherence key's route for a tensor: "kernel" on a CUDA device,
    "plain" on the CPU; any other device raises."""
    if x.device.type == "cuda":
        return "kernel"
    if x.device.type == "cpu":
        return "plain"
    raise NotImplementedError(f"coherence key: no implementation for {x.device}")


def sort_key(scene, o, d, n_pad=None, active=None, alive=None):
    """The coherence sort key (n_pad,) int64 of the wavefront o, d (3, N)
    (n_pad None: N): coherence_key60 on each lane, 1 << 60 added on the
    lanes outside `alive` (dead lanes sort after live ones), PAD_KEY on the
    lanes outside `active` and on the padding lanes [N, n_pad).  On CUDA
    tensors one launch of csrc/coherence_key.cu (COHERENCE_KERNEL), on CPU
    tensors the plain twin; the two give the same bits."""
    if key_route(o) == "kernel":
        return COHERENCE_KERNEL(o, d, scene.aabb_min, scene.aabb_max, n_pad, active, alive)
    return _sort_key_plain(scene, o, d, n_pad, active, alive)


def coherence_key60(scene, o, d):
    """The two coherence keys as one int64 (origin morton << 30 |
    direction morton), the kernel on CUDA tensors, coherence_key60_plain on
    CPU tensors (sort_key without masks or padding)."""
    return sort_key(scene, o, d)


def _coherence_order(scene, o, d, n_pad: int, active=None):
    """Stable lane order (n_pad,) int64 of the wavefront by coherence_key60:
    the sort key (one launch on the card) and one torch.sort.  Padding
    lanes, and lanes outside `active`, take PAD_KEY and sort after every
    other lane; lanes parked at 1e9 clamp to the top origin cell, after
    every live lane inside the scene box."""
    return torch.sort(sort_key(scene, o, d, n_pad, active), stable=True).indices


def _super_boxes(cb, n_clusters):
    """Bounds (S, 3) of the superclusters: GROUP consecutive clusters,
    spatially adjacent by median-split construction."""
    S = n_clusters // GROUP
    bmin = cb[0:3, :n_clusters].T.reshape(S, GROUP, 3).amin(dim=1)
    bmax = cb[3:6, :n_clusters].T.reshape(S, GROUP, 3).amax(dim=1)
    return bmin, bmax


def super_table(cb):
    """Supercluster table (8, S) of the cluster bounds (8, C): for each run
    of GROUP clusters, rows 0:3 the min of their box mins, 3:6 the max of
    their box maxes, 6 the max of their validity flags, 7 zero — the
    reference's `sb` in cluster order (it permutes it per order; the
    kernel reads it through the order).  Built once per scene
    (scene/data.py) for the kernel's supercluster skip."""
    S = cb.shape[1] // GROUP
    bmin, bmax = _super_boxes(cb, cb.shape[1])
    valid = cb[6].reshape(S, GROUP).amax(dim=1)
    return torch.cat([bmin.T, bmax.T, valid[None], torch.zeros_like(valid)[None]]).contiguous()


def _expand_supers(order_s):
    """Supercluster order (..., S) -> cluster order (..., S*GROUP) int32."""
    g = torch.arange(GROUP, dtype=order_s.dtype, device=order_s.device)
    order = order_s[..., None] * GROUP + g
    return order.reshape(*order_s.shape[:-1], -1).to(torch.int32)


def _point_order(cb, n_clusters, origin):
    """Shared front-to-back order (1, C) from ONE origin point (3,):
    superclusters by point-to-box distance, stable on ties."""
    bmin, bmax = _super_boxes(cb, n_clusters)
    p = torch.minimum(torch.maximum(origin[None, :], bmin), bmax)  # jnp.clip
    diff = p - origin[None, :]
    dist = (diff * diff).sum(dim=-1)
    order_s = torch.argsort(dist, stable=True)
    return _expand_supers(order_s)[None, :].contiguous()


def _tile_order_from_cent(cent, cb, n_clusters):
    """Per-tile front-to-back order (n_tiles, C) from each tile's mean
    origin (n_tiles, 3).  Only the order is built; the kernel reads the
    bounds through it (no per-tile permuted bound copies)."""
    bmin, bmax = _super_boxes(cb, n_clusters)
    c = cent[:, None, :]
    p = torch.minimum(torch.maximum(c, bmin[None]), bmax[None])
    diff = p - c
    dist = (diff * diff).sum(dim=-1)                       # (T, S)
    order_s = torch.argsort(dist, dim=1, stable=True)
    return _expand_supers(order_s).contiguous()


def _static_order(cb, n_clusters):
    """The clusters' build order, shared by every tile: (1, C)."""
    return torch.arange(n_clusters, dtype=torch.int32, device=cb.device)[None, :]


def _origin_mt_table(tri, origin):
    """Shared-origin Moller-Trumbore table (12, C*B) from the cluster tri
    table and one origin (3,): rows n = e2 x e1 (0:3), s = e2 x T (3:6),
    q = T x e1 (6:9), pid (9), tconst = e2 . q (10), pad (11), with
    T = origin - v0.  The narrow phase becomes det = d.n, u = d.s,
    v = d.q, t = tconst (sign-folded): equal to the generic form up to
    rounding."""
    v0, e1, e2, pid = tri[0:3], tri[3:6], tri[6:9], tri[9:10]
    tv = origin[:, None] - v0

    def cross(a, b):
        return torch.stack([
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ])

    q = cross(tv, e1)
    tconst = (e2 * q).sum(dim=0, keepdim=True)
    pad = torch.zeros_like(pid)
    return torch.cat([cross(e2, e1), cross(e2, tv), q, pid, tconst, pad], dim=0).contiguous()


# ------------------------------------------------------ plain + kernel

def _safe_inv(v):
    return 1.0 / torch.where(torch.abs(v) < 1e-12,
                             torch.where(v >= 0, 1e-12, -1e-12), v)


def slab(b, ox, oy, oz, ix, iy, iz):
    """Entry and exit distances (tn, tf) of rays (origin, inverse
    direction) through boxes b (rows 0:3 min, 3:6 max): the reference's
    slab test, in its operation order.  A ray enters the box if
    max(tn, 0) <= tf (and the box is valid)."""
    t1x = (b[0] - ox) * ix
    t2x = (b[3] - ox) * ix
    tn = torch.minimum(t1x, t2x)
    tf = torch.maximum(t1x, t2x)
    t1y = (b[1] - oy) * iy
    t2y = (b[4] - oy) * iy
    tn = torch.maximum(tn, torch.minimum(t1y, t2y))
    tf = torch.minimum(tf, torch.maximum(t1y, t2y))
    t1z = (b[2] - oz) * iz
    t2z = (b[5] - oz) * iz
    tn = torch.maximum(tn, torch.minimum(t1z, t2z))
    tf = torch.minimum(tf, torch.maximum(t1z, t2z))
    return tn, tf


def cluster_trace_plain(o, d, n_valid: int, bounds, order, tri, origin_mt: bool, tmax=None,
                        supers=None, stats=None):
    """The kernel's computation in plain PyTorch, vectorised over
    (tiles, TILE rays, CLUSTER_B triangles) and looped over sweep
    positions k: tile i tests cluster order[i, k].  Same inputs and
    outputs as the kernel (see csrc/cluster_trace.cu; tmax (n_pad,) or
    None): returns t (n_pad,), prim int32 (n_pad,), u, v (n_pad,) and
    visited int32 (n_tiles,).  `supers`, the kernel's supercluster table,
    is read only for `stats`: this version tests every sweep position, and the
    kernel's skip of whole superclusters changes no output.  stats: a
    dict that gains, as device scalars for the kernel's work count,
    "pairs", the candidate (ray, cluster) pairs at visit time, and
    "super_entries", the (live ray, supercluster) pairs whose super box
    the ray enters before its best hit at the supercluster's first sweep
    position (read from `supers`, or built from `bounds` if None): the
    only rays that need the 32 cluster-box tests of that supercluster."""
    n_pad = o.shape[1]
    T = n_pad // TILE
    nc = bounds.shape[1]
    dev = o.device
    if stats is not None and supers is None:
        supers = super_table(bounds)

    def lanes(x):
        return x.reshape(T, TILE, 1)

    ox, oy, oz = (lanes(o[k]) for k in range(3))
    dx, dy, dz = (lanes(d[k]) for k in range(3))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    live = lanes(torch.arange(n_pad, device=dev) < n_valid)
    order = order.expand(T, nc).long()
    blocks = tri.reshape(tri.shape[0], nc, CLUSTER_B)

    best_t = torch.full((T, TILE, 1), C.INF, dtype=torch.float32, device=dev)
    if tmax is not None:
        best_t = torch.where(lanes(tmax) > 0.0, lanes(tmax), best_t)
    best_p = torch.full((T, TILE, 1), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((T, TILE, 1), dtype=torch.float32, device=dev)
    best_v = torch.zeros((T, TILE, 1), dtype=torch.float32, device=dev)
    visited = torch.zeros(T, dtype=torch.int32, device=dev)
    slot = torch.arange(CLUSTER_B, device=dev)

    for k in range(nc):
        cid = order[:, k]
        if stats is not None and k % GROUP == 0:
            sb = supers[:, cid // GROUP].reshape(8, T, 1, 1)
            tn, tf = slab(sb, ox, oy, oz, ix, iy, iz)
            enter = live & (torch.clamp(tn, min=0.0) <= tf) & (sb[6] > 0.0) & (tn < best_t)
            stats["super_entries"] = stats.get("super_entries", 0) + enter.sum()
        b = bounds[:, cid].reshape(8, T, 1, 1)
        tn, tf = slab(b, ox, oy, oz, ix, iy, iz)
        cand = live & (torch.clamp(tn, min=0.0) <= tf) & (b[6] > 0.0) & (tn < best_t)
        if stats is not None:
            stats["pairs"] = stats.get("pairs", 0) + cand.sum()
        tile_any = cand.any(dim=1).reshape(T)
        if not bool(tile_any.any()):
            continue
        visited += tile_any.to(torch.int32)

        r = blocks[:, cid, :].reshape(blocks.shape[0], T, 1, CLUSTER_B)
        if origin_mt:
            det = dx * r[0] + dy * r[1] + dz * r[2]
            sgn = torch.sign(det)
            u = (dx * r[3] + dy * r[4] + dz * r[5]) * sgn
            v = (dx * r[6] + dy * r[7] + dz * r[8]) * sgn
            t = r[10] * sgn
        else:
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = r[0:9]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            sgn = torch.sign(det)
            tx = ox - v0x
            ty = oy - v0y
            tz = oz - v0z
            u = (tx * px + ty * py + tz * pz) * sgn
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            v = (dx * qx + dy * qy + dz * qz) * sgn
            t = (e2x * qx + e2y * qy + e2z * qz) * sgn
        adet = torch.abs(det)
        ok = (adet > 1e-12) & (u >= 0.0) & (u <= adet) & (v >= 0.0) & (u + v <= adet)
        inv = 1.0 / torch.where(adet > 1e-12, adet, 1.0)
        t = torch.where(ok, t * inv, C.INF)
        t = torch.where(t > 0.0, t, C.INF)

        tmin = t.amin(dim=2, keepdim=True)                          # (T,TILE,1)
        arg = torch.where(t == tmin, slot, CLUSTER_B).amin(dim=2, keepdim=True)
        closer = cand & (tmin < best_t)
        pid = r[9].expand(T, TILE, CLUSTER_B)
        best_t = torch.where(closer, tmin, best_t)
        best_p = torch.where(closer, torch.gather(pid, 2, arg).to(torch.int32), best_p)
        best_u = torch.where(closer, torch.gather(u * inv, 2, arg), best_u)
        best_v = torch.where(closer, torch.gather(v * inv, 2, arg), best_v)

    return (best_t.reshape(n_pad), best_p.reshape(n_pad), best_u.reshape(n_pad),
            best_v.reshape(n_pad), visited)


class _ClusterTraceKernel(Launcher):
    """csrc/cluster_trace.cu: one launch over a padded planar wavefront."""

    SOURCE = "cluster_trace.cu"
    ENTRIES = {"cluster_trace_launch": [PTR, PTR, PTR, I32, I32, PTR, PTR, I32, PTR, I32, PTR,
                                        I32, PTR, PTR, PTR, PTR, PTR, PTR]}
    ERROR = "cluster_trace_error_string"

    def __call__(self, o, d, n_valid: int, bounds, order, tri, origin_mt: bool, tmax=None,
                 supers=None):
        n_pad = o.shape[1]
        nc = bounds.shape[1]
        n_tiles = n_pad // TILE
        dev = o.device
        if supers is None:
            raise ValueError("cluster_trace: the kernel needs the supercluster table "
                             "(super_table(bounds), scene.super_bounds)")
        operands = [("o", o, torch.float32), ("d", d, torch.float32),
                    ("bounds", bounds, torch.float32), ("supers", supers, torch.float32),
                    ("order", order, torch.int32), ("tri", tri, torch.float32)]
        if tmax is not None:
            operands.append(("tmax", tmax, torch.float32))
        for name, x, dt in operands:
            if x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"cluster_trace: {name} must be a contiguous {dt} "
                                 f"tensor on {dev}, got {x.dtype} on {x.device}")
        if (o.shape != (3, n_pad) or d.shape != (3, n_pad) or n_pad % TILE
                or bounds.shape[0] != 8 or nc % GROUP or supers.shape != (8, nc // GROUP)
                or order.shape not in ((1, nc), (n_tiles, nc))
                or tri.shape != (12, nc * CLUSTER_B) or not 0 <= n_valid <= n_pad
                or (tmax is not None and tmax.shape != (n_pad,))):
            raise ValueError(
                f"cluster_trace: bad shapes o {tuple(o.shape)} d {tuple(d.shape)} "
                f"bounds {tuple(bounds.shape)} supers {tuple(supers.shape)} "
                f"order {tuple(order.shape)} "
                f"tri {tuple(tri.shape)} n_valid {n_valid} "
                f"tmax {None if tmax is None else tuple(tmax.shape)}")
        t = torch.empty(n_pad, dtype=torch.float32, device=dev)
        prim = torch.empty(n_pad, dtype=torch.int32, device=dev)
        u = torch.empty(n_pad, dtype=torch.float32, device=dev)
        v = torch.empty(n_pad, dtype=torch.float32, device=dev)
        visited = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        if n_tiles == 0:
            return t, prim, u, v, visited
        self.launch("cluster_trace_launch", dev,
                    o.data_ptr(), d.data_ptr(), None if tmax is None else tmax.data_ptr(),
                    n_pad, n_valid, bounds.data_ptr(), supers.data_ptr(), nc,
                    order.data_ptr(), int(order.shape[0] > 1), tri.data_ptr(), int(origin_mt),
                    t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                    visited.data_ptr())
        return t, prim, u, v, visited


KERNEL = _ClusterTraceKernel()


def cluster_trace(o, d, n_valid: int, bounds, order, tri, origin_mt: bool, tmax=None,
                  supers=None):
    """Closest hits of the padded planar wavefront (3, n_pad): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.device.type == "cuda":
        return KERNEL(o, d, n_valid, bounds, order, tri, origin_mt, tmax, supers)
    if o.device.type == "cpu":
        return cluster_trace_plain(o, d, n_valid, bounds, order, tri, origin_mt, tmax)
    raise NotImplementedError(f"cluster_trace: no implementation for {o.device}")


# ----------------------------------------------------------------- tracer

def capacity_lanes(N: int, cap_frac: float) -> int:
    """Kernel capacity of an `active`-masked sorted trace: cap_frac of N
    rounded up to whole tiles, at least one tile, at most the padded
    width.  Callers count capacity kills with the same rounding."""
    n_pad = -(-N // TILE) * TILE
    return min(n_pad, max(TILE, -(-int(N * cap_frac) // TILE) * TILE))


def kernel_inputs(scene, o, d, sort_rays: bool, shared_origin=None, tile_order: bool = False,
                  tmax=None, active=None, cap=None):
    """The kernel's operands for the planar wavefront o, d (3, N):
    ((o, d, n_valid, bounds, order, tri, origin_mt, tmax, supers), perm),
    padded to whole tiles; supers is the scene's supercluster table.
    tmax (N,) is padded with zeros (unbounded), or None.
    sort_rays: the lanes go in coherence order and perm is that lane order
    (n_pad,), else None; lanes outside `active` then get a zero direction
    (they miss everything) and sort after the active ones, and with `cap`
    the operands hold only the first cap sorted lanes.  The cluster order
    is the shared origin's, per tile (sorted or tile_order), or the
    static one."""
    N = o.shape[1]
    n_pad = -(-N // TILE) * TILE
    perm = None
    if sort_rays:
        with metrics.span("trace.order", route=key_route(o), n=N):
            perm = _coherence_order(scene, o, d, n_pad, active)
    with metrics.span("trace.pack"):
        rows = [o, d] if tmax is None else [o, d, tmax[None]]
        if sort_rays and active is not None:
            rows[1] = d * active[None]
        rays = torch.nn.functional.pad(torch.cat(rows), (0, n_pad - N))
        if sort_rays:
            rays = rays.index_select(1, perm if cap is None else perm[:cap])
        n_run = rays.shape[1]
        o_p, d_p = rays[0:3].contiguous(), rays[3:6].contiguous()
        tmax_p = None if tmax is None else rays[6].contiguous()
        cb = scene.cluster_bounds
        tri = scene.cluster_tri
        nc = cb.shape[1]
        origin_mt = shared_origin is not None
        if origin_mt:
            order = _point_order(cb, nc, shared_origin)
            tri = _origin_mt_table(tri, shared_origin)
        elif sort_rays or tile_order:
            # tile centroids from the padded origin rows (padding zeros only
            # skew the last partial tile's heuristic order; pruning is exact)
            cent = o_p.reshape(3, n_run // TILE, TILE).mean(dim=2).T
            order = _tile_order_from_cent(cent, cb, nc)
        else:
            order = _static_order(cb, nc)
    return (o_p, d_p, min(N, n_run), cb, order, tri, origin_mt, tmax_p,
            scene.super_bounds), perm


def trace_clustered(scene, o, d, sort_rays: bool = True, want_attr: bool = False,
                    sort_small: bool = False, shared_origin=None,
                    tile_order: bool = False, tmax=None, active=None, cap_frac=None):
    """Closest hit via the cluster kernel + dense analytic-sphere tail.

    o, d: planar (3, N).  Returns (t, prim, uv (2, N)) or, with want_attr,
    (t, prim, uv, attr (PRIM_A, N)); misses have t = INF, prim = -1 and
    zero attributes.  sort_rays: coherence-sort the lanes around the
    trace (skipped below SMALL_WAVEFRONT lanes unless sort_small);
    otherwise the wavefront must arrive coherent (a static morton camera
    wavefront with shared_origin, or a presorted carry with tile_order).

    tmax: optional (N,) per-lane bound on the hit distance (shadow rays
    know their target's); hits at t >= tmax come back as misses, lanes
    with tmax <= 0 are unbounded.  Exact for `prim == target` consumers.
    active + cap_frac (sorted mode only): inactive lanes come back as
    misses, and the kernel runs on `capacity_lanes(N, cap_frac)` lanes;
    active lanes beyond that capacity are cut to misses, so callers read
    only active lanes and size cap_frac with headroom."""
    N = o.shape[1]
    if N <= SMALL_WAVEFRONT and not sort_small:
        sort_rays = False
    cap = None
    if active is not None and cap_frac is not None and sort_rays:
        cap = capacity_lanes(N, cap_frac)
        if cap >= -(-N // TILE) * TILE:
            cap = None  # the capacity covers every lane: a plain sorted trace
    args, perm = kernel_inputs(scene, o, d, sort_rays, shared_origin, tile_order,
                               tmax, active, cap)
    with metrics.span("trace.kernel", n_valid=args[2], n_pad=args[0].shape[1],
                      bounded=tmax is not None):
        t, prim, u, v, _ = cluster_trace(*args)
    with metrics.span("trace.unsort"):
        if perm is not None:
            if cap is not None:
                # lanes beyond capacity unsort as misses with t = 0, so the
                # sphere tail below cannot bring them back
                cut = perm.shape[0] - cap
                t = torch.cat([t, t.new_zeros(cut)])
                prim = torch.cat([prim, prim.new_full((cut,), -1)])
                u = torch.cat([u, u.new_zeros(cut)])
                v = torch.cat([v, v.new_zeros(cut)])
            # live lanes sort before padding, so lanes [0, N) hold every hit;
            # gather them back to caller order through the inverse permutation
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.shape[0], device=perm.device)
            inv = inv[:N]
            t, prim, u, v = (x.index_select(0, inv) for x in (t, prim, u, v))
        t, prim = t[:N], prim[:N]
        uv = torch.stack([u[:N], v[:N]])

    # analytic spheres: dense tail over the (few) sphere prims
    if scene.sphere_prims:
        with metrics.span("trace.spheres"):
            for pid, sid in scene.sphere_prims:
                centre = scene.shape_pos[sid]
                radius = scene.shape_param[sid, 0]
                ocx = centre[0] - o[0]
                ocy = centre[1] - o[1]
                ocz = centre[2] - o[2]
                oc2 = ocx * ocx + ocy * ocy + ocz * ocz
                dop = d[0] * ocx + d[1] * ocy + d[2] * ocz
                disc2 = oc2 - dop * dop
                a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
                b = -2.0 * dop
                cc = oc2 - radius * radius
                discr = torch.clamp(b * b - 4.0 * a * cc, min=0.0)
                ts = (-b - torch.sqrt(discr)) / (2.0 * torch.clamp(a, min=1e-12))
                hit = (disc2 < radius * radius) & (ts > 0.0) & (ts < t)
                if active is not None:
                    hit = hit & active  # the tail sees the raw rays of parked lanes
                t = torch.where(hit, ts, t)
                prim = torch.where(hit, pid, prim)
                uv = torch.where(hit[None, :], 0.0, uv)

    with metrics.span("trace.attr"):
        if tmax is not None or cap is not None:
            # the miss contract: lanes cut by their bound carry t == tmax and
            # capacity-cut lanes t == 0, both with prim == -1
            t = torch.where(prim < 0, C.INF, t)
        if not want_attr:
            return t, prim, uv
        attr = scene.prim_attr[:, prim.clamp(min=0).long()]
        attr = torch.where((prim >= 0)[None, :], attr, 0.0)
        return t, prim, uv, attr
