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
minimal t, then the lowest triangle slot.

`cluster_trace` dispatches on the tensors' device: CPU tensors take
`cluster_trace_plain`, CUDA tensors take the kernel in
csrc/cluster_trace.cu (built at first use) — no fallback between them.
The kernel returns (t, prim, u, v) per lane; the winner's attributes are
then gathered from prim_attr by prim id (exact, replacing the reference's
in-kernel one-hot matmul), and the analytic spheres are traced densely.

Sorted mode (`sort_rays=True`, the un-presorted deep bounces and NEE
shadow rays): the lanes are stable-sorted by their coherence key
(`_coherence_order`), gathered into planar sorted order, traced with a
per-tile order from the sorted tiles' mean origins, and the hit record is
gathered back through the inverse permutation.  The reference's
row-record ray layout was a TPU BlockSpec artefact; the kernel takes the
same planar operands in every mode.

Not ported (each raises NotImplementedError): per-lane `tmax` bounds and
`active`/`cap_frac` packing, which only BDPT shadow batches use (ROADMAP
'to port': BDPT RGB).  The reference's tuning flags (TSKIP, NSUB, MT_MXU,
ATTR_*, DEFER_ATTR, BF16_SLAB, TILE_WIDE*, ...) are measured-loss or
diagnostic paths of the TPU kernel and stay there.
"""

import ctypes

import torch

from ti_raytrace_tpu_torch.core import constants as C

TILE = 256       # rays per tile (one CUDA block)
GROUP = 32       # clusters per supercluster of the front-to-back order
CLUSTER_B = 128  # triangles per cluster (accel/clusters.CLUSTER_B)
SMALL_WAVEFRONT = 32768  # the reference skips its sort below this width

PAD_KEY = 1 << 62  # coherence key of padding lanes: after every 60-bit key

_UNPORTED = ("outside the ported slice (ROADMAP 'to port': BDPT RGB, with "
             "the cluster kernel's tmax and active modes)")


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


def coherence_key60(scene, o, d):
    """The two coherence keys as one int64 (origin morton << 30 |
    direction morton): ascending order of it is the reference's two-key
    (origin, direction) lexicographic order."""
    key_o, key_d = _coherence_key(scene, o, d)
    return (key_o << 30) | key_d


def _coherence_order(scene, o, d, n_pad: int):
    """Stable lane order (n_pad,) int64 of the wavefront by coherence_key60.
    Padding lanes take PAD_KEY and sort after every lane; lanes parked at
    1e9 clamp to the top origin cell, after every live lane inside the
    scene box."""
    key = torch.nn.functional.pad(coherence_key60(scene, o, d), (0, n_pad - o.shape[1]),
                                  value=PAD_KEY)
    return torch.sort(key, stable=True).indices


def _super_boxes(cb, n_clusters):
    """Bounds (S, 3) of the superclusters: GROUP consecutive clusters,
    spatially adjacent by median-split construction."""
    S = n_clusters // GROUP
    bmin = cb[0:3, :n_clusters].T.reshape(S, GROUP, 3).amin(dim=1)
    bmax = cb[3:6, :n_clusters].T.reshape(S, GROUP, 3).amax(dim=1)
    return bmin, bmax


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


def cluster_trace_plain(o, d, n_valid: int, bounds, order, tri, origin_mt: bool):
    """The kernel's computation in plain PyTorch, vectorised over
    (tiles, TILE rays, CLUSTER_B triangles) and looped over sweep
    positions k: tile i tests cluster order[i, k].  Same inputs and
    outputs as the kernel (see csrc/cluster_trace.cu): returns t (n_pad,),
    prim int32 (n_pad,), u, v (n_pad,) and visited int32 (n_tiles,)."""
    n_pad = o.shape[1]
    T = n_pad // TILE
    nc = bounds.shape[1]
    dev = o.device

    def lanes(x):
        return x.reshape(T, TILE, 1)

    ox, oy, oz = (lanes(o[k]) for k in range(3))
    dx, dy, dz = (lanes(d[k]) for k in range(3))
    ix, iy, iz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    live = lanes(torch.arange(n_pad, device=dev) < n_valid)
    order = order.expand(T, nc).long()
    blocks = tri.reshape(tri.shape[0], nc, CLUSTER_B)

    best_t = torch.full((T, TILE, 1), C.INF, dtype=torch.float32, device=dev)
    best_p = torch.full((T, TILE, 1), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((T, TILE, 1), dtype=torch.float32, device=dev)
    best_v = torch.zeros((T, TILE, 1), dtype=torch.float32, device=dev)
    visited = torch.zeros(T, dtype=torch.int32, device=dev)
    slot = torch.arange(CLUSTER_B, device=dev)

    for k in range(nc):
        cid = order[:, k]
        b = bounds[:, cid].reshape(8, T, 1, 1)
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
        cand = live & (torch.clamp(tn, min=0.0) <= tf) & (b[6] > 0.0) & (tn < best_t)
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


class _ClusterTraceKernel:
    """ctypes binding of csrc/cluster_trace.cu.  `launches` counts kernel
    launches (the wrapper adds one per launch and nowhere else)."""

    def __init__(self):
        self.launches = 0
        self.build_info = None
        self._lib = None

    def library(self):
        if self._lib is None:
            from ti_raytrace_tpu_torch.ops import cuda_build

            lib, self.build_info = cuda_build.load("cluster_trace.cu")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.cluster_trace_launch.argtypes = [p, p, i, i, p, i, p, i, p, i,
                                                 p, p, p, p, p, p]
            lib.cluster_trace_launch.restype = ctypes.c_int
            lib.cluster_trace_error_string.argtypes = [ctypes.c_int]
            lib.cluster_trace_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, o, d, n_valid: int, bounds, order, tri, origin_mt: bool):
        n_pad = o.shape[1]
        nc = bounds.shape[1]
        n_tiles = n_pad // TILE
        dev = o.device
        for name, x, dt in (("o", o, torch.float32), ("d", d, torch.float32),
                            ("bounds", bounds, torch.float32),
                            ("order", order, torch.int32), ("tri", tri, torch.float32)):
            if x.device != dev or x.dtype != dt or not x.is_contiguous():
                raise ValueError(f"cluster_trace: {name} must be a contiguous {dt} "
                                 f"tensor on {dev}, got {x.dtype} on {x.device}")
        if (o.shape != (3, n_pad) or d.shape != (3, n_pad) or n_pad % TILE
                or bounds.shape[0] != 8 or nc % GROUP
                or order.shape not in ((1, nc), (n_tiles, nc))
                or tri.shape != (12, nc * CLUSTER_B) or not 0 <= n_valid <= n_pad):
            raise ValueError(
                f"cluster_trace: bad shapes o {tuple(o.shape)} d {tuple(d.shape)} "
                f"bounds {tuple(bounds.shape)} order {tuple(order.shape)} "
                f"tri {tuple(tri.shape)} n_valid {n_valid}")
        t = torch.empty(n_pad, dtype=torch.float32, device=dev)
        prim = torch.empty(n_pad, dtype=torch.int32, device=dev)
        u = torch.empty(n_pad, dtype=torch.float32, device=dev)
        v = torch.empty(n_pad, dtype=torch.float32, device=dev)
        visited = torch.empty(n_tiles, dtype=torch.int32, device=dev)
        if n_tiles == 0:
            return t, prim, u, v, visited
        lib = self.library()
        with torch.cuda.device(dev):
            err = lib.cluster_trace_launch(
                o.data_ptr(), d.data_ptr(), n_pad, n_valid, bounds.data_ptr(), nc,
                order.data_ptr(), int(order.shape[0] > 1), tri.data_ptr(),
                int(origin_mt), t.data_ptr(), prim.data_ptr(), u.data_ptr(),
                v.data_ptr(), visited.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        if err != 0:
            raise RuntimeError("cluster_trace kernel launch failed: "
                               + lib.cluster_trace_error_string(err).decode())
        self.launches += 1
        return t, prim, u, v, visited


KERNEL = _ClusterTraceKernel()


def cluster_trace(o, d, n_valid: int, bounds, order, tri, origin_mt: bool):
    """Closest hits of the padded planar wavefront (3, n_pad): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if o.device.type == "cuda":
        return KERNEL(o, d, n_valid, bounds, order, tri, origin_mt)
    if o.device.type == "cpu":
        return cluster_trace_plain(o, d, n_valid, bounds, order, tri, origin_mt)
    raise NotImplementedError(f"cluster_trace: no implementation for {o.device}")


# ----------------------------------------------------------------- tracer

def kernel_inputs(scene, o, d, sort_rays: bool, shared_origin=None, tile_order: bool = False):
    """The kernel's operands for the planar wavefront o, d (3, N):
    ((o, d, n_valid, bounds, order, tri, origin_mt), perm), padded to whole
    tiles.  sort_rays: the lanes go in coherence order and perm is that
    lane order (n_pad,), else None.  The cluster order is the shared
    origin's, per tile (sorted or tile_order), or the static one."""
    N = o.shape[1]
    n_pad = -(-N // TILE) * TILE
    o_p = torch.nn.functional.pad(o, (0, n_pad - N))
    d_p = torch.nn.functional.pad(d, (0, n_pad - N))
    perm = None
    if sort_rays:
        perm = _coherence_order(scene, o, d, n_pad)
        od = torch.cat([o_p, d_p]).index_select(1, perm)
        o_p, d_p = od[0:3], od[3:6]
    o_p, d_p = o_p.contiguous(), d_p.contiguous()
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
        cent = o_p.reshape(3, n_pad // TILE, TILE).mean(dim=2).T
        order = _tile_order_from_cent(cent, cb, nc)
    else:
        order = _static_order(cb, nc)
    return (o_p, d_p, N, cb, order, tri, origin_mt), perm


def trace_clustered(scene, o, d, sort_rays: bool = True, want_attr: bool = False,
                    sort_small: bool = False, shared_origin=None,
                    tile_order: bool = False, tmax=None, active=None, cap_frac=None):
    """Closest hit via the cluster kernel + dense analytic-sphere tail.

    o, d: planar (3, N).  Returns (t, prim, uv (2, N)) or, with want_attr,
    (t, prim, uv, attr (PRIM_A, N)); misses have t = INF, prim = -1 and
    zero attributes.  sort_rays: coherence-sort the lanes around the
    trace (skipped below SMALL_WAVEFRONT lanes unless sort_small);
    otherwise the wavefront must arrive coherent (a static morton camera
    wavefront with shared_origin, or a presorted carry with tile_order)."""
    if tmax is not None or active is not None or cap_frac is not None:
        raise NotImplementedError(f"tmax / active / cap_frac: {_UNPORTED}")
    N = o.shape[1]
    if N <= SMALL_WAVEFRONT and not sort_small:
        sort_rays = False
    args, perm = kernel_inputs(scene, o, d, sort_rays, shared_origin, tile_order)
    t, prim, u, v, _ = cluster_trace(*args)
    if perm is not None:
        # live lanes sort before padding, so lanes [0, N) hold every hit;
        # gather them back to caller order through the inverse permutation
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=perm.device)
        inv = inv[:N]
        t, prim, u, v = (x.index_select(0, inv) for x in (t, prim, u, v))
    t, prim = t[:N], prim[:N]
    uv = torch.stack([u[:N], v[:N]])

    # analytic spheres: dense tail over the (few) sphere prims
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
        t = torch.where(hit, ts, t)
        prim = torch.where(hit, pid, prim)
        uv = torch.where(hit[None, :], 0.0, uv)

    if not want_attr:
        return t, prim, uv
    attr = scene.prim_attr[:, prim.clamp(min=0).long()]
    attr = torch.where((prim >= 0)[None, :], attr, 0.0)
    return t, prim, uv, attr
