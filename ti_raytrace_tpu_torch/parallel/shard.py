"""Multi-device rendering: pixel-lane shards over torch.distributed (twin
of ti_raytrace_tpu/parallel/shard.py).

One process per rank.  Every rank builds the same scene from the same
host dict (deterministic) and holds it whole; the ray wavefront is cut
into `size` lane shards of equal width and rank r renders shard r (a
contiguous slice; the merged path's shards interleave, below).  Path
tracing needs no communication inside a frame; BDPT's light-tracing
splats land on arbitrary pixels, so each rank accumulates a full splat
film and the films are summed once per frame.

Collectives: only `all_reduce(SUM)` and `broadcast`, the two that gloo
runs on CUDA tensors, so one code path serves 2 ranks on one card (gloo;
NCCL refuses two ranks on one GPU) and one rank per card (NCCL).  A
lane-sharded result is gathered by writing the rank's lanes into a
zero-filled full buffer and summing the buffers: exact, adding zeros
changes no value.

Key discipline (the reference's): the frame key splits as in the
single-device renderer and rank r folds r into its path keys, so rank r
computes what `bdpt_rgb.render_frame_sliced` computes for slice r.  The
per-shard bodies (`_merged_lane_shard`, `_bdpt_shard`) are functions of
their own, so one process can run them shard after shard (the mirror the
tests and parallel/dryrun.py hold the sharded paths against).

Differences from the reference, by design: a `Mesh` is a rank of an
initialised process group, not a device array; the merged path's rank
takes every size-th block of 256 morton lanes (a whole kernel tile each,
`film_lanes`), not one contiguous slice: compaction capacity is a
fraction of the rank's lanes, and a contiguous half of the bench film
holds more of the teapot than the whole film does (its bench schedule cut
66,940 live paths in 16 frames on 2 ranks, on the H100), while
interleaved blocks give every rank the film's own occupancy; a
`LaneFilm` holds the rank's (3, N / size) lanes and `lane_film_image`
takes the mesh to gather them; the BDPT and spectral renders return
their overflow (walk compaction plus shadow-cap kills, or compaction
kills) summed over ranks with `return_overflow`, where the reference
drops it.
"""

import math
from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ti_raytrace_tpu_torch.core import rng


class Mesh(NamedTuple):
    """One rank's view of the render mesh: its index, the number of ranks,
    the device it renders on and the process group (None: the default)."""
    rank: int
    size: int
    device: torch.device
    group: object = None


def make_mesh(group=None, device="cuda") -> Mesh:
    """This process's Mesh over an initialised process group.  Rank r
    renders on cuda:{r % device_count}, or on the CPU when the caller asks
    for "cpu".  Raises when no process group is initialised, and when CUDA
    is asked for and absent (a rank never carries on on the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed process group is initialised "
                           "(init_mesh, or init_process_group under torchrun)")
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if torch.device(device).type == "cpu":
        return Mesh(rank, size, torch.device("cpu"), group)
    if not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: rank {rank} was asked for CUDA, which is not available")
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return Mesh(rank, size, dev, group)


def init_mesh(rank: int, size: int, store_path: str, device="cuda", backend=None,
              timeout: float = 300.0) -> Mesh:
    """Join a `size`-rank process group through a FileStore at store_path
    (no TCP port to collide) and return this rank's Mesh.  backend None:
    NCCL when the device is CUDA and every rank has a card of its own,
    else gloo (2 ranks on one card share it over gloo, CUDA tensors and
    all).  timeout: seconds any rendezvous or collective may wait."""
    cuda = torch.device(device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"init_mesh: rank {rank} was asked for CUDA, which is not available")
    if backend is None:
        backend = "nccl" if cuda and size <= torch.cuda.device_count() else "gloo"
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=timedelta(seconds=timeout))
    return make_mesh(device=device)


def replicate_scene(scene, mesh: Mesh):
    """The scene with every tensor on the rank's device."""
    import dataclasses

    return dataclasses.replace(scene, **{
        f.name: getattr(scene, f.name).to(mesh.device)
        for f in dataclasses.fields(scene) if isinstance(getattr(scene, f.name), torch.Tensor)})


def _lanes(n: int, mesh: Mesh) -> slice:
    """Rank r's contiguous slice of n lanes."""
    if n % mesh.size:
        raise ValueError(f"{n} lanes do not split into {mesh.size} equal shards")
    ns = n // mesh.size
    return slice(mesh.rank * ns, (mesh.rank + 1) * ns)


def film_lanes(n: int, mesh: Mesh) -> np.ndarray:
    """The merged path's lanes of rank r in a morton film of n lanes
    (int64, ascending): blocks of gcd(n / size, 256) consecutive lanes,
    block b going to rank b % size, so each rank's lanes are whole kernel
    tiles of neighbouring pixels spread over the film."""
    from ti_raytrace_tpu_torch.ops.cluster_trace import TILE

    sl = _lanes(n, mesh)
    blk = math.gcd(sl.stop - sl.start, TILE)
    return np.arange(n, dtype=np.int64).reshape(-1, mesh.size, blk)[:, mesh.rank].reshape(-1)


def _all_reduce(x, mesh: Mesh):
    """Sum x over the ranks, in place; returns x."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _gather_lanes(part, n: int, mesh: Mesh, lanes=None):
    """Every rank's (..., n / size) lanes -> the full (..., n) tensor on
    every rank: each writes its lanes (its contiguous slice, or `lanes`)
    into zeros, one all_reduce."""
    full = part.new_zeros(part.shape[:-1] + (n,))
    full[..., _lanes(n, mesh) if lanes is None else lanes] = part
    return _all_reduce(full, mesh)


def _sum_overflow(ov, mesh: Mesh) -> int:
    """A rank's overflow count summed over the ranks, as an int."""
    total = torch.as_tensor(ov, dtype=torch.int64, device=mesh.device).reshape(1).clone()
    return int(_all_reduce(total, mesh)[0])


def _image(spec, radiance):
    """Raster-order (3, N) radiance -> (W, H, 3)."""
    return radiance.T.reshape(spec.width, spec.height, 3)


def _raster_rays(spec, cam, frame, k_cam):
    """The whole film's raster-order planar camera rays (3, N)."""
    from ti_raytrace_tpu_torch.camera import ray_directions, ray_origins

    return ray_origins(spec, cam).T, ray_directions(spec, cam, frame, k_cam).T


def render_frame_sharded(render_paths_fn, scene, spec, cam, frame: int, key, mesh: Mesh):
    """One progressive frame over the mesh: (W, H, 3) radiance on every
    rank.  render_paths_fn(scene, o, d, key) -> (3, n) radiance is a
    planar path kernel (e.g. pt_rgb.trace_paths); rank r runs it on lanes
    [r n, (r + 1) n) of the raster camera wavefront with the path key
    fold_in(k_path, r)."""
    k_cam, k_path = rng.split(key)
    o, d = _raster_rays(spec, cam, frame, k_cam)
    sl = _lanes(o.shape[1], mesh)
    rad = render_paths_fn(scene, o[:, sl], d[:, sl], rng.fold_in(k_path, mesh.rank))
    return _image(spec, _gather_lanes(rad, o.shape[1], mesh))


def render_frame_spec_sharded(scene, sdata, spec, cam, frame: int, key, mesh: Mesh,
                              compaction=None, max_depth=None,
                              return_overflow: bool = False):
    """One hero-wavelength spectral PT frame over the mesh
    (pt_spec.trace_paths_spec per lane shard, the discipline of
    render_frame_sharded).  With return_overflow: (image, compaction kills
    summed over the ranks, an int)."""
    from ti_raytrace_tpu_torch.integrators.pt_spec import trace_paths_spec

    k_cam, k_path = rng.split(key)
    o, d = _raster_rays(spec, cam, frame, k_cam)
    sl = _lanes(o.shape[1], mesh)
    kw = {} if max_depth is None else {"max_depth": max_depth}
    rad, ov = trace_paths_spec(scene, sdata, o[:, sl].contiguous(), d[:, sl].contiguous(),
                               rng.fold_in(k_path, mesh.rank), compaction=compaction,
                               return_overflow=True, **kw)
    img = _image(spec, _gather_lanes(rad, o.shape[1], mesh))
    return (img, _sum_overflow(ov, mesh)) if return_overflow else img


def _bdpt_shard(scene, spec, cam, o, d, keys, shard: int, max_depth: int, strategies=None,
                spec_ctx=None):
    """One shard of a BDPT frame: the eye walk from its rays, a light walk
    as wide, every (e, l) connection.  keys: (k_eye, k_light, k_conn),
    each folded with the shard index.  Returns ((3, n) radiance — linear
    sRGB also under spec_ctx — the shard's (W, H, 3) splat film, its
    overflow as a device scalar)."""
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    k_eye, k_light, k_conn = (rng.fold_in(k, shard) for k in keys)
    eye, eye_count, ov_e = bdpt_rgb.build_eye_path_rays(
        scene, o, d, k_eye, eye_depth=max_depth + 2, spec_ctx=spec_ctx)
    light, light_count, ov_l = bdpt_rgb.build_light_path(
        scene, o.shape[1], k_light, light_depth=max_depth + 1, spec_ctx=spec_ctx)
    radiance, splat, kills = bdpt_rgb._connections(
        scene, spec, cam, eye, eye_count, light, light_count, k_conn, max_depth=max_depth,
        spec_ctx=spec_ctx, strategies=strategies)
    if spec_ctx is not None:
        radiance = spec_ctx.to_rgb(radiance)
    return radiance, splat, ov_e + ov_l + kills


def _bdpt_frame(scene, spec, cam, o, d, keys, mesh, max_depth, strategies, spec_ctx_fn,
                k_lam, return_overflow):
    """The collective half of both BDPT paths: rank r's shard, its lanes
    gathered, the splat films summed (the renderer's only cross-pixel
    reduction), the overflow summed."""
    n = o.shape[1]
    sl = _lanes(n, mesh)
    ctx = None if spec_ctx_fn is None else spec_ctx_fn(rng.fold_in(k_lam, mesh.rank),
                                                       sl.stop - sl.start)
    rad, splat, ov = _bdpt_shard(scene, spec, cam, o[:, sl], d[:, sl], keys, mesh.rank,
                                 max_depth, strategies, ctx)
    img = _image(spec, _gather_lanes(rad, n, mesh)) + _all_reduce(splat.contiguous(), mesh)
    return (img, _sum_overflow(ov, mesh)) if return_overflow else img


def render_bdpt_frame_sharded(scene, spec, cam, frame: int, key, mesh: Mesh,
                              strategies=None, max_depth=None,
                              return_overflow: bool = False):
    """One progressive BDPT frame over the mesh: each rank walks the eye
    subpaths of its lanes and as many light subpaths, connects every
    (e, l) strategy locally and splats into a full film; the films are
    summed across the ranks.  Keys: split(key, 4) -> (camera, eye, light,
    connection), the last three folded with the rank: with size ==
    n_slices this is bdpt_rgb.render_frame_sliced, slice by slice.
    strategies: optional host predicate f(e, l) -> bool.  With
    return_overflow: (image, walk overflow + shadow-cap kills over every
    rank, an int)."""
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb

    max_depth = bdpt_rgb.MAX_DEPTH if max_depth is None else max_depth
    k_cam, k_eye, k_light, k_conn = rng.split(key, 4)
    o, d = bdpt_rgb._camera_rays(spec, cam, frame, k_cam)
    return _bdpt_frame(scene, spec, cam, o, d, (k_eye, k_light, k_conn), mesh, max_depth,
                       strategies, None, None, return_overflow)


def render_bdpt_spec_frame_sharded(scene, spec, cam, frame: int, key, mesh: Mesh,
                                   emitter_scale: float = 1.0, strategies=None,
                                   max_depth=None, return_overflow: bool = False):
    """One single-wavelength spectral BDPT frame over the mesh: as
    render_bdpt_frame_sharded, with keys split(key, 5) -> (camera,
    wavelength, eye, light, connection) and rank r's wavelengths drawn
    from fold_in(k_lam, r); each rank converts its radiance and splats to
    sRGB per lane before the sums."""
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb
    from ti_raytrace_tpu_torch.integrators.bdpt_spec import make_spec_ctx_fn

    max_depth = bdpt_rgb.MAX_DEPTH if max_depth is None else max_depth
    k_cam, k_lam, k_eye, k_light, k_conn = rng.split(key, 5)
    o, d = bdpt_rgb._camera_rays(spec, cam, frame, k_cam)
    return _bdpt_frame(scene, spec, cam, o, d, (k_eye, k_light, k_conn), mesh, max_depth,
                       strategies, make_spec_ctx_fn(emitter_scale, device=mesh.device), k_lam,
                       return_overflow)


class LaneFilm(NamedTuple):
    """Progressive film in morton LANE space on one rank: hdr (3, N /
    size) is the running mean of the rank's lanes (`film_lanes`) of the
    static morton pixel order (pt_rgb's camera order); frame and key
    advance identically on every rank.  `lane_film_image` gathers and
    unpermutes it, once per save or display."""
    hdr: torch.Tensor  # (3, N / size) running-mean radiance, lane order
    frame: int         # frames accumulated so far
    key: torch.Tensor  # (2,) int64 key for the next frame (host)


def new_lane_film(spec, mesh: Mesh, seed: int = 0) -> LaneFilm:
    n = spec.width * spec.height
    return LaneFilm(hdr=torch.zeros((3, n // mesh.size), dtype=torch.float32,
                                    device=mesh.device),
                    frame=0, key=rng.PRNGKey(seed))


def lane_film_image(fl: LaneFilm, spec, mesh: Mesh = None) -> torch.Tensor:
    """Lane-space film -> (W, H, 3) raster image on every rank.  mesh: the
    film's mesh (hdr holds the rank's `film_lanes`; one all_reduce
    gathers them); None when hdr holds all N lanes."""
    from ti_raytrace_tpu_torch.camera import morton_pixel_order

    n = spec.width * spec.height
    hdr = fl.hdr if mesh is None else _gather_lanes(
        fl.hdr, n, mesh, torch.as_tensor(film_lanes(n, mesh), device=fl.hdr.device))
    _, inv = morton_pixel_order(spec.width, spec.height)
    return _image(spec, hdr.index_select(1, torch.as_tensor(inv, dtype=torch.int64,
                                                               device=hdr.device)))


def _merged_lane_shard(scene, spec, cam, hdr, frame0: int, key0, shard_idx: int, px, py,
                       n_frames: int, group: int, compaction, nee: bool, max_depth=None):
    """One rank's share of a merged multi-frame render: the pixels (px,
    py) of each of n_frames frames in merged groups (pt_rgb._render_group
    on them, its camera bounce in the shared-origin mode: whole morton
    tiles are as coherent as the whole film's), accumulated into the (3,
    n) hdr.  The film's key chain is
    rank-independent (frame and key advance as in
    pt_rgb.render_film_frames_merged); each group renders from
    fold_in(film key, shard_idx).  Returns (hdr, frame, key, overflow as
    a device scalar)."""
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.camera import ray_directions_from_pixels
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    ns = px.shape[0]

    def gen_rays(frame, k_cam):
        o = cam.eye[:, None].expand(3, ns)
        return o, ray_directions_from_pixels(spec, cam, frame, k_cam, px, py)

    fl = film_mod.Film(hdr=hdr, frame=frame0, key=key0)
    overflow = torch.zeros((), dtype=torch.int64, device=hdr.device)
    for _ in range(n_frames // group):
        rad_sum, ov = pt_rgb._render_group(
            scene, spec, cam, fl.frame, rng.fold_in(fl.key, shard_idx), group,
            tuple(compaction), nee,
            max_depth=pt_rgb.MAX_DEPTH if max_depth is None else max_depth,
            gen_rays=gen_rays, lane_space=True, n_lanes=ns)
        fl = film_mod.accumulate_group(fl, rad_sum, group)  # the running-mean algebra
        overflow = overflow + ov
    return fl.hdr, fl.frame, fl.key, overflow


def shard_pixels(spec, mesh: Mesh):
    """(px, py) float32 pixel coordinates of the rank's lanes
    (`film_lanes`) of the static morton pixel order, on its device."""
    from ti_raytrace_tpu_torch.camera import morton_pixel_order

    perm, _ = morton_pixel_order(spec.width, spec.height)
    pix = perm[film_lanes(perm.size, mesh)]
    return (torch.as_tensor((pix // spec.height).astype(np.float32), device=mesh.device),
            torch.as_tensor((pix % spec.height).astype(np.float32), device=mesh.device))


def render_film_frames_merged_sharded(scene, spec, cam, fl: LaneFilm, n_frames: int,
                                      group: int, compaction, nee: bool, mesh: Mesh,
                                      max_depth=None):
    """The production path (pt_rgb.render_film_frames_merged: merged
    groups, compaction, morton camera) over the mesh: each rank renders
    its lanes (`film_lanes`) of every frame; compaction runs on the
    rank's lanes, its capacity pooled over the group's frames as on one
    device.  No collective inside the loop; the overflow is summed
    once at the end.  Takes no pay_divisors (as the reference).  Returns
    (LaneFilm', overflow kills over every rank, an int)."""
    if not compaction:
        raise ValueError("merged rendering requires a compaction schedule")
    if n_frames % group:
        raise ValueError(f"n_frames {n_frames} is not a multiple of group {group}")
    px, py = shard_pixels(spec, mesh)
    hdr, frame, key, ov = _merged_lane_shard(scene, spec, cam, fl.hdr, fl.frame, fl.key,
                                             mesh.rank, px, py, n_frames, group, compaction,
                                             nee, max_depth=max_depth)
    return LaneFilm(hdr=hdr, frame=frame, key=key), _sum_overflow(ov, mesh)
