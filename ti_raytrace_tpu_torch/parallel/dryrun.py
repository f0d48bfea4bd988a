"""Multi-rank dry run of the five sharded render paths (counterpart of the
reference's `__graft_entry__.dryrun_multichip`).

    python -m ti_raytrace_tpu_torch.parallel.dryrun --ranks 2 [--device cpu]
        [--size 512] [--frames 16]

Starts `n` ranks once with torch.multiprocessing (spawn, as CUDA
requires), joined through a FileStore in a temporary directory; each rank
times one all_reduce of the image's size, renders every section on its
lane shard (on CUDA after an untimed warm-up run of it at 64^2) and
writes, per section, the image, the overflow, its launches of the cluster,
the dense and the rng kernel and its seconds to an .npz file there.  The
parent then renders the same sections shard after shard in one process
(the per-shard mirror) and holds each rank's image to it bit for bit.
Sections, each on the scene whose path it exercises:

  pt         render_frame_sharded with pt_rgb.trace_paths (cornell_box, its
             schedule and NEE), 1 frame;
  bdpt       render_bdpt_frame_sharded (veach_bdpt, MAX_DEPTH 5), 1 frame;
  pt_spec    render_frame_spec_sharded (sky_dome, its sky and schedule),
             1 frame;
  bdpt_spec  render_bdpt_spec_frame_sharded (prism_rainbow, its emitter
             scale, MAX_DEPTH 5), 1 frame;
  merged     render_film_frames_merged_sharded (benchmark_100k,
             BENCH_SCHEDULE_MERGED, `frames` frames in merged groups of
             min(frames, 16)), its LaneFilm gathered by lane_film_image.

Backend: NCCL when every rank has a card of its own, else gloo (2 ranks
on one card).  A non-zero rank exit, a timeout (the ranks are then
terminated), a missing file, an image that is black or not finite, or a
difference from the mirror raises.
"""

import argparse
import functools
import os
import tempfile
import time

import numpy as np
import torch

SECTIONS = ("pt", "bdpt", "pt_spec", "bdpt_spec", "merged")
_SCENES = {"pt": "cornell_box", "bdpt": "veach_bdpt", "pt_spec": "sky_dome",
           "bdpt_spec": "prism_rainbow", "merged": "benchmark_100k"}
SEED = 7
WARMUP_SIZE = 64  # film side of the untimed warm-up run of a section on CUDA
COLLECTIVE_REPS = 10  # timed all_reduce calls of the image's size per rank


def _setup(section, device, size):
    """(scene, cfg, spec, cam) of a section's scene on `device`."""
    from ti_raytrace_tpu_torch.examples.scenes import example_cached, make_camera

    scene, cfg = example_cached(_SCENES[section], device)
    spec, cam = make_camera(scene, cfg, size, size)
    return scene, cfg, spec, cam


def _group(cfg, frames):
    return min(frames, cfg.group or frames)


def _paths_fn(scene, cfg):
    """pt's planar path kernel: trace_paths with the scene's schedule and
    NEE by its materials."""
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    return functools.partial(pt_rgb.trace_paths, compaction=cfg.compaction,
                             nee=pt_rgb.has_nee_materials(scene))


def run_section(section, mesh, size: int, frames: int):
    """One section on this rank: ((W, H, 3) image, overflow as an int).
    Only the pt section returns no overflow of its own (0)."""
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import pt_spec
    from ti_raytrace_tpu_torch.parallel import shard

    scene, cfg, spec, cam = _setup(section, mesh.device, size)
    scene = shard.replicate_scene(scene, mesh)
    key = rng.PRNGKey(SEED)
    if section == "pt":
        return shard.render_frame_sharded(_paths_fn(scene, cfg), scene, spec, cam, 1, key,
                                          mesh), 0
    if section == "bdpt":
        return shard.render_bdpt_frame_sharded(scene, spec, cam, 1, key, mesh,
                                               return_overflow=True)
    if section == "pt_spec":
        sdata = pt_spec.make_spectral_data(**cfg.sky, device=mesh.device)
        return shard.render_frame_spec_sharded(scene, sdata, spec, cam, 1, key, mesh,
                                               compaction=cfg.compaction,
                                               return_overflow=True)
    if section == "bdpt_spec":
        return shard.render_bdpt_spec_frame_sharded(
            scene, spec, cam, 1, key, mesh, emitter_scale=cfg.sky["emitter_scale"],
            return_overflow=True)
    if section == "merged":
        from ti_raytrace_tpu_torch.integrators import pt_rgb

        fl = shard.new_lane_film(spec, mesh, seed=SEED)
        fl, ov = shard.render_film_frames_merged_sharded(
            scene, spec, cam, fl, frames, _group(cfg, frames), cfg.compaction,
            pt_rgb.has_nee_materials(scene), mesh)
        if fl.frame != frames:
            raise RuntimeError(f"merged: the film ended on frame {fl.frame}, not {frames}")
        return shard.lane_film_image(fl, spec, mesh), ov
    raise ValueError(f"unknown section {section!r} (sections: {SECTIONS})")


def mirror_section(section, n: int, device, size: int, frames: int):
    """The same section computed shard after shard in this process, with
    each rank's keys: ((W, H, 3) image, overflow as an int)."""
    from ti_raytrace_tpu_torch.core import rng
    from ti_raytrace_tpu_torch.integrators import bdpt_rgb, pt_rgb, pt_spec
    from ti_raytrace_tpu_torch.integrators.bdpt_spec import make_spec_ctx_fn
    from ti_raytrace_tpu_torch.parallel import shard

    dev = torch.device(device)
    scene, cfg, spec, cam = _setup(section, dev, size)
    meshes = [shard.Mesh(r, n, dev) for r in range(n)]
    N = size * size
    key = rng.PRNGKey(SEED)

    def cat_image(parts):
        return torch.cat(parts, dim=1).T.reshape(size, size, 3)

    if section == "merged":
        full, ov = torch.zeros((3, N), dtype=torch.float32, device=dev), 0
        for m in meshes:
            px, py = shard.shard_pixels(spec, m)
            hdr0 = torch.zeros((3, N // n), dtype=torch.float32, device=dev)
            hdr, frame, _, ov_r = shard._merged_lane_shard(
                scene, spec, cam, hdr0, 0, rng.PRNGKey(SEED), m.rank, px, py, frames,
                _group(cfg, frames), cfg.compaction, pt_rgb.has_nee_materials(scene))
            full[:, torch.as_tensor(shard.film_lanes(N, m), device=dev)] = hdr
            ov += int(ov_r)
        return shard.lane_film_image(shard.LaneFilm(full, frame, None), spec), ov
    if section in ("pt", "pt_spec"):
        k_cam, k_path = rng.split(key)
        o, d = shard._raster_rays(spec, cam, 1, k_cam)
        parts, ov = [], 0
        for m in meshes:
            sl = shard._lanes(N, m)
            k = rng.fold_in(k_path, m.rank)
            if section == "pt":
                parts.append(_paths_fn(scene, cfg)(scene, o[:, sl], d[:, sl], k))
                continue
            sdata = pt_spec.make_spectral_data(**cfg.sky, device=dev)
            rad, ov_r = pt_spec.trace_paths_spec(scene, sdata, o[:, sl].contiguous(),
                                                 d[:, sl].contiguous(), k,
                                                 compaction=cfg.compaction,
                                                 return_overflow=True)
            parts.append(rad)
            ov += int(ov_r)
        return cat_image(parts), ov
    spectral = section == "bdpt_spec"
    if spectral:
        k_cam, k_lam, *keys = rng.split(key, 5)
        ctx_fn = make_spec_ctx_fn(cfg.sky["emitter_scale"], device=dev)
    else:
        k_cam, *keys = rng.split(key, 4)
    o, d = bdpt_rgb._camera_rays(spec, cam, 1, k_cam)
    parts, splat, ov = [], None, 0
    for m in meshes:
        sl = shard._lanes(N, m)
        ctx = ctx_fn(rng.fold_in(k_lam, m.rank), N // n) if spectral else None
        rad, sp, ov_r = shard._bdpt_shard(scene, spec, cam, o[:, sl], d[:, sl], keys,
                                          m.rank, bdpt_rgb.MAX_DEPTH, spec_ctx=ctx)
        parts.append(rad)
        splat = sp if splat is None else splat + sp
        ov += int(ov_r)
    return cat_image(parts) + splat, ov


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _all_reduce_ms(mesh, n: int, reps: int = COLLECTIVE_REPS) -> float:
    """ms of one all_reduce of a (3, n) float32 buffer on the mesh, the
    size of every image gather and splat-film sum at n pixels (after one
    untimed call)."""
    from ti_raytrace_tpu_torch.parallel import shard

    x = torch.zeros((3, n), dtype=torch.float32, device=mesh.device)
    shard._all_reduce(x, mesh)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        shard._all_reduce(x, mesh)
    _sync(mesh.device)
    return (time.perf_counter() - t0) / reps * 1e3


def _rank_main(rank, n, out_dir, device, size, frames, sections, timeout, t_spawn):
    """One rank: join the group, render every section, write its files."""
    from ti_raytrace_tpu_torch.core.rng import UNIFORM_KERNEL
    from ti_raytrace_tpu_torch.ops.cluster_trace import KERNEL
    from ti_raytrace_tpu_torch.ops.dense_trace import DENSE_KERNEL
    from ti_raytrace_tpu_torch.parallel import shard

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * n)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = shard.init_mesh(rank, n, os.path.join(out_dir, "store"), device=device,
                           timeout=timeout)
    try:
        start_s = time.time() - t_spawn
        all_reduce_ms = _all_reduce_ms(mesh, size * size)
        for section in sections:
            if mesh.device.type == "cuda":
                # untimed, at a small size: the first call of many torch ops
                # on CUDA compiles its kernel (NVRTC), whatever the shape;
                # nothing is compiled at first call on the CPU
                run_section(section, mesh, WARMUP_SIZE, frames)
            shard._all_reduce(torch.zeros(1, device=mesh.device), mesh)  # start together
            KERNEL.reset_counts()
            DENSE_KERNEL.reset_counts()
            UNIFORM_KERNEL.reset_counts()
            t0 = time.perf_counter()
            img, ov = run_section(section, mesh, size, frames)
            _sync(mesh.device)
            seconds = time.perf_counter() - t0
            widths = sorted(KERNEL.launches_by_width)
            rng_widths = sorted(UNIFORM_KERNEL.launches_by_width)
            np.savez(os.path.join(out_dir, f"{section}_{rank}.npz"),
                     img=img.cpu().numpy(), overflow=ov, launches=KERNEL.launches,
                     dense_launches=DENSE_KERNEL.launches, rng_launches=UNIFORM_KERNEL.launches,
                     widths=np.asarray(widths, np.int64),
                     width_launches=np.asarray([KERNEL.launches_by_width[w] for w in widths],
                                               np.int64),
                     rng_widths=np.asarray(rng_widths, np.int64),
                     rng_width_launches=np.asarray(
                         [UNIFORM_KERNEL.launches_by_width[w] for w in rng_widths], np.int64),
                     seconds=seconds, start_s=start_s, all_reduce_ms=all_reduce_ms,
                     backend=torch.distributed.get_backend())
    finally:
        torch.distributed.destroy_process_group()


def _spawn(n, out_dir, device, size, frames, sections, timeout):
    """Start the n ranks, join them by a deadline; raise on a timeout (the
    ranks then terminated) or a non-zero exit."""
    ctx = torch.multiprocessing.get_context("spawn")
    t_spawn = time.time()
    procs = [ctx.Process(target=_rank_main, args=(r, n, out_dir, str(device), size, frames,
                                                  tuple(sections), timeout, t_spawn))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        if alive:
            raise TimeoutError(f"dryrun_multichip: ranks {alive} still running after "
                               f"{timeout:g} s")
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"dryrun_multichip: ranks exited non-zero (rank, code): {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()


def dryrun_multichip(n: int, device="cuda", size: int = 512, frames: int = 16,
                     sections=SECTIONS, timeout: float = 600.0):
    """Run `sections` on n spawned ranks and hold each to its per-shard
    mirror.  Returns {section: dict(img (W, H, 3) numpy, overflow, cluster
    kernel launches per rank and per rank by live width, dense kernel
    launches per rank, rng kernel launches per rank and per rank by
    elements drawn, seconds per rank,
    frames, mirror_seconds, backend)} plus "start_s": the ranks' seconds
    from spawn to a joined group, and "all_reduce_ms": each rank's ms for
    one all_reduce of a (3, size^2) float32 buffer, the collective that
    gathers an image and sums a splat film.  size * size must split into
    n shards."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: CUDA was asked for and is not available")
    out = {}
    with tempfile.TemporaryDirectory(prefix="tiray_dryrun_") as tmp:
        _spawn(n, tmp, device, size, frames, sections, timeout)
        files = {}
        for section in sections:
            for r in range(n):
                path = os.path.join(tmp, f"{section}_{r}.npz")
                if not os.path.exists(path):
                    raise RuntimeError(f"dryrun_multichip: rank {r} wrote no {section} result")
                with np.load(path) as z:
                    files[section, r] = {k: z[k] for k in z.files}
    for section in sections:
        rs = [files[section, r] for r in range(n)]
        img = rs[0]["img"]
        t0 = time.perf_counter()
        want, want_ov = mirror_section(section, n, device, size, frames)
        _sync(device)
        mirror_s = time.perf_counter() - t0
        want = want.cpu().numpy()
        if not (np.isfinite(img).all() and float(np.abs(img).max()) > 0.0):
            raise RuntimeError(f"dryrun_multichip: the {section} image is black or not finite")
        for r, f in enumerate(rs):
            if not np.array_equal(f["img"], want):
                diff = int((f["img"] != want).any(axis=-1).sum())
                raise RuntimeError(f"dryrun_multichip: rank {r}'s {section} image differs from "
                                   f"the per-shard mirror on {diff} pixels")
            if int(f["overflow"]) != want_ov:
                raise RuntimeError(f"dryrun_multichip: rank {r}'s {section} overflow "
                                   f"{int(f['overflow'])} != the mirror's {want_ov}")
        out[section] = dict(
            img=img, overflow=want_ov, launches=[int(f["launches"]) for f in rs],
            dense_launches=[int(f["dense_launches"]) for f in rs],
            rng_launches=[int(f["rng_launches"]) for f in rs],
            launches_by_width=[dict(zip(f["widths"].tolist(), f["width_launches"].tolist()))
                               for f in rs],
            rng_launches_by_width=[dict(zip(f["rng_widths"].tolist(),
                                            f["rng_width_launches"].tolist())) for f in rs],
            seconds=[float(f["seconds"]) for f in rs],
            frames=frames if section == "merged" else 1, mirror_seconds=mirror_s,
            backend=str(rs[0]["backend"]))
    for k in ("start_s", "all_reduce_ms"):
        out[k] = [float(files[sections[0], r][k]) for r in range(n)]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args(argv)
    res = dryrun_multichip(args.ranks, args.device, args.size, args.frames)
    print(f"ranks joined after {', '.join(f'{s:.2f}' for s in res.pop('start_s'))} s; "
          f"one all_reduce of the image {', '.join(f'{t:.3f}' for t in res.pop('all_reduce_ms'))}"
          " ms")
    for section, r in res.items():
        print(f"dryrun_multichip({args.ranks}): {section} ok ({r['backend']}), frame mean "
              f"{float(r['img'].mean()):.5f}, overflow {r['overflow']}, kernel launches "
              f"{r['launches']} (dense {r['dense_launches']}, rng {r['rng_launches']}), "
              f"{max(r['seconds']) / r['frames'] * 1e3:.3f} ms/frame on the ranks, "
              f"{r['mirror_seconds'] / r['frames'] * 1e3:.3f} ms/frame shard after shard in "
              f"one process")


if __name__ == "__main__":
    main()
