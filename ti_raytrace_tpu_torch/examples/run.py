"""CLI render harness for the ported scenes:

    python -m ti_raytrace_tpu_torch.examples.run benchmark_100k \
        --size 512 --frames 128 --group 16 --device cuda --out /tmp/r.png
    python -m ti_raytrace_tpu_torch.examples.run veach_bdpt \
        --size 512 --frames 32 --device cuda --out /tmp/veach-bdpt.png
    python -m ti_raytrace_tpu_torch.examples.run veach_bdpt --integrator pt_rgb \
        --size 512 --frames 64 --device cuda --out /tmp/veach.png
    python -m ti_raytrace_tpu_torch.examples.run spectral_box \
        --size 512 --frames 64 --device cuda --checkpoint /tmp/box.npz
    python -m ti_raytrace_tpu_torch.examples.run prism_rainbow \
        --size 512 --frames 64 --device cuda --out /tmp/prism.png

Scenes: cornell_box, single_model, sky_dome, spectral_box, veach_bdpt,
prism_rainbow, benchmark_100k.  Progressive rendering, 1 spp per frame, with the scene's
own integrator unless --integrator overrides it.  The path tracer
(`pt_rgb`): scenes with a merged group and a compaction schedule (the
benchmark, single_model) render in merged groups; the others render
`batch` frames per call of `render_film_frames` (the scene's batch, or
8), on the exact path when they have no schedule; NEE is on when the
scene has a material that takes it (`has_nee_materials`).  The spectral
path tracer (`pt_spec`): `batch` frames per call of
`render_film_frames_spec` with the scene's sky and emitter scale.  BDPT
(`bdpt_rgb`): every frame is `render_frame_sliced` in 2 slices with the
scene's walk compaction and shadow cap, accumulated into the film,
`batch` frames per call (the scene's batch, or 4).  Spectral BDPT
(`bdpt_spec`): every frame unsliced (`bdpt_spec.make_render_frame`) with
the scene's emitter scale, walk compaction and shadow cap, `batch` frames
per call as for BDPT; a scene built without the spectral pack rows renders
black under it, as in the reference (its emitters carry no power there).
`debug`: the albedo AOV, one frame per call.  A call never crosses a multiple of
--snapshot-every frames: there the PNG is written, and with --checkpoint
the film too (an existing checkpoint is resumed: same frame count, same
key chain).  A merged call that would be no whole number of groups (a
tail, a snapshot boundary) takes the plain batched path.  The first call
is a warm-up (it includes the kernel build on a fresh checkout); ms/frame
is timed over the remaining calls, each ending in a device synchronize,
and `metrics.RenderMeter` meters every call the same way (its first
call is its warm-up).  Prints one JSON line with ms/frame, the meter's
report (fps, spp_per_s, avg_frame_ms, compile_s) and the
overflow count (compaction
kills for the path tracers, the walk compaction overflow plus capped
shadow lanes for BDPT; non-zero means live paths were cut: a bias).
`--preview` opens a pygame window (examples/preview.py) and renders one
frame per call, showing the film and frame/total and fps after each; an
orbit move restarts the accumulation, q or ESC ends the run.  It needs
pygame and a display: without pygame it raises pygame's ImportError.
"""

import argparse
import functools
import json
import time

import numpy as np
import torch

from ti_raytrace_tpu_torch import film as film_mod
from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.examples.preview import OrbitRig, PygamePreview
from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, framing_params, make_camera
from ti_raytrace_tpu_torch.integrators import bdpt_rgb, bdpt_spec, debug, pt_rgb, pt_spec

INTEGRATORS = ("pt_rgb", "pt_spec", "bdpt_rgb", "bdpt_spec", "debug")
BDPT = ("bdpt_rgb", "bdpt_spec")


def spectral_data(cfg, integrator: str, device):
    """What a spectral integrator closes over, on `device`, from the scene
    config: the SpectralData of the spectral path tracer, the frame
    renderer of the spectral BDPT (its sensor and D65 tables with the
    config's emitter scale, walk compaction and shadow cap); None for any
    other integrator."""
    if integrator == "pt_spec":
        return pt_spec.make_spectral_data(**cfg.sky, device=device)
    if integrator == "bdpt_spec":
        return bdpt_spec.make_render_frame(
            **cfg.sky, walk_compaction=cfg.bdpt_walk_compaction,
            shadow_cap=cfg.bdpt_shadow_cap, device=device)
    return None


_SPECTRAL = {}  # the spectral_data of each setting and device, built at first use


def _spectral_data_cached(cfg, integrator: str, device):
    """spectral_data(cfg, integrator, device), built once for each value of
    what it reads (the integrator, the config's sky, walk compaction and
    shadow cap) and device, then reused."""
    key = (integrator, tuple(sorted(cfg.sky.items())), cfg.bdpt_walk_compaction,
           cfg.bdpt_shadow_cap, device)
    if key not in _SPECTRAL:
        _SPECTRAL[key] = spectral_data(cfg, integrator, device)
    return _SPECTRAL[key]


def get_integrator(name: str, cfg_sky=None, compaction=None, scene=None, cfg=None):
    """A render_frame(scene, spec, cam, frame, key) -> (W, H, 3) of one
    progressive frame by integrator `name`, as the CLI configures it: the
    path tracer with `compaction` and NEE by the scene's materials (on
    when no scene is given), the spectral path tracer with the sky
    parameters `cfg_sky`, BDPT in 2 slices and the spectral BDPT with the
    config's walk compaction and shadow cap; the spectral tables on the
    scene's device (the card when no scene is given)."""
    device = scene.device if scene is not None else "cuda"
    if name == "pt_rgb":
        nee = pt_rgb.has_nee_materials(scene) if scene is not None else True
        return functools.partial(pt_rgb.render_frame, compaction=compaction, nee=nee)
    if name == "debug":
        return debug.render_frame
    if name == "pt_spec":
        return pt_spec.make_render_frame(**(cfg_sky or {}), compaction=compaction,
                                         device=device)
    bdpt = dict(walk_compaction=cfg.bdpt_walk_compaction if cfg else None,
                shadow_cap=cfg.bdpt_shadow_cap if cfg else None)
    if name == "bdpt_rgb":
        return functools.partial(bdpt_rgb.render_frame_sliced, n_slices=2, **bdpt)
    if name == "bdpt_spec":
        return bdpt_spec.make_render_frame(**(cfg_sky or {}), **bdpt, device=device)
    raise ValueError(f"unknown integrator {name!r} (integrators: {', '.join(INTEGRATORS)})")


def render_batch(scene, cfg, spec, cam, fl, n: int, integrator: str, group: int = 0,
                 sdata=None):
    """n frames into the film by `integrator` with the scene config's
    schedule: BDPT in 2 slices with the config's walk compaction and
    shadow cap; the spectral BDPT unsliced and the spectral path tracer
    with `sdata` (`spectral_data` of that integrator; without it, that of
    the scene config, built on the scene's device at the first such call
    and reused by later ones); the albedo AOV for
    `debug`; pt_rgb (NEE by `has_nee_materials`) in merged groups of
    `group` where the scene has a schedule, group > 1 and n is a whole
    number of groups, else frame after frame.  The call is the render path's
    root span, `render.call` (metrics.call_span).  Returns (film', overflow)."""
    with metrics.call_span("render.call", fl.hdr.device, integrator=integrator, frames=n):
        if integrator == "bdpt_rgb":
            return bdpt_rgb.render_film_frames(
                scene, spec, cam, fl, n_frames=n, n_slices=2,
                walk_compaction=cfg.bdpt_walk_compaction, shadow_cap=cfg.bdpt_shadow_cap)
        if integrator in ("bdpt_spec", "pt_spec") and sdata is None:
            sdata = _spectral_data_cached(cfg, integrator, scene.device)
        if integrator == "bdpt_spec":
            return bdpt_spec.render_film_frames(scene, spec, cam, fl, sdata, n_frames=n)
        if integrator == "pt_spec":
            return pt_spec.render_film_frames_spec(scene, sdata, spec, cam, fl, n_frames=n,
                                                   compaction=cfg.compaction)
        if integrator == "debug":
            for _ in range(n):
                fl = film_mod.accumulate(fl, debug.render_frame(scene, spec, cam, fl.frame,
                                                                fl.key))
            return fl, 0
        nee = pt_rgb.has_nee_materials(scene)
        if cfg.compaction and group > 1 and n % group == 0:
            return pt_rgb.render_film_frames_merged(
                scene, spec, cam, fl, n_frames=n, group=group, compaction=cfg.compaction,
                nee=nee, pay_divisors=cfg.pay_divisors)
        return pt_rgb.render_film_frames(scene, spec, cam, fl, n_frames=n,
                                         compaction=cfg.compaction, nee=nee)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("example")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--integrator", default=None, help="override the scene's integrator")
    ap.add_argument("--group", type=int, default=None,
                    help="frames per merged group (default: the scene's)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--snapshot-every", type=int, default=64,
                    help="write the PNG (and the checkpoint) every so many frames")
    ap.add_argument("--checkpoint", default=None, help="save/resume .npz path")
    ap.add_argument("--preview", action="store_true",
                    help="live window with orbit controls (needs pygame and a display); "
                         "moving the camera restarts the accumulation")
    args = ap.parse_args(argv)
    if args.snapshot_every < 1:
        raise ValueError(f"--snapshot-every {args.snapshot_every} is not a positive count")
    if args.example not in EXAMPLES:
        raise ValueError(f"unknown scene {args.example!r} (scenes: {sorted(EXAMPLES)})")

    device = torch.device(args.device)
    scene, cfg = EXAMPLES[args.example](device)
    integrator = args.integrator or cfg.integrator
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r} (integrators: "
                         f"{', '.join(INTEGRATORS)})")
    spec, cam = make_camera(scene, cfg, args.size, args.size)
    pt = integrator == "pt_rgb"
    nee = pt_rgb.has_nee_materials(scene) if pt else None
    group = args.group or cfg.group or 0
    merged = pt and bool(cfg.compaction) and group > 1 and not args.preview
    if merged:
        batch = group
    elif args.preview or integrator == "debug":
        batch = 1
    else:
        batch = cfg.batch or (4 if integrator in BDPT else 8)

    fl = film_mod.new_film(args.size, args.size, seed=args.seed, device=device)
    if args.checkpoint:
        try:
            fl = film_mod.load_checkpoint(args.checkpoint, device=device)
            print(f"resumed at frame {fl.frame}", flush=True)
        except FileNotFoundError:
            pass
    preview = None
    if args.preview:
        rig = OrbitRig(*framing_params(scene, cfg), device=device)
        cam = rig.camera()
        preview = PygamePreview(rig, args.size, args.size, cfg.name)
    kills, times, counts = 0, [], []
    meter = metrics.RenderMeter()
    while fl.frame < args.frames:
        until_snap = args.snapshot_every - fl.frame % args.snapshot_every
        n = min(batch, args.frames - fl.frame, until_snap)
        t0 = time.perf_counter()
        fl, ov = render_batch(scene, cfg, spec, cam, fl, n, integrator, group)
        _sync(device)
        times.append(time.perf_counter() - t0)
        counts.append(n)
        meter.tick(times[-1], n)
        kills += ov
        print(f"frame {fl.frame}/{args.frames}  {times[-1] / n * 1e3:.3f} ms/frame"
              f"  {'walk overflow' if integrator in BDPT else 'overflow kills'} {ov}",
              flush=True)
        if preview is not None:
            srgb = film_mod.to_srgb(fl, exposure=cfg.exposure).cpu().numpy()
            preview.show((srgb * 255.0).astype(np.uint8))
            preview.set_hud(fl.frame, args.frames, meter.fps)
            action = preview.poll()
            if action == "quit":
                break
            if action == "camera":  # an orbit move restarts the accumulation
                cam = rig.camera()
                fl = film_mod.new_film(args.size, args.size, seed=args.seed, device=device)
                continue
        if fl.frame % args.snapshot_every == 0 or fl.frame == args.frames:
            film_mod.save_png(fl, args.out, exposure=cfg.exposure)
            if args.checkpoint:
                film_mod.save_checkpoint(fl, args.checkpoint)
    if preview is not None:
        preview.close()
        film_mod.save_png(fl, args.out, exposure=cfg.exposure)
    if not times:  # a checkpoint at or past --frames: nothing left to render
        film_mod.save_png(fl, args.out, exposure=cfg.exposure)
        times, counts = [0.0], [1]
    timed = slice(1, None) if len(times) > 1 else slice(None)
    report = {k: v for k, v in meter.report().items() if k != "frames"}
    print(json.dumps(dict(
        scene=args.example, integrator=integrator, nee=nee, size=args.size,
        frames=fl.frame, group=group if merged else None, batch=batch,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
        warmup_ms_per_frame=times[0] / counts[0] * 1e3,
        ms_per_frame=sum(times[timed]) / sum(counts[timed]) * 1e3,
        overflow_kills=kills, out=args.out, **report,
    )))


if __name__ == "__main__":
    main()
