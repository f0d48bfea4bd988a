"""Golden-image gate of the port (twin of ti_raytrace_tpu/tools/golden.py):

    python -m ti_raytrace_tpu_torch.tools.golden --scene cornell_box \
        [--frames N] [--size 512] [--device cuda] [--out veach.png]

Renders a reference scene, tone-maps it with the reference's pipeline
(exposure 0.5, ACES + sRGB), takes the mean absolute difference against
the reference's committed PNG in 8-bit-normalized space and checks it
against the bound recorded in the JAX package's
`ti_raytrace_tpu/tools/golden_bounds.json` (read as a file: the port does
not import that package).  Exit 1 on a regression.  Targets: cornell_box,
sky_dome, spectral_box, veach_bdpt, veach_pt; prism_rainbow raises
NotImplementedError naming its ROADMAP item.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

BOUNDS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "ti_raytrace_tpu", "tools", "golden_bounds.json",
)

# name -> (scene, integrator override, reference image, frames): the
# reference's table.  256 frames for veach_pt: the concave ACES display
# transform turns residual noise into a diff inflation.
TARGETS = {
    "cornell_box": ("cornell_box", None, "out.png", 64),
    "sky_dome": ("sky_dome", None, "image/skydome.png", 32),
    "spectral_box": ("spectral_box", None, "image/spectral-cornellbox.png", 256),
    "veach_bdpt": ("veach_bdpt", None, "image/veach-bdpt512.png", 32),
    "veach_pt": ("veach_bdpt", "pt_rgb", "image/veach-pt512.png", 256),
    "prism_rainbow": ("prism_rainbow", None, "image/rainbow-far.png", 64),
}

_UNPORTED = {"prism_rainbow": "spectral BDPT and prism"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def render_scene(name: str, frames: int, size: int, integrator, device) -> tuple:
    """The scene's film tone-mapped to sRGB (W, H, 3) in [0, 1], and the
    host seconds per frame (each batch ends in a synchronize).  The
    scene's own integrator unless `integrator` overrides it, with the
    scene's compaction schedule; BDPT renders as the CLI does
    (render_frame_sliced in 2 slices, the scene's walk compaction and
    shadow cap), the spectral path tracer with the scene's sky and
    emitter scale."""
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import render_batch, spectral_data
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera

    scene, cfg = EXAMPLES[name](device)
    integrator = integrator or cfg.integrator
    if integrator not in ("pt_rgb", "pt_spec", "bdpt_rgb"):
        raise NotImplementedError(f"integrator {integrator!r}: ROADMAP 'to port'")
    spec, cam = make_camera(scene, cfg, size, size)
    sdata = spectral_data(cfg, integrator, device)
    batch = 4 if integrator == "bdpt_rgb" else 8
    fl = film_mod.new_film(size, size, device=device)
    t0 = time.perf_counter()
    while fl.frame < frames:
        # frame after frame (group 0), as the reference's gate renders
        fl, kills = render_batch(scene, cfg, spec, cam, fl, min(batch, frames - fl.frame),
                                 integrator, 0, sdata)
        if kills:
            raise RuntimeError(f"{name}: {kills} compaction overflow kills")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = (time.perf_counter() - t0) / frames
    srgb = film_mod.to_srgb(fl, cfg.exposure).cpu().numpy()
    return np.clip(srgb, 0.0, 1.0), seconds


def mean_abs_diff(img: np.ndarray, ref: np.ndarray) -> float:
    """Mean |film - reference| over the tone-mapped image, the reference
    nearest-resized to the render's resolution."""
    from ti_raytrace_tpu_torch.io.image import film_to_image

    img_rows = film_to_image(img)
    ref = ref[..., :3]
    if img_rows.shape != ref.shape:
        h, w = img_rows.shape[:2]
        yi = (np.arange(h) * ref.shape[0] // h).clip(0, ref.shape[0] - 1)
        xi = (np.arange(w) * ref.shape[1] // w).clip(0, ref.shape[1] - 1)
        ref = ref[yi][:, xi]
    return float(np.abs(img_rows - ref).mean())


def main(argv=None):
    from ti_raytrace_tpu_torch.io.assets import asset_path
    from ti_raytrace_tpu_torch.io.image import film_to_image, read_image, write_png

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="veach_pt", choices=sorted(TARGETS))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the tone-mapped render here")
    args = ap.parse_args(argv)
    if args.scene in _UNPORTED:
        raise NotImplementedError(f"golden target {args.scene!r} is outside the ported "
                                  f"slice (ROADMAP 'to port': {_UNPORTED[args.scene]})")

    device = torch.device(args.device)
    scene_name, integrator, rel, frames = TARGETS[args.scene]
    frames = args.frames or frames
    with open(BOUNDS_PATH) as f:
        bound = json.load(f)[args.scene]
    img, seconds = render_scene(scene_name, frames, args.size, integrator, device)
    ref = read_image(asset_path(rel))
    diff = mean_abs_diff(img, ref)
    if args.out:
        write_png(args.out, film_to_image(img))
    ok = diff <= bound
    log(f"{args.scene}: mean {img.mean():.4f} vs reference {ref.mean():.4f} "
        f"(ratio {img.mean() / max(ref.mean(), 1e-9):.3f})")
    print(json.dumps(dict(
        scene=args.scene, size=args.size, frames=frames, diff=diff, bound=bound,
        ok=ok, ms_per_frame=seconds * 1e3,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
    )))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
