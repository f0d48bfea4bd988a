"""Region-wise comparison of the spectral_box render with the reference
golden (image/spectral-cornellbox.png) (twin of
ti_raytrace_tpu/tools/spectral_regions.py):

    python -m ti_raytrace_tpu_torch.tools.spectral_regions [--frames 64]
        [--size 512] [--device cuda] [--save spectral_box.png]

The lamp region isolates the emission path (D65 times the light colour's
rgb2spec tint); the white, red and green wall regions isolate the
measured-SPD reflectance path.  A uniform deficit points at the emission
or the white-point normalisation; a deficit on one wall at its SPD table.
The render is the golden gate's (`tools/golden.render_scene`).
"""

import argparse
import sys
import time

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# (name, x0, x1, y0, y1) in 512-render row-major image coordinates (y
# down), scaled for other sizes: the lamp is the bright ceiling patch, the
# walls are at the image's left and right borders.
REGIONS = [
    ("lamp",      220, 290, 20, 60),
    ("ceiling",   100, 410, 70, 110),
    ("left_wall",  10,  60, 180, 380),
    ("right_wall", 450, 500, 180, 380),
    ("back_wall", 180, 330, 180, 330),
    ("floor",     150, 360, 440, 500),
]


def region_stats(img, size):
    """{region: (mean rgb (3,), mean)} of a row-major (H, W, >= 3) image
    rendered at size^2."""
    out = {}
    s = size / 512.0
    for name, x0, x1, y0, y1 in REGIONS:
        r = img[int(y0 * s):int(y1 * s), int(x0 * s):int(x1 * s), :3]
        out[name] = (r.mean(axis=(0, 1)), r.mean())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--scene", default="spectral_box")
    ap.add_argument("--ref", default="image/spectral-cornellbox.png")
    ap.add_argument("--save", default=None, help="also write the tone-mapped render here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ti_raytrace_tpu_torch.io.image import film_to_image, write_png
    from ti_raytrace_tpu_torch.tools.golden import load_reference, render_scene

    t0 = time.time()
    img, _ = render_scene(args.scene, args.frames, args.size, None, torch.device(args.device))
    log(f"rendered in {time.time() - t0:.1f}s")
    img_rows = film_to_image(img)
    if args.save:
        write_png(args.save, img_rows)
        log(f"saved {args.save}")

    ref = load_reference(args.ref)[..., :3]
    if ref.shape[0] != args.size:
        yi = np.arange(args.size) * ref.shape[0] // args.size
        ref = ref[yi][:, yi]
    ours = region_stats(img_rows, args.size)
    theirs = region_stats(ref, args.size)

    def fmt(v):
        return "[" + " ".join(f"{x:.3f}" for x in v) + "]"

    print(f"{'region':<11s} {'ours rgb':<24s} {'ref rgb':<24s} ratio")
    for name, *_ in REGIONS:
        (o_rgb, o_m), (r_rgb, r_m) = ours[name], theirs[name]
        print(f"{name:<11s} {fmt(o_rgb):<24s} {fmt(r_rgb):<24s} {o_m / max(r_m, 1e-9):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
