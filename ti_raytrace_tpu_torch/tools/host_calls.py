"""Top-level torch calls, rng draws and host time per frame on the eight paths.

    python -m ti_raytrace_tpu_torch.tools.host_calls [--frames 2] [--reps 2]
        [--out calls.json] [--size 512] [--device cuda]

One process at 512^2 on the card renders each workload as the CLI renders
it (`examples.run.render_batch` with the scene's integrator, schedule and
group): bench (benchmark_100k, merged groups of 16), veach_pt (the Veach
scene under pt_rgb with NEE), veach_bdpt (BDPT in 2 slices), cornell_box,
single_model (merged groups of 16), sky_dome, spectral_box and
prism_rainbow (spectral BDPT, unsliced, shadow cap 0.09).  For each, after
one warm-up call: `--reps` timed calls of `--frames` frames (a whole group
on the merged paths), each a host ms/frame between two synchronizes, with
the rng kernel's launches per frame in all and by elements drawn (its
wrapper's counts, reset before the timed calls); then one more call under
tools/profile_bdpt.py's counter: top-level torch calls per frame; on the
card one more under torch.profiler: device ms per frame (every kernel's
device time, the ctypes launches included), the rng kernel's part of it
and the device's busy share of that call's wall time.

It also counts the calls of one draw through the kernel and through its
plain twin `uniform_plain` on the card.  The calls the kernel saves per
frame are draws per frame x their difference: derived, never rendered
through the twin.  Prints a line per path and, last, one JSON object (also
written to `--out`).  `--device cpu` at a small `--size` rehearses the
tool without a card: every draw there takes the plain twin, so nothing is
saved.
"""

import argparse
import json
import subprocess
import time

import torch

from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.tools.profile_bdpt import count_ops, device_profile

# (path, example scene, integrator: None for the scene's own)
PATHS = (("bench", "benchmark_100k", None), ("veach_pt", "veach_bdpt", "pt_rgb"),
         ("veach_bdpt", "veach_bdpt", None), ("cornell_box", "cornell_box", None),
         ("single_model", "single_model", None), ("sky_dome", "sky_dome", None),
         ("spectral_box", "spectral_box", None), ("prism_rainbow", "prism_rainbow", None))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_calls(shape, device) -> dict:
    """Top-level torch calls of one draw of `shape` through `rng.uniform`
    (the kernel on a CUDA device) and through the plain twin, on `device`."""
    key = rng.PRNGKey(1)
    rng.uniform(key, shape, device=device)  # the build, uncounted
    _sync(device)
    kernel = sum(count_ops(lambda: rng.uniform(key, shape, device=device)).values())
    plain = sum(count_ops(lambda: rng.uniform_plain(key, shape, device=device)).values())
    return dict(kernel=kernel, plain=plain)


def measure_path(name, example, integrator, size, frames, reps, per_draw, device) -> dict:
    """One path at size^2: a warm-up call, `reps` timed calls, one counted
    call.  Returns its row."""
    from ti_raytrace_tpu_torch import film as film_mod
    from ti_raytrace_tpu_torch.examples.run import render_batch, spectral_data
    from ti_raytrace_tpu_torch.examples.scenes import EXAMPLES, make_camera

    scene, cfg = EXAMPLES[example](device)
    integrator = integrator or cfg.integrator
    spec, cam = make_camera(scene, cfg, size, size)
    sdata = spectral_data(cfg, integrator, device)
    group = cfg.group or 0
    merged = integrator == "pt_rgb" and cfg.compaction and group > 1
    n = group if merged else frames
    state = dict(film=film_mod.new_film(size, size, seed=0, device=device), overflow=0)

    def render():
        state["film"], ov = render_batch(scene, cfg, spec, cam, state["film"], n, integrator,
                                         group, sdata)
        state["overflow"] += int(ov)

    render()  # warm-up
    _sync(device)
    rng.UNIFORM_KERNEL.reset_counts()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render()
        _sync(device)
        ms.append((time.perf_counter() - t0) / n * 1e3)
    timed = reps * n
    draws = rng.UNIFORM_KERNEL.launches / timed
    by_width = {w: c / timed for w, c in sorted(rng.UNIFORM_KERNEL.launches_by_width.items())}
    calls = sum(count_ops(render).values()) / n
    _sync(device)
    saved = draws * (per_draw["plain"] - per_draw["kernel"])
    row = dict(path=name, example=example, integrator=integrator, prims=scene.n_prims,
               frames_per_call=n, ms_per_frame=ms, calls_per_frame=calls,
               draws_per_frame=draws, draws_per_frame_by_width=by_width,
               rng_calls_per_frame=draws * per_draw["kernel"],
               rng_calls_per_frame_plain=draws * per_draw["plain"],
               calls_saved_per_frame=saved, overflow=state["overflow"],
               hdr_mean=float(state["film"].hdr.mean()))
    if device.type == "cuda":
        prof = device_profile(render, device)
        row.update(device_ms_per_frame=prof["device_ms"] / n,
                   rng_device_ms_per_frame=prof["threefry_ms"] / n,
                   busy_share=prof["busy_share"])
    print(f"{name} ({integrator}, {scene.n_prims} prims, {n} frames per call): ms/frame "
          + ", ".join(f"{m:.3f}" for m in ms) + f"; {calls:.1f} top-level torch calls per "
          f"frame; {draws:g} rng draws per frame (by elements: "
          + ", ".join(f"{w}: {c:g}" for w, c in by_width.items())
          + f"); rng's calls per frame {row['rng_calls_per_frame']:.1f} through the kernel, "
          f"{row['rng_calls_per_frame_plain']:.1f} through the plain twin: {saved:.1f} saved; "
          f"overflow {state['overflow']}", flush=True)
    if device.type == "cuda":
        print(f"{name}: device {row['device_ms_per_frame']:.3f} ms/frame, of it rng kernel "
              f"{row['rng_device_ms_per_frame']:.4f}; busy {row['busy_share']:.3f} of the "
              f"profiled wall", flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=2,
                    help="frames per call on the paths without a merged group")
    ap.add_argument("--reps", type=int, default=2, help="timed calls per path")
    ap.add_argument("--out", default=None, help="write the JSON object here too")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--paths", default=",".join(p[0] for p in PATHS),
                    help="comma-separated subset of the paths")
    a = ap.parse_args(argv)
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("host_calls: CUDA was asked for and is not available")
    card = "cpu"
    if device.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip()
    print(card, flush=True)
    shape = (8, a.size * a.size)  # a path-tracing bounce's draw at the camera width
    per_draw = draw_calls(shape, device)
    print(f"top-level torch calls of one {shape} draw: rng.uniform {per_draw['kernel']}, "
          f"plain twin {per_draw['plain']}", flush=True)
    wanted = a.paths.split(",")
    rows = [measure_path(name, example, integrator, a.size, a.frames, a.reps, per_draw, device)
            for name, example, integrator in PATHS if name in wanted]
    result = dict(card=card, size=a.size, device=str(device), calls_per_draw=per_draw,
                  paths=rows)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
