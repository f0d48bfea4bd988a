"""The port's speed benchmark (twin of the JAX package's bench.py):
progressive path tracing, 1 spp per frame, of the 100k-triangle glass
benchmark scene at 512x512 on one card.

    python3 bench_torch.py          # from the repository root

`render_film_frames_merged` in dispatches of KF = 128 frames, merged
groups of 16, with the scene's schedule (`BENCH_SCHEDULE_MERGED`) and
payload divisors (`BENCH_PAY_DIVISORS`): one warm-up dispatch (it includes
the kernel's build on a fresh checkout), then 5 timed dispatches, each
ending in a device synchronize; frames per second from the median
dispatch.  Prints the card's name and power limit, context lines on
stderr, and as its last line of stdout one JSON object: `metric`
(pt_progressive_fps_100k_tri_512px), `value`, `unit`, `vs_baseline`
(against the 30 fps of the renderer this system was modelled on, on its
own card), and the run's `ms_per_frame`, `overflow_kills`, `device` and
`card`.  Exits non-zero without a CUDA card, and when any path was cut by
compaction capacity (overflow kills != 0: the estimator would be biased,
and the frame rate that of another workload).
"""

import json
import subprocess
import sys
import time

import torch

METRIC = "pt_progressive_fps_100k_tri_512px"
BASELINE_FPS = 30.0
SIZE = 512
KF = 128        # frames per dispatch
DISPATCHES = 5  # timed dispatches


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_step(scene, cfg, spec, cam, kf: int = KF):
    """step(film) -> (film', overflow kills): one dispatch of `kf` frames of
    the merged production path with the config's group, schedule and
    payload divisors."""
    from ti_raytrace_tpu_torch.integrators import pt_rgb

    nee = pt_rgb.has_nee_materials(scene)  # all glass: NEE adds exactly zero

    def step(fl):
        return pt_rgb.render_film_frames_merged(
            scene, spec, cam, fl, n_frames=kf, group=cfg.group, compaction=cfg.compaction,
            nee=nee, pay_divisors=cfg.pay_divisors)

    return step


def run(step, size: int, kf: int, dispatches: int, device) -> dict:
    """One warm-up dispatch of `step`, then `dispatches` timed ones on a
    fresh film; the result object of the JSON line (without the card)."""
    from ti_raytrace_tpu_torch import film as film_mod

    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fl = film_mod.new_film(size, size, device=device)
    t0 = time.perf_counter()
    fl, kills = step(fl)
    sync()
    log(f"warm-up dispatch, {kf} frames: {time.perf_counter() - t0:.1f} s")
    times = []
    for _ in range(dispatches):
        t0 = time.perf_counter()
        fl, ov = step(fl)
        sync()
        times.append(time.perf_counter() - t0)
        kills += ov
    med = sorted(times)[dispatches // 2]
    fps = kf / med
    log(f"{dispatches * kf} frames in {sum(times):.2f} s ({dispatches} dispatches, best "
        f"{min(times) / kf * 1e3:.3f} ms/frame, median {med / kf * 1e3:.3f} ms/frame); "
        f"compaction overflow kills: {kills}"
        + (" (estimator exact)" if kills == 0 else " (DEPTH BIAS!)"))
    return dict(
        metric=METRIC, value=round(fps, 3), unit="fps_at_1spp",
        vs_baseline=round(fps / BASELINE_FPS, 3), ms_per_frame=med / kf * 1e3,
        overflow_kills=int(kills), frames=fl.frame,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    )


def report(result: dict) -> int:
    """Prints the JSON line; the exit code: 1 when paths were cut."""
    print(json.dumps(result), flush=True)
    return 0 if result["overflow_kills"] == 0 else 1


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: CUDA is not available: the benchmark needs an NVIDIA GPU")
    from ti_raytrace_tpu_torch.examples.scenes import benchmark_100k, make_camera

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    scene, cfg = benchmark_100k("cuda")
    log(f"scene build: {time.perf_counter() - t0:.1f} s, prims={scene.n_prims}")
    spec, cam = make_camera(scene, cfg, SIZE, SIZE)
    log(f"group={cfg.group} compaction={cfg.compaction} pay={cfg.pay_divisors}")
    result = run(make_step(scene, cfg, spec, cam), SIZE, KF, DISPATCHES, "cuda")
    return report(dict(result, card=card))


if __name__ == "__main__":
    raise SystemExit(main())
