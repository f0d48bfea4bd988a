"""Render metrics: fps / spp/s / Mrays/s counters and profiler hooks (twin
of ti_raytrace_tpu/metrics.py).  `RenderMeter` tracks the wall clock of
each progressive dispatch; `profile_trace` wraps torch.profiler around a
block (the CUDA activity too when a card is present); `timed` prints a
block's wall time."""

import contextlib
import os
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_DIR = os.path.join(_ROOT, "chiprun_out", "profile")


class RenderMeter:
    def __init__(self, pixels_per_frame: int, rays_per_pixel_estimate: float = 1.0):
        self.pixels = pixels_per_frame
        self.rpp = rays_per_pixel_estimate
        self.frames = 0
        self.total_s = 0.0
        self.last_s = 0.0
        self._warmup_s = None  # the first dispatch, kernel builds included

    def tick(self, seconds: float, frames: int = 1):
        """Record one dispatch of `frames` progressive frames.  The first
        dispatch (whatever its frame count) is the warm-up and stays out
        of the steady-state rate."""
        if self._warmup_s is None:
            self._warmup_s = seconds
            return
        self.frames += frames
        self.total_s += seconds
        self.last_s = seconds / frames

    @property
    def fps(self) -> float:
        return self.frames / self.total_s if self.total_s > 0 else 0.0

    @property
    def mrays_per_s(self) -> float:
        """Primary-ray throughput: camera rays only (30 fps at 512^2 is
        about 7.9 Mrays/s)."""
        return self.fps * self.pixels * self.rpp / 1e6

    def summary(self) -> str:
        return (
            f"{self.fps:6.2f} fps  {self.mrays_per_s:7.2f} Mray/s "
            f"(last {self.last_s * 1e3:6.1f} ms, compile {self._warmup_s or 0:.1f} s)"
        )

    def report(self) -> dict:
        return dict(
            frames=self.frames,
            fps=round(self.fps, 3),
            spp_per_s=round(self.fps, 3),  # 1 spp per progressive frame
            mrays_per_s=round(self.mrays_per_s, 3),
            avg_frame_ms=round(1e3 * self.total_s / max(self.frames, 1), 3),
            compile_s=round(self._warmup_s or 0.0, 3),
        )


@contextlib.contextmanager
def profile_trace(logdir: str = PROFILE_DIR):
    """torch.profiler around a block: CPU activity, plus CUDA activity
    when a card is present.  Yields the profiler; on exit its Chrome trace
    is written under `logdir` (default: chiprun_out/profile in the
    checkout)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}.json"))


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {time.perf_counter() - t0:.3f}s")
