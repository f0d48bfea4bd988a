"""Render metrics: the fps / spp/s meter, the render path's spans and
profiler hooks (the meter is the twin of ti_raytrace_tpu/metrics.py).
`RenderMeter` tracks the wall clock of each progressive dispatch; `span`
(and the decorator `spanned`) marks one stage of the render path;
`profile_trace` wraps torch.profiler around a block (the CUDA activity
too when a card is present); `timed` prints a block's wall time.

Spans.  `with span(name, **attrs):` around a stage records, while a
torch.profiler session is open or inside `recording()`, one
`SpanRecord` (id, parent id, call id, name, start and end in ns, attrs)
into a bounded in-memory buffer (`spans()`, `clear_spans()`), and opens
a profiler range of the same name, so a host-op profile shows the stage.
The parent is the innermost open span; the call id is the outermost open
span's id (the render path's root span is `render.call`, one per call of
`examples/run.render_batch`).  Times come from `time.time_ns()`, the
clock of the profiler's events (Unix-epoch ns), so the records lie on
the device trace's time base.  Otherwise a span costs one flag check and
makes no torch call.

Launches.  The spans are the only record of a hand kernel's (csrc/)
launches: ops/cuda_build.Launcher.launch, where every one of them
launches, counts each on the innermost recording span now open
(`mark_launch`, the record's `launched`), and `kernel_launches` reads
those counts.
"""

import collections
import contextlib
import functools
import itertools
import os
import time

import torch
from torch.autograd import profiler as _profiler

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_DIR = os.path.join(_ROOT, "chiprun_out", "profile")

MAX_SPANS = 1 << 18  # records kept; later spans of a full buffer are dropped

# launched: the hand-kernel launches made while the span was the innermost
# recording one (mark_launch)
SpanRecord = collections.namedtuple("SpanRecord", "id parent call name t0_ns t1_ns attrs launched",
                                    defaults=(0,))

_recording = 0     # open recording() blocks
_open = []         # the recording spans now open, innermost last
_buffer = []       # closed spans, in the order they closed
_ids = itertools.count(1)


class span:
    """A stage of the render path: `with span("pt.bounce", depth=3, width=n):`.
    Records only while a profiler session is open or inside `recording()`
    (see the module docstring)."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "t0_ns", "launched", "_range")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self.id = None

    def __enter__(self):
        if not (_profiler._is_profiler_enabled or _recording):
            return self
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = outer.id if outer else None
        self.call = outer.call if outer else self.id
        self.launched = 0
        _open.append(self)
        self.t0_ns = time.time_ns()  # the span holds its profiler range
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.id is None:
            return False
        self._range.__exit__(*exc)
        t1_ns = time.time_ns()
        _open.pop()
        if len(_buffer) < MAX_SPANS:
            _buffer.append(SpanRecord(self.id, self.parent, self.call, self.name, self.t0_ns,
                                      t1_ns, self.attrs, self.launched))
        return False


def spanned(name: str):
    """Decorator: every call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


ALLOCATOR_COUNTERS = ("num_alloc_retries", "num_device_alloc", "num_device_free")


class call_span(span):
    """The root span of a render call: records, as attributes `alloc_before`
    and `alloc_after`, the caching allocator's ALLOCATOR_COUNTERS on the
    torch.device `device` when it is a card (a retry is a cudaMalloc that
    failed and was retried after the cache was freed: an allocator stall)."""

    __slots__ = ("device",)

    def __init__(self, name: str, device, **attrs):
        super().__init__(name, **attrs)
        self.device = device

    def _counters(self) -> dict:
        if self.device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(self.device)
        return {k: stats.get(k, 0) for k in ALLOCATOR_COUNTERS}

    def __enter__(self):
        super().__enter__()
        if self.id is not None:
            self.attrs["alloc_before"] = self._counters()
        return self

    def __exit__(self, *exc):
        if self.id is not None:
            self.attrs["alloc_after"] = self._counters()
        return super().__exit__(*exc)


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not (tools' switch)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list:
    """The recorded spans (SpanRecord), in the order they closed."""
    return list(_buffer)


def clear_spans():
    _buffer.clear()


def mark_launch():
    """Count one hand-kernel launch on the innermost recording span now open
    (none open: nothing is recorded).  Called by ops/cuda_build.Launcher.launch
    alone, after the launch returned 0."""
    if _open:
        _open[-1].launched += 1


def kernel_launches(name: str, by: str) -> collections.Counter:
    """The hand-kernel launches made inside the recorded spans named `name`,
    counted by the value of their attribute `by` (trace.kernel: n_valid,
    the live lanes; dense_trace._sweep and rng.uniform: n; bsdf.disney: op;
    pt.shade: entry).  Raises where the buffer filled up, which would
    undercount."""
    if len(_buffer) >= MAX_SPANS:
        raise RuntimeError(f"metrics.kernel_launches: the span buffer is full ({MAX_SPANS} "
                           f"spans), later launches went unrecorded")
    counts = collections.Counter()
    for r in _buffer:
        if r.name == name and r.launched:
            counts[r.attrs[by]] += r.launched
    return counts


def current_span():
    """The name of the innermost recording span now open, or None."""
    return _open[-1].name if _open else None


class RenderMeter:
    def __init__(self):
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

    def summary(self) -> str:
        return (
            f"{self.fps:6.2f} fps "
            f"(last {self.last_s * 1e3:6.1f} ms, compile {self._warmup_s or 0:.1f} s)"
        )

    def report(self) -> dict:
        return dict(
            frames=self.frames,
            fps=round(self.fps, 3),
            spp_per_s=round(self.fps, 3),  # 1 spp per progressive frame
            avg_frame_ms=round(1e3 * self.total_s / max(self.frames, 1), 3),
            compile_s=round(self._warmup_s or 0.0, 3),
        )


@contextlib.contextmanager
def profile_trace(logdir: str = PROFILE_DIR):
    """torch.profiler around a block: CPU activity, plus CUDA activity
    when a card is present.  Yields the profiler; on exit its Chrome trace
    is written under `logdir` (default: chiprun_out/profile in the
    checkout)."""
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
