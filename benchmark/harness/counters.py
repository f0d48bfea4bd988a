"""Counters over traced calls: top-level torch calls (a frozen copy of the
port's tools/profile_bdpt._OpCounter total) and the width of each launch
of the cluster kernel (live rays, and whether tmax bounds them), read
from the arguments of the tracer's dispatch."""

import contextlib

from torch.overrides import TorchFunctionMode


class CallCounter(TorchFunctionMode):
    """Counts top-level torch calls (torch functions and tensor methods;
    attribute reads excluded) made while the mode is on."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") != "__get__":
            self.calls += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def kernel_widths():
    """Record every launch of the cluster kernel in the block, made through
    the tracer's dispatch `ops.cluster_trace.cluster_trace`: yields a list
    that gains (n_valid, bounded) per launch, in launch order.  A dispatch
    of a wavefront with no tile launches nothing and is not recorded."""
    from ti_raytrace_tpu_torch.ops import cluster_trace as ct

    widths = []
    real = ct.cluster_trace

    def recorded(o, d, n_valid, bounds, order, tri, origin_mt, tmax=None, supers=None):
        out = real(o, d, n_valid, bounds, order, tri, origin_mt, tmax, supers)
        if o.shape[1] > 0:
            widths.append((int(n_valid), tmax is not None))
        return out

    ct.cluster_trace = recorded
    try:
        yield widths
    finally:
        ct.cluster_trace = real
