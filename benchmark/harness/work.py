"""The least work of a closest-hit launch, for `cluster_kernel_roofline`:
the bytes that no implementation of the kernel's interface can skip.  A
launch of n live rays reads each ray's origin and direction (float32
x 3 each) and, where given, its tmax (float32), and writes each ray's t,
prim, u and v (4 bytes each).  Scene data is not counted: a traversal
may skip most of it, so no amount of it is a lower bound.  Nor is any
operation: a ray may be decided without a single triangle test, so the
operations term of max(ops / peak, bytes / rate) is 0, and the bound is
the bytes over the memory rate.  It reads only the launch's width, never
the program's clusters, orders or counters, so the same rays give the
same bound whatever kernel traces them, and a kernel cannot beat it."""

RAY_IN = 24    # origin and direction, float32 x 3 each
TMAX_IN = 4    # tmax, float32, where the launch is bounded
HIT_OUT = 16   # t, prim, u, v


def launch_bytes(n_valid: int, bounded: bool) -> int:
    """Bytes that a launch of n_valid live rays must move."""
    return n_valid * (RAY_IN + (TMAX_IN if bounded else 0) + HIT_OUT)


def bound_s(nbytes: float, peak: dict) -> float:
    """The least time (s) of a launch that must move `nbytes`."""
    return nbytes / peak["bytes_per_s"]
