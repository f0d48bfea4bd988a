"""The least work of a dense-kernel launch (csrc/dense_trace.cu), for
`dense_kernel_roofline`, and the kernel's (warp, group) pairs, for
`dense_kernel.culled_share`.

A launch of n lanes reads each lane's origin and direction (float32 x 3
each) and writes its t (float32) and prim (int32): 32 bytes a lane that
no implementation of the sweep's interface can skip.  The scene's table
is not counted, nor is any operation: a cull may decide a lane without a
single triangle test, so no amount of either is a lower bound, and the
bound is the bytes over the memory rate.  It reads only the launch's
width, so the same rays give the same bound whatever kernel traces them,
and no cull can push the share past 100%."""

RAY_IN = 24   # origin and direction, float32 x 3 each
HIT_OUT = 8   # t (float32) and prim (int32)
THREADS = 256  # lanes of one block of the kernel
WARPS = THREADS // 32


def launch_bytes(n: int) -> int:
    """Bytes that a launch of n lanes must move."""
    return n * (RAY_IN + HIT_OUT)


def warp_group_pairs(n: int, groups: int) -> int:
    """The (warp, group) pairs of a launch of n lanes over `groups` groups
    of the table: every warp of its blocks, the last block's dead lanes
    included, meets every group once (tools/dense_sweep.kernel_vs_plain's
    `pairs`)."""
    return -(-n // THREADS) * WARPS * groups
