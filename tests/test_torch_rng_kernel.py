"""The threefry kernel (ti_raytrace_tpu_torch/csrc/rng.cu) and what
surrounds it in core/rng.py: the wrapper (`UNIFORM_KERNEL`), the dispatch
of `uniform` and its plain twin `uniform_plain`.

This file imports neither jax nor the JAX package, so it also runs on the
GPU machine, which has neither:

    python -m pytest tests/test_torch_rng_kernel.py -m gpu --noconftest -p no:cacheprovider

The CPU cases run the kernel's arithmetic (`kernel_transcript`, a numpy
uint32 transcript of the kernel: funnel-shift rotations, the key
injections, the float bit trick) against `uniform_plain` bit for bit, and
hold the dispatch and the wrapper's checks.  tests/test_torch_rng.py holds
`uniform_plain` to jax.random bit for bit.  The `gpu` cases launch the
kernel and hold it against `uniform_plain` on the CPU, moved to the card,
with `torch.equal`: the function is 32-bit integer arithmetic and one
exact subtraction, so there is no tolerance.
"""

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.tools.profile_bdpt import count_ops

torch.set_num_threads(2)

ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# every shape the eight paths draw at 512^2: camera jitter, a PT bounce at
# the camera width, the bench's merged deep widths, BDPT's walk step, light
# sample and strategy draws, pt_spec's wavelength draw
PATH_SHAPES = [(2, 262144), (8, 262144), (8, 838848), (8, 1048576), (5, 262144),
               (6, 131072), (3, 2621440), (262144,)]
# the other element counts the paths drew at 512^2 in chip_smoke.py's path
# phases on an H100 (the bench's deep widths, BDPT's per-slice draws,
# prism's compacted walks, the sharded ranks' halves)
RECORDED_COUNTS = [65536, 131072, 131200, 238720, 336640, 393216, 546560, 655360, 699008,
                   771200, 819200, 1048576, 1398016, 1572864, 3355392]


@pytest.fixture
def cuda():
    """Skips the test without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def kernel_transcript(key, idx):
    """csrc/rng.cu line by line in numpy uint32 (wrapping) arithmetic for
    the flattened element indices idx (uint64): float32 draws."""
    u32 = np.uint32
    k1, k2 = (u32(w) for w in key.tolist())
    ks = (k1, k2, k1 ^ k2 ^ u32(0x1BD11BDA))
    x = (idx >> np.uint64(32)).astype(u32) + ks[0]
    y = (idx & np.uint64(0xFFFFFFFF)).astype(u32) + ks[1]
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x = x + y
            y = ((y << u32(r)) | (y >> u32(32 - r))) ^ x  # __funnelshift_l(y, y, r)
        x = x + ks[(g + 1) % 3]
        y = y + np.array(int(ks[(g + 2) % 3]) + g + 1, u32)  # the hoisted constant, wrapped
    bits = x ^ y
    return ((bits >> u32(9)) | u32(0x3F800000)).view(np.float32) - np.float32(1.0)


def key_chain(seed):
    """A key through split and fold_in, as the renderers derive theirs."""
    return rng.fold_in(rng.split(rng.fold_in(rng.PRNGKey(seed), 7), 3)[2], 14)


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("shape", [(1,), (3,), (2, 256), (8, 513), (5, 4099)])
@pytest.mark.parametrize("seed", [0, 5, 2**32 - 1])
def test_kernel_arithmetic_equals_plain(seed, shape):
    key = key_chain(seed)
    want = rng.uniform_plain(key, shape).numpy()
    got = kernel_transcript(key, np.arange(np.prod(shape), dtype=np.uint64)).reshape(shape)
    assert got.dtype == np.float32 and got.shape == want.shape == shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (got >= 0.0).all() and (got < 1.0).all()


def test_kernel_arithmetic_high_counter_word():
    """Elements at and past 2**32 carry a non-zero high counter word: the
    kernel's (i >> 32, i & 0xFFFFFFFF) pair against the plain hash
    `threefry2x32` on Python integers and the plain version's bit trick."""
    key = key_chain(5)
    k1, k2 = (int(w) for w in key.tolist())
    idx = [2**32 - 1, 2**32, 2**32 + 1, 3 * 2**32 + 12345, 2**40 + 7]
    got = kernel_transcript(key, np.array(idx, np.uint64))
    for i, g in zip(idx, got):
        b1, b2 = rng.threefry2x32(k1, k2, i >> 32, i & 0xFFFFFFFF)
        f = torch.tensor([((b1 ^ b2) >> 9) | 0x3F800000], dtype=torch.int32)
        want = (f.view(torch.float32) - 1.0).numpy()
        assert g.view(np.uint32) == want.view(np.uint32)[0]


def test_uniform_on_cpu_takes_the_plain_twin():
    """CPU (and None) draws go to `uniform_plain`: no launch, no build, the
    same bits; an unknown device raises rather than falling back."""
    key = key_chain(0)
    rng.UNIFORM_KERNEL.reset_counts()
    want = rng.uniform_plain(key, (8, 513))
    for device in (None, "cpu", torch.device("cpu")):
        got = rng.uniform(key, (8, 513), device=device)
        assert got.device.type == "cpu" and torch.equal(got, want)
    assert rng.UNIFORM_KERNEL.launches == 0 and not rng.UNIFORM_KERNEL.launches_by_width
    with pytest.raises(NotImplementedError):
        rng.uniform(key, (8, 513), device="meta")


def test_kernel_wrapper_checks_raise():
    """A non-CUDA device or a key that is not a host tensor of shape (2,)
    raises before any build or launch."""
    k = rng.UNIFORM_KERNEL
    k.reset_counts()
    key = key_chain(0)
    with pytest.raises(ValueError, match="CUDA"):
        k(key, (8, 16), torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        k(key, (8, 16), torch.device("meta"))
    for bad in (key[:1], torch.zeros(3, dtype=torch.int64), rng.split(key), key.tolist(),
                key.to("meta")):
        with pytest.raises(ValueError, match="shape"):
            k(bad, (8, 16), torch.device("cuda"))
    assert k.launches == 0 and k._lib is None


def test_plain_draw_torch_calls():
    """The plain twin's top-level torch calls per draw, counted as
    tools/profile_bdpt.py counts a frame's (tools/host_calls.py takes the
    difference to the kernel's draw as the calls the kernel saves); the
    count does not depend on the shape."""
    key = key_chain(0)
    counts = {shape: sum(count_ops(lambda s=shape: rng.uniform_plain(key, s)).values())
              for shape in ((3,), (8, 513))}
    print(f"plain draw: {counts} top-level torch calls")
    assert len(set(counts.values())) == 1 and 150 <= counts[(3,)] <= 200


# ------------------------------------------------------------------ GPU


def _kernel_vs_plain(key, shape):
    """The kernel through `uniform` on the card against `uniform_plain` on
    the CPU, moved to the card: equal bit for bit.  Returns the draw."""
    k = rng.UNIFORM_KERNEL
    n0 = k.launches
    got = rng.uniform(key, shape, device="cuda")
    torch.cuda.synchronize()
    want = rng.uniform_plain(key, shape).cuda()
    assert got.dtype == torch.float32 and got.shape == shape and got.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert k.launches == n0 + 1
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 255, 257, 2**20 + 3])
def test_kernel_lengths(cuda, n):
    """One element, either side of a 256-thread block, a ragged million."""
    _kernel_vs_plain(key_chain(2**32 - 1), (n,))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_path_shapes(cuda, shape):
    u = _kernel_vs_plain(key_chain(5), shape)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("n", RECORDED_COUNTS)
def test_kernel_recorded_counts(cuda, n):
    _kernel_vs_plain(key_chain(2**32 - 1), (n,))


@pytest.mark.gpu
def test_kernel_grid_stride(cuda):
    """More elements than one grid of 65,536 blocks of 256 threads covers:
    the grid-stride loop draws the rest."""
    _kernel_vs_plain(key_chain(0), (3, 65536 * 256 // 3 + 1000))


@pytest.mark.gpu
def test_zero_elements_launch_nothing(cuda):
    k = rng.UNIFORM_KERNEL
    k.reset_counts()
    for shape in ((0,), (8, 0)):
        u = rng.uniform(key_chain(0), shape, device="cuda")
        assert u.shape == shape and u.device.type == "cuda" and u.dtype == torch.float32
    assert k.launches == 0


@pytest.mark.gpu
def test_launches_counted_by_width(cuda):
    k = rng.UNIFORM_KERNEL
    k.reset_counts()
    key = key_chain(0)
    rng.uniform(key, (8, 100), device="cuda")
    rng.uniform(key, (800,), device=torch.device("cuda"))
    rng.uniform(key, (2, 64), device="cuda:0")
    assert k.launches == 3 and dict(k.launches_by_width) == {800: 2, 128: 1}
    assert k.build_info is not None and k.build_info.path


@pytest.mark.gpu
def test_kernel_draw_torch_calls(cuda):
    """One draw through the kernel costs at most 3 top-level torch calls
    (the allocation, the key read, the pointer); the plain twin's on the
    card costs what test_plain_draw_torch_calls counts on the CPU."""
    key = key_chain(0)
    dev = torch.device("cuda")
    rng.uniform(key, (8, 1024), device=dev)  # the build
    kernel = sum(count_ops(lambda: rng.uniform(key, (8, 1024), device=dev)).values())
    plain = sum(count_ops(lambda: rng.uniform_plain(key, (8, 1024), device=dev)).values())
    print(f"top-level torch calls per draw: kernel {kernel}, plain {plain}")
    assert kernel <= 3 and plain >= 150
