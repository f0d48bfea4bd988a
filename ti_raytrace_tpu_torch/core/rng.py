"""Counter-based RNG: a torch twin of JAX's threefry2x32 key chain.

Bit-equal to `jax.random` with the threefry2x32 implementation and
`jax_threefry_partitionable=True` (the JAX package's configuration), so a
render of the port and of the reference from the same seed draw the same
uniforms lane for lane.  A key is an int64 tensor of shape (2,) holding
the two uint32 words of JAX's raw key data; it lives on the host, and
only `uniform` touches a device.

The key chain is scalar work, done in Python integers.  `uniform` draws
on the requested device: on a CUDA device one launch of the hand kernel
csrc/rng.cu (`UNIFORM_KERNEL`), on the CPU `uniform_plain`, its plain
twin, which runs the same hash over an iota with int64 tensors masked to
32 bits (torch has no full uint32 arithmetic).  Both give the same bits.

A `DeviceKey` holds its words in a device tensor instead: `split`,
`fold_in` and `uniform` then derive and draw on that device (csrc/rng.cu's
device-key kernels; int64 tensor ops on the CPU), reading the words when
the work runs.  A render captured into a CUDA graph with such a key draws
anew from whatever words are written into it before each replay.
"""

import math

import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.ops.cuda_build import I64, PTR, U32, Launcher

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the counter pair (x1, x2) under the key
    (k1, k2).  Operands are Python ints or int64 tensors holding values in
    [0, 2**32); returns the two output words in the same form."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    y = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & _M32
            y = (((y << r) | (y >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        y = (y + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, y


class DeviceKey:
    """A key whose two words live in `words`, a (2,) int64 tensor on the
    device that derives and draws with it.  `split` returns a list of
    DeviceKeys, `fold_in` one, `uniform` draws on the words' device."""

    __slots__ = ("words",)

    def __init__(self, words: torch.Tensor):
        self.words = words


def _words(key):
    if isinstance(key, DeviceKey):  # the CPU twin's: 0-dim int64 tensors
        return key.words[0], key.words[1]
    k1, k2 = key.tolist()  # one host read, one top-level torch call
    return int(k1), int(k2)


def _device_keys(key: DeviceKey, first: int, num: int) -> list:
    """Keys threefry(key, (0, first + i)) for i < num, as DeviceKeys."""
    w = key.words
    if w.device.type == "cuda":
        out = torch.empty((num, 2), dtype=torch.int64, device=w.device)
        KEY_KERNELS.launch("threefry_keys_launch", w.device, w.data_ptr(), out.data_ptr(),
                           first, num)
    else:
        x0, x1 = threefry2x32(w[0], w[1], 0, torch.arange(first, first + num,
                                                          dtype=torch.int64))
        out = torch.stack([x0, x1], dim=1)
    return [DeviceKey(out[i]) for i in range(num)]


def _key(w1: int, w2: int) -> torch.Tensor:
    return torch.tensor([w1, w2], dtype=torch.int64)


def PRNGKey(seed: int) -> torch.Tensor:
    """jax.random.PRNGKey for a seed in [0, 2**32)."""
    seed = int(seed)
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return _key(0, seed)


def split(key, num: int = 2) -> torch.Tensor:
    """jax.random.split: (num, 2) new keys (fold-like partitionable form:
    key i is threefry(key, (0, i))); of a DeviceKey, a list of num."""
    if isinstance(key, DeviceKey):
        return _device_keys(key, 0, num)
    k1, k2 = _words(key)
    return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                        dtype=torch.int64)


def fold_in(key, data: int) -> torch.Tensor:
    """jax.random.fold_in with a non-negative 32-bit integer."""
    if isinstance(key, DeviceKey):
        return _device_keys(key, int(data) & _M32, 1)[0]
    k1, k2 = _words(key)
    return _key(*threefry2x32(k1, k2, 0, int(data) & _M32))


def random_bits(key, shape, device=None) -> torch.Tensor:
    """32 random bits per element (int64 in [0, 2**32)), row-major over
    `shape`, as jax.random.bits."""
    k1, k2 = _words(key)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    return (b1 ^ b2).reshape(shape)


def uniform_plain(key, shape, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) in [0, 1): the top 23 bits
    become the mantissa of a float in [1, 2), minus one.  The plain twin
    of csrc/rng.cu: ~180 elementwise torch calls per draw."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


# 32-bit integer operations per element of csrc/rng.cu, counted from its
# source (the bound of its note): 75 in all, of which the 43 shifts and
# logic ops run only on the integer ALU pipe, while the 32 adds may also
# issue as IMAD on the FMA pipe.  It writes 4 bytes per element.
UNIFORM_INT_OPS = 75
UNIFORM_ALU_OPS = 43


class _UniformKernel(Launcher):
    """csrc/rng.cu: one launch a draw."""

    SOURCE = "rng.cu"
    ENTRIES = {"threefry_uniform_launch": [PTR, U32, U32, I64, PTR]}
    ERROR = "threefry_uniform_error_string"

    def __call__(self, key, shape, device) -> torch.Tensor:
        """uniform(key, shape) drawn by the kernel into a new float32
        tensor on `device`, a CUDA torch.device.  The key must be a host
        tensor of shape (2,) (its words are read without a device sync);
        zero elements return an empty tensor without a launch.  Three
        top-level torch calls: the allocation, the key read, the pointer."""
        if not (isinstance(key, torch.Tensor) and key.device.type == "cpu"
                and key.shape == (2,)):
            raise ValueError(f"threefry_uniform: the key must be a host tensor of shape (2,), "
                             f"got {type(key).__name__} "
                             f"{getattr(key, 'shape', '')} on {getattr(key, 'device', '')}")
        if device.type != "cuda":
            raise ValueError(f"threefry_uniform: the kernel draws on a CUDA device, got {device}")
        out = torch.empty(shape, dtype=torch.float32, device=device)
        n = math.prod(out.shape)
        if n == 0:
            return out
        k1, k2 = _words(key)
        self.launch("threefry_uniform_launch", out.device, out.data_ptr(), k1, k2, n)
        return out


UNIFORM_KERNEL = _UniformKernel()


class _KeyKernels(Launcher):
    """csrc/rng.cu's device-key kernels (DeviceKey): the derivation of
    keys and the draw, each one launch."""

    SOURCE = "rng.cu"
    ENTRIES = {"threefry_keys_launch": [PTR, PTR, U32, U32],
               "threefry_uniform_key_launch": [PTR, PTR, I64]}
    ERROR = "threefry_uniform_error_string"

    def uniform(self, key: DeviceKey, shape, device) -> torch.Tensor:
        """uniform(key, shape) into a new float32 tensor on `device`, the
        CUDA device that holds the key's words."""
        out = torch.empty(shape, dtype=torch.float32, device=device)
        n = math.prod(out.shape)
        if n:
            self.launch("threefry_uniform_key_launch", device, out.data_ptr(),
                        key.words.data_ptr(), n)
        return out


KEY_KERNELS = _KeyKernels()


def uniform(key, shape, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32) on `device`: the kernel on a
    CUDA device, `uniform_plain` on the CPU (None: the CPU); any other
    device raises.  The draw is a span "rng.uniform" (metrics.span), so a
    reader of a trace can attribute the ctypes launch, which the profiler
    ties to no torch call; a recording span carries the elements drawn,
    `n`."""
    dev = device
    if not isinstance(dev, torch.device):  # a torch.device costs a torch call to construct
        dev = torch.device("cpu" if device is None else device)
    with metrics.span("rng.uniform") as sp:
        if sp.id is not None:
            sp.attrs["n"] = math.prod(shape)
        if dev.type == "cuda":
            if isinstance(key, DeviceKey):
                return KEY_KERNELS.uniform(key, shape, dev)
            return UNIFORM_KERNEL(key, shape, dev)
        if dev.type == "cpu":
            return uniform_plain(key, shape, dev)
    raise NotImplementedError(f"rng.uniform: no implementation for {dev}")
