"""The one way into a hand kernel: ops/cuda_build.Launcher, under each of
the five bindings (the cluster tracer, the dense sweep, the threefry
draw, the Disney BSDF, the PT shading).

This file imports neither jax nor the JAX package and needs neither nvcc
nor a card: a fake library, handed in through the launcher's loader,
stands in for the compiled one.  Per binding it checks that the library
is built and loaded at the first launch, once, and never at import; that
every C entry gets its declared argument types and the current raw
stream as its last argument; that the device guard is entered only off
the current device; that a non-zero return raises RuntimeError with the
library's own text; that each launch is counted on the innermost
recording span, the only record of launches; and that the binding's CPU
route loads no library.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.bsdf import planar
from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.integrators import pt_rgb
from ti_raytrace_tpu_torch.ops import cluster_trace as ct
from ti_raytrace_tpu_torch.ops import cuda_build
from ti_raytrace_tpu_torch.ops import dense_trace as dt
from ti_raytrace_tpu_torch.scene.build import MaterialRec, SceneBuilder, sphere_shape
from ti_raytrace_tpu_torch.scene.data import device_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# binding: (module, the module's launcher, the span its dispatch records)
BINDINGS = {
    "cluster_trace": ("ti_raytrace_tpu_torch.ops.cluster_trace", "KERNEL", "trace.kernel"),
    "dense_trace": ("ti_raytrace_tpu_torch.ops.dense_trace", "DENSE_KERNEL",
                    "dense_trace._sweep"),
    "rng": ("ti_raytrace_tpu_torch.core.rng", "UNIFORM_KERNEL", "rng.uniform"),
    "disney": ("ti_raytrace_tpu_torch.bsdf.planar", "DISNEY_KERNEL", "bsdf.disney"),
    "pt_shade": ("ti_raytrace_tpu_torch.integrators.pt_rgb", "SHADE_KERNEL", "pt.shade"),
}
KERNELS = {"cluster_trace": ct.KERNEL, "dense_trace": dt.DENSE_KERNEL,
           "rng": rng.UNIFORM_KERNEL, "disney": planar.DISNEY_KERNEL,
           "pt_shade": pt_rgb.SHADE_KERNEL}

torch.set_num_threads(2)


class FakeLib:
    """A library's stand-in: each C entry of the binding records its
    arguments and returns `status`; the error entry names the code."""

    def __init__(self, binding, status=0):
        self.calls = []
        for name in binding.ENTRIES:
            setattr(self, name, self._entry(name, status))
        setattr(self, binding.ERROR, lambda code: f"fake failure {code}".encode())

    def _entry(self, name, status):
        def entry(*args):
            self.calls.append((name, args))
            return status
        return entry


def fake_binding(name, status=0):
    """A new launcher of the binding's class whose loader hands out a
    FakeLib: (launcher, library, the sources the loader was asked for)."""
    kind = type(KERNELS[name])
    lib = FakeLib(kind, status)
    loads = []

    def loader(source):
        loads.append(source)
        return lib, cuda_build.BuildInfo(f"/fake/{source}", False, 0.0, "")

    return kind(loader=loader), lib, loads


@pytest.fixture
def on_device(monkeypatch):
    """Device 0 is the current one; each index's raw stream is 100 + index;
    `entered` lists the devices whose guard was entered."""
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 100 + index,
                        raising=False)
    return entered


def _args(argtypes):
    """Stand-in arguments for an entry: one per argument type, the stream
    left for the launcher."""
    return tuple(range(1, len(argtypes)))


@pytest.fixture(scope="module")
def imported():
    """The five modules imported in a fresh process with `cuda_build.load`
    replaced by a recorder: per binding, whether it built or loaded
    anything by then."""
    names = json.dumps({k: v[:2] for k, v in BINDINGS.items()})
    code = f"""
import importlib, json
from ti_raytrace_tpu_torch.ops import cuda_build
asked = []
cuda_build.load = lambda source: asked.append(source)
out = {{}}
for name, (module, attr) in json.loads({names!r}).items():
    k = getattr(importlib.import_module(module), attr)
    out[name] = dict(lib=k._lib is None, info=k.build_info is None, source=k.SOURCE)
print(json.dumps(dict(bindings=out, asked=asked)))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", BINDINGS)
def test_no_library_at_import(imported, name):
    """Importing the module builds and loads nothing; the binding's
    default loader is cuda_build.load."""
    got = imported["bindings"][name]
    assert got["lib"] and got["info"] and imported["asked"] == []
    assert got["source"] == KERNELS[name].SOURCE and KERNELS[name]._loader is cuda_build.load


@pytest.mark.parametrize("name", BINDINGS)
def test_library_loads_at_the_first_launch_once(on_device, name):
    """The first launch loads the library, later ones reuse it; each entry
    gets its declared argument types and an int result, the error entry a
    text result, and every call its arguments with the stream appended."""
    k, lib, loads = fake_binding(name)
    assert loads == [] and k._lib is None and k.build_info is None
    device = SimpleNamespace(index=0)
    for _ in range(2):
        for entry, argtypes in k.ENTRIES.items():
            k.launch(entry, device, *_args(argtypes))
    assert loads == [k.SOURCE] and k._lib is lib
    assert k.build_info.path == f"/fake/{k.SOURCE}"
    for entry, argtypes in k.ENTRIES.items():
        fn = getattr(lib, entry)
        assert fn.argtypes == argtypes and fn.restype is cuda_build.I32
        assert argtypes[-1] is cuda_build.PTR  # the stream
    error = getattr(lib, k.ERROR)
    assert error.argtypes == [cuda_build.I32] and error.restype is not cuda_build.I32
    want = [(entry, _args(argtypes) + (100,)) for entry, argtypes in k.ENTRIES.items()]
    assert lib.calls == want * 2
    assert on_device == []  # device 0 is current: no guard


@pytest.mark.parametrize("name", BINDINGS)
def test_device_guard_only_off_the_current_device(on_device, name):
    """A launch on another device than the current one enters that
    device's guard and takes that device's stream."""
    k, lib, _ = fake_binding(name)
    entry, argtypes = next(iter(k.ENTRIES.items()))
    other = SimpleNamespace(index=1)
    k.launch(entry, other, *_args(argtypes))
    assert on_device == [other] and lib.calls[-1][1][-1] == 101


@pytest.mark.parametrize("name", BINDINGS)
def test_launch_counts_on_the_innermost_recording_span(on_device, name):
    """Each launch that returned 0 counts on the innermost recording span
    open at the time, and `metrics.kernel_launches` reads those counts by
    the span's attribute; a failed launch, or one made while nothing
    records, counts nowhere."""
    k, _, _ = fake_binding(name)
    failing, _, _ = fake_binding(name, status=7)
    span = BINDINGS[name][2]
    entry, argtypes = next(iter(k.ENTRIES.items()))
    device = SimpleNamespace(index=0)
    metrics.clear_spans()
    k.launch(entry, device, *_args(argtypes))  # not recording
    with metrics.recording():
        k.launch(entry, device, *_args(argtypes))  # no span open
        with metrics.span("outer"):
            for width, n in ((64, 2), (32, 1), (0, 0)):
                with metrics.span(span, w=width):
                    for _ in range(n):
                        k.launch(entry, device, *_args(argtypes))
                    with pytest.raises(RuntimeError):
                        failing.launch(entry, device, *_args(argtypes))
    records = metrics.spans()
    launched = metrics.kernel_launches(span, "w")
    metrics.clear_spans()
    assert [(r.name, r.launched) for r in records] == [(span, 2), (span, 1), (span, 0),
                                                       ("outer", 0)]
    assert launched == {64: 2, 32: 1}


@pytest.mark.parametrize("name", BINDINGS)
def test_nonzero_return_raises_with_the_library_text(on_device, name):
    k, lib, _ = fake_binding(name, status=7)
    for entry, argtypes in k.ENTRIES.items():
        with pytest.raises(RuntimeError, match=f"{k.SOURCE}: {entry} failed: fake failure 7"):
            k.launch(entry, SimpleNamespace(index=0), *_args(argtypes))
    assert len(lib.calls) == len(k.ENTRIES)


@pytest.fixture(scope="module")
def scene():
    """40 triangles in a row in the z = 0 plane under a sphere light, on
    the CPU."""
    pos = np.zeros((40, 3, 3), np.float32)
    for i in range(40):
        pos[i] = [[2.0 * i, 0.0, 0.0], [2.0 * i + 1.0, 0.0, 0.0], [2.0 * i, 1.0, 0.0]]
    b = SceneBuilder()
    b.add_triangles(pos, np.zeros_like(pos), np.zeros((40, 3, 2), np.float32),
                    MaterialRec(C.MAT_DISNEY, color=(0.5, 0.5, 0.5), p1=0.5))
    b.add_shape(sphere_shape([0.5, 0.25, 4.0], 1.0), MaterialRec(C.MAT_LIGHT, color=(5.0,) * 3))
    return device_scene(b.build_host(), "cpu")


def _rays(n):
    """Rays from z = 3 down through the first triangle, planar (3, n)."""
    uv = np.random.default_rng(3).random((n, 2)) * 0.45 + 0.02
    o = np.stack([uv[:, 0], uv[:, 1], np.full(n, 3.0)]).astype(np.float32)
    d = np.stack([np.zeros(n), np.zeros(n), -np.ones(n)]).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d)


def _cpu_route(name, scene):
    """One call of the binding's dispatch on CPU tensors."""
    o, d = _rays(300)
    if name == "cluster_trace":
        t, prim, _ = ct.trace_clustered(scene, o, d, sort_rays=False, tile_order=True)
        assert bool((prim == 0).all())
    elif name == "dense_trace":
        t, prim = dt.trace_planar(scene, o, d)
        assert bool((prim == 0).all())
    elif name == "rng":
        assert rng.uniform(rng.PRNGKey(1), (8, 300), device="cpu").shape == (8, 300)
    elif name == "disney":
        n = torch.tensor([[0.0], [0.0], [1.0]]).expand(3, 300)
        m, r = torch.full((300,), 0.2), torch.full((300,), 0.5)
        planar.disney_evaluate_pdf(n, -d, -d, m, r)
        planar.disney_sample(torch.rand(3, 300), d, n, m, r)
    else:
        carry = pt_rgb._bounce(scene, pt_rgb._new_carry(o, d), rng.PRNGKey(1), 1)
        assert carry["origin"].device.type == "cpu"


@pytest.mark.parametrize("name", BINDINGS)
def test_cpu_route_loads_no_library(scene, monkeypatch, name):
    """CPU tensors take the binding's plain twin through its dispatch: its
    span records and counts no launch, and no binding asks for a library
    (each one's loaded library, if any, is set aside for the test)."""

    def refuse(source):
        pytest.fail(f"the CPU route asked for {source}")

    for k in KERNELS.values():
        monkeypatch.setattr(k, "_lib", None)
        monkeypatch.setattr(k, "_loader", refuse)
    metrics.clear_spans()
    with metrics.recording():
        _cpu_route(name, scene)
    records = metrics.spans()
    metrics.clear_spans()
    assert BINDINGS[name][2] in {r.name for r in records}
    assert not any(r.launched for r in records)
