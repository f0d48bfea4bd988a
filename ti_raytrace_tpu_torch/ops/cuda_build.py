"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into a shared library with a plain C
interface and loaded with ctypes.  The library is built at first use
into `<repo>/.cache/torch_kernels/` (a directory .gitignore lists), named
by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  nvcc's own error text is raised as is.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".cache", "torch_kernels")

# -fmad=false: no fused multiply-adds, so every product rounds on its own
# as in the plain PyTorch versions the kernels are held against.
# -Xptxas -v: registers, shared memory and spills land in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class BuildInfo:
    """Where a library came from: path, whether this process compiled it,
    the compile's wall time and nvcc's output (kept beside the library as
    <name>.log, so a reused library still reports its registers; empty if
    that log is gone)."""

    def __init__(self, path: str, built: bool, seconds: float, log: str):
        self.path, self.built, self.seconds, self.log = path, built, seconds, log


def _text_with_headers(src: str) -> bytes:
    """The source's bytes followed by those of each csrc/ header it
    includes by `#include "name"` (one level), so that an edited header
    gives its includers a new hash.  A source without such includes hashes
    as its bytes alone."""
    with open(src, "rb") as f:
        text = f.read()
    for name in re.findall(rb'^\s*#include\s+"([^"]+)"', text, re.M):
        with open(os.path.join(CSRC, name.decode()), "rb") as f:
            text += f.read()
    return text


def build(source: str) -> BuildInfo:
    """Compile csrc/<source> unless a library of the same hash exists."""
    src = os.path.join(CSRC, source)
    digest = hashlib.sha256(_text_with_headers(src) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}-{digest[:16]}.so")
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        return BuildInfo(out, False, 0.0, log)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    log = proc.stderr + proc.stdout
    with open(log_path, "w") as f:  # written before the library appears
        f.write(log)
    os.replace(tmp, out)  # atomic publish: a torn library is never loaded
    return BuildInfo(out, True, seconds, log)


def load(source: str):
    """(ctypes.CDLL, BuildInfo) for csrc/<source>, building it if needed."""
    info = build(source)
    return ctypes.CDLL(info.path), info
