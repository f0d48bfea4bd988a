"""Instruction counts of csrc/dense_trace.cu's parts, read from its SASS.

    python -m ti_raytrace_tpu_torch.tools.sass [--out sass.json]

The dense kernel's bound of the work it did (tools/dense_sweep.py) needs
the instructions of each of its parts: a row test against a triangle and
against a sphere, the slab test, the grazing guard's threshold and its
test per row, and the per-lane set-up.  They are counted here, not by
hand: a probe source includes csrc/dense_trace.cu and wraps each part's
device function (`test_row`, `slab_rejects`, `guard_threshold` with its
vote's comparison, `grazes`, `make_lane`) in a kernel of its own that
reads the part's inputs from global memory and writes its outputs (a
row's kind is a compile-time constant there, so each row probe holds one
branch of `test_row`).  nvcc builds the probes for sm_90a with the
kernels' own flags (ops/cuda_build.NVCC_FLAGS) into a cubin, and
`cuobjdump -sass` lists them.  Each probe is counted along its shortest
path from entry to EXIT (`paths`: each conditional forward branch taken
and not; a path into a subroutine or past the EXIT, the slow paths of
IEEE division and square root, dropped): a triangle row that misses
skips the reciprocal of an accepted hit.  Each opcode counts on the pipe
that runs it:

  fma   FADD, FMUL, FFMA (and their immediate forms)       128 per clock per SM
  alu   FP32 compare/min/max/select, integer and logic ops  64
  imad  IMAD, IMUL (an IMAD.MOV is a move)                   64
  xu    MUFU (reciprocal, square root), conversions          16

Loads, stores, moves, votes, barriers and control flow are not
operations on the inputs and are left out (`skipped`); an opcode outside
these lists counts at the issue rate only (`other`).  An SM issues 128
instructions per clock in all, so a part's count N_c per class c costs
at least max(sum N / 128, N_alu / 64, N_imad / 64, N_xu / 16) clocks
per lane and SM (`clocks`).  The pipe of each opcode follows Nsight
Compute's pipe names (FP32 compares, min/max and selects on the ALU, as
on Ampere); the card offers no counter here to check it.  Needs nvcc and
cuobjdump.
"""

import argparse
import collections
import functools
import json
import os
import re
import subprocess

from ti_raytrace_tpu_torch.ops import cuda_build
from ti_raytrace_tpu_torch.tools.kernel_wavefronts import ISSUE_PER_CLOCK

RATE = {"fma": 128, "alu": 64, "imad": 64, "xu": 16}  # per clock per SM
PIPE = {
    "fma": ("FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I", "FSWZADD"),
    "alu": ("FMNMX", "FSETP", "FSET", "FSEL", "FCHK", "ISETP", "IADD3", "IADD", "IMNMX",
            "VIMNMX", "IABS", "LOP3", "LOP", "SHF", "SHL", "SHR", "SEL", "PLOP3", "P2R",
            "R2P", "LEA", "PRMT", "BMSK", "BREV", "FLO"),
    "imad": ("IMAD", "IMUL", "IMAD32I", "IMUL32I"),
    "xu": ("MUFU", "F2I", "I2F", "F2F", "FRND", "I2I", "POPC"),
}
_CLASS = {op: c for c, ops in PIPE.items() for op in ops}
SKIP = ("MOV", "LDG", "STG", "LDS", "STS", "LDC", "ULDC", "LDL", "STL", "LD", "ST", "S2R",
        "S2UR", "CS2R", "BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BSSY", "BSYNC",
        "WARPSYNC", "BAR", "NOP", "VOTE", "VOTEU", "SHFL", "MEMBAR", "ERRBAR", "DEPBAR",
        "YIELD", "ATOM", "ATOMG", "ATOMS", "RED", "REDUX", "PMTRIG", "UMOV", "UIADD3",
        "ULOP3", "USHF", "ULEA", "UISETP", "USEL", "UIMAD", "R2UR", "BPT", "KILL", "CCTL")

# the probes: each reads its inputs from `in` (a Lane's 13 fields at 0:13,
# a box or a row from 16) and writes what the part computes
PROBES = r"""
#include "dense_trace.cu"

__device__ __forceinline__ float4 ld4(const float* p) {
    return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ Lane lane_in(const float* in) {
    Lane L;
    L.ox = in[0]; L.oy = in[1]; L.oz = in[2];
    L.dx = in[3]; L.dy = in[4]; L.dz = in[5];
    L.a4 = in[6]; L.a2 = in[7]; L.dn = in[8];
    L.ix = in[9]; L.iy = in[10]; L.iz = in[11];
    return L;
}

template <int KIND>
__device__ __forceinline__ void probe_row(const float* in, const int* ini, float* out,
                                          int* outi) {
    const Lane L = lane_in(in);
    const float kind = KIND == 1 ? KIND_TRI : KIND_SPHERE;
    const float4 row[ROW_F4] = {ld4(in + 16), ld4(in + 20),
                                make_float4(in[24], kind, in[26], in[27]), ld4(in + 28)};
    float best_t = in[32];
    int best_prim = ini[0];
    test_row(row, L, best_t, best_prim);
    out[0] = best_t;
    outi[0] = best_prim;
}

extern "C" __global__ void probe_triangle(const float* in, const int* ini, float* out,
                                          int* outi) {
    probe_row<1>(in, ini, out, outi);
}

extern "C" __global__ void probe_sphere(const float* in, const int* ini, float* out,
                                        int* outi) {
    probe_row<2>(in, ini, out, outi);
}

extern "C" __global__ void probe_slab(const float* in, int* outi) {
    outi[0] = slab_rejects(ld4(in + 16), ld4(in + 20), lane_in(in));
}

extern "C" __global__ void probe_guard(const float* in, float* out, int* outi) {
    const Lane L = lane_in(in);
    const float thr = guard_threshold(ld4(in + 20), ld4(in + 24), L);
    out[0] = thr;
    outi[0] = thr > L.dn * in[28];
}

extern "C" __global__ void probe_graze(const float* in, int* outi) {
    const float4 row[ROW_F4] = {ld4(in + 16), ld4(in + 20), ld4(in + 24), ld4(in + 28)};
    outi[0] = grazes(row, lane_in(in), in[32]);
}

extern "C" __global__ void probe_lane(const float* in, float* out) {
    const Lane L = make_lane(in[0], in[1], in[2], in[3], in[4], in[5]);
    out[0] = L.a4; out[1] = L.a2; out[2] = L.dn;
    out[3] = L.ix; out[4] = L.iy; out[5] = L.iz;
}
"""
PARTS = {"triangle": "probe_triangle", "sphere": "probe_sphere", "slab": "probe_slab",
         "guard": "probe_guard", "graze": "probe_graze", "lane": "probe_lane"}
KERNEL = "dense_sweep_kernel"

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_]*)([.A-Z0-9_]*)"
                   r"\s*([^;]*);")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\s*$")


def parse(listing: str) -> dict:
    """cuobjdump -sass text -> {function: (instructions, labels)}: each
    instruction (address, predicated, opcode, modifiers, operands), labels
    {name: address}."""
    out, name = {}, None
    pending = []
    for line in listing.splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            out[name] = ([], {})
            pending = []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            insns, labels = out[name]
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2) is not None, m.group(3), m.group(4), m.group(5)))
    return out


def pipe_of(op: str, mods: str) -> str:
    if op == "IMAD" and mods.startswith(".MOV"):
        return "skipped"
    if op in SKIP:
        return "skipped"
    return _CLASS.get(op, "other")


def _target(args: str, labels: dict):
    """A branch's target address: a label (`(.L_x_3)) or an address."""
    m = _TARGET.search(args)
    if m is None:
        return None
    return labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)


def paths(insns, labels, limit: int = 4096) -> list:
    """Counts by pipe along every path from the first instruction to the
    body's EXIT (its first unpredicated one): each conditional forward
    branch within the body taken and not, unconditional ones followed.  A
    path that calls a subroutine or branches past the EXIT (the slow
    paths of IEEE division and square root) is dropped."""
    index = {a: i for i, (a, *_) in enumerate(insns)}
    end = next(a for a, pred, op, *_ in insns if op == "EXIT" and not pred)
    out, stack = [], [(0, collections.Counter())]
    while stack:
        i, counts = stack.pop()
        while True:
            addr, pred, op, mods, args = insns[i]
            counts[pipe_of(op, mods)] += 1
            if op == "CALL" or (op == "EXIT" and not pred):
                if op == "EXIT":
                    out.append(counts)
                break
            target = _target(args, labels) if op == "BRA" else None
            if target is not None:
                if target <= addr:
                    raise RuntimeError("sass: a backward branch in a probe")
                if target <= end:
                    if not pred:
                        i = index[target]
                        continue
                    stack.append((index[target], counts.copy()))
                elif not pred:
                    break  # leaves the body
            i += 1
        if len(out) + len(stack) > limit:
            raise RuntimeError("sass: too many paths in a probe")
    return out


def path_counts(insns, labels) -> dict:
    """The shortest of `paths` (fewest instructions outside `skipped`), by
    pipe: the part's work when no optional block runs (a triangle row
    that misses)."""
    best = min(paths(insns, labels), key=lambda c: sum(n for k, n in c.items()
                                                       if k != "skipped"))
    return {k: best.get(k, 0) for k in (*RATE, "other")}


def clocks(counts: dict) -> float:
    """The least SM clocks per lane of `counts` (by pipe): the issue rate
    over all of them, each pipe's rate over its own."""
    total = sum(counts.values())
    return max(total / ISSUE_PER_CLOCK, *(counts.get(c, 0) / r for c, r in RATE.items()))


def _cuobjdump() -> str:
    path = os.path.join(os.path.dirname(cuda_build.find_nvcc()), "cuobjdump")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"cuobjdump not found beside nvcc ({path})")
    return path


@functools.lru_cache(maxsize=None)
def dense_listing() -> str:
    """The probes' and the kernel's SASS (cuobjdump -sass), the probe
    cubin built into cuda_build.BUILD_DIR, named by the source's hash."""
    import hashlib

    with open(os.path.join(cuda_build.CSRC, "dense_trace.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + PROBES.encode()
                                + " ".join(cuda_build.NVCC_FLAGS).encode()).hexdigest()
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    stem = os.path.join(cuda_build.BUILD_DIR, f"dense_probes-{digest[:16]}")
    cubin = stem + ".cubin"
    if not os.path.exists(cubin):
        src = stem + ".cu"
        with open(src, "w") as f:
            f.write(PROBES)
        flags = [f for f in cuda_build.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        tmp = f"{cubin}.{os.getpid()}.tmp"
        proc = subprocess.run([cuda_build.find_nvcc(), *flags, "-cubin", "-I", cuda_build.CSRC,
                               "-o", tmp, src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the dense probes:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, cubin)
    proc = subprocess.run([_cuobjdump(), "-sass", cubin], capture_output=True, text=True,
                          check=True)
    return proc.stdout


@functools.lru_cache(maxsize=None)
def dense_counts() -> dict:
    """{part: {pipe: instructions}} for PARTS, from `dense_listing`, and
    under "kernel" the kernel's whole listing by pipe (every instruction
    once, whatever runs it: a static count, for context)."""
    funcs = parse(dense_listing())
    out = {}
    for part, fn in PARTS.items():
        insns, labels = funcs[fn]
        out[part] = path_counts(insns, labels)
    name = next(f for f in funcs if KERNEL in f)  # C++-mangled
    kernel = collections.Counter(pipe_of(op, mods) for _, _, op, mods, _ in funcs[name][0])
    out["kernel"] = dict(sorted(kernel.items()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the counts and the listing as JSON")
    args = ap.parse_args(argv)
    counts = dense_counts()
    for part, c in counts.items():
        extra = "" if part == "kernel" else f"; {clocks(c):.4f} clocks per lane and SM"
        print(f"{part}: {json.dumps(c)}{extra}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(counts=counts, listing=dense_listing()), f, indent=1)


if __name__ == "__main__":
    main()
