"""One run of one benchmark cell of ti_raytrace_tpu_torch:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints the checks against the plain reference as the last lines of
standard error and one JSON object as the last line of standard output:
`correct`, `attempted` (frames rendered in the window), `failed` (frames
of calls that reported overflow), `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics), `device`, with
--trace 1 `breakdown`, and last `checks`.  Exits non-zero without a
result when CUDA or the cell's cards are missing, and when JAX or the JAX
package was loaded.  See benchmark/README.md.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# every build and kernel cache of the run at a fixed path inside the
# checkout (the program's own kernels and scenes go to ROOT/.cache too)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".cache", "triton")
os.environ["USE_FLAX"] = "0"
# one process with few threads: the program dispatches from one host
# thread, and idle intra-op worker threads only contend for the cores
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(1, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import cell, program, registry

    bench = registry.spec()
    entry = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    wl = registry.workload(args.workload)
    config = registry.config(wl["config"])
    t_imported = time.perf_counter()
    prog = program.setup(config, wl, torch.device("cuda", 0))
    t_scene = time.perf_counter()
    cell.warm_up(prog, wl, args.seed)
    setup_s = time.perf_counter() - T0
    print(f"set-up {setup_s:.3f} s: imports {t_imported - T0:.3f}, scene and camera "
          f"{t_scene - t_imported:.3f}, warm-up call {T0 + setup_s - t_scene:.3f}",
          file=sys.stderr)
    result, _ = cell.run_cell(prog, wl, config, bench, args.seed, args.seconds,
                              bool(args.trace), setup_s, chips=entry["chips"])
    loaded = cell.jax_loaded()
    if loaded:
        print(f"JAX or the JAX package was loaded: {', '.join(loaded)}", file=sys.stderr)
        return 4
    cell.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
