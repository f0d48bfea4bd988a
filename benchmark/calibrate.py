"""Readings that the limits of `correct` are set from (see PERF.md):

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--calls 2] [--out readings.json]

One process on the card sets the program up once, then for each of
`--seeds` renders `--calls` calls of the cell's traffic from a fresh film
and compares a call drawn from the seed with the plain reference (the
program's readings, the lower ones), and for each of `--control-seeds`
does the same with the control, the reference in bfloat16
(reference/control.py), in the program's place (the upper readings).
Prints one line per seed and a JSON summary; the benchmark's own runs
never run this.  `--device cpu` at a small `--size` rehearses it.
"""

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(1, os.path.dirname(BENCH))


def readings(prog, wl, config, bench, seeds, calls, ref):
    from harness import cell

    out = {}
    for seed in seeds:
        result, ref = cell.run_cell(prog, wl, config, bench, seed, float("inf"), False, 0.0,
                                    ref=ref, max_calls=calls)
        out[seed] = {k: c["value"] for k, c in result["checks"].items()}
        print(f"seed {seed}: {out[seed]} correct {result['correct']}", flush=True)
    return out, ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--calls", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=None, help="override the resolution")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import cell, program, registry
    from reference import control

    bench = registry.spec()
    wl = registry.workload(args.workload)
    if args.size:
        wl.update(width=args.size, height=args.size)
    config = registry.config(wl["config"])
    dev = torch.device(args.device)
    prog = program.setup(config, wl, dev)
    cell.warm_up(prog, wl, args.seeds[0])
    program_readings, ref = readings(prog, wl, config, bench, args.seeds, args.calls, None)
    del prog
    control_readings = {}
    if args.control_seeds:
        ctl = control.Control(config, wl, dev)
        control_readings, _ = readings(ctl, wl, config, bench, args.control_seeds,
                                       args.calls, ref)
    summary = {"workload": args.workload, "calls": args.calls,
               "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "program": program_readings, "control": control_readings}
    text = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
