"""Find a cell's files by name: the configuration
(`configs/<name>.json`), the workload (`workloads/<name>.json`), each
metric's reader (`metrics/<name>.py`) and the metrics that BENCHMARK.json
gives the cell.  A later cell, configuration or metric is new files and
new entries; nothing here names one."""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


def spec(root=ROOT) -> dict:
    """BENCHMARK.json at the root of the checkout."""
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, bench_dir=BENCH_DIR) -> dict:
    """The workload file of cell `name`, with its name."""
    return dict(_json(os.path.join(bench_dir, "workloads", name + ".json")), name=name)


def config(name: str, bench_dir=BENCH_DIR) -> dict:
    """The configuration file `name`, with its name."""
    return dict(_json(os.path.join(bench_dir, "configs", name + ".json")), name=name)


def reader(name: str, bench_dir=BENCH_DIR):
    """The `read(record)` function of metric `name` (metrics/<name>.py; a
    name may hold dots, so the file is loaded by path)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"),
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of BENCHMARK.json's `kind` ("end_to_end" or
    "per_layer") that cell `cell` reports: those whose `workloads` list
    names it, or that have no such list."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]
