"""The cornell_box configuration on the card: a traced run of its cell
(`cornell_box.pt_nee`: PT with NEE under the reference's per-frame
schedule, NEE's shadow rays on the dense kernel) reads its three
metrics, the roofline in (0, 100] and the fill share in [0, 1].  The CPU
cases of this configuration (the copy's host dict and configuration
against the port's, the program against the replay, the control, the
spans and the readers off the card) are in the repository's
tests/test_torch_cornell_cell.py."""

import math

import pytest
import torch

from harness import cell, program, registry

CELL = "cornell_box.pt_nee"


@pytest.mark.gpu
def test_cornell_metrics_read_on_the_card():
    """A traced run of the cell at 128x128, 1-frame calls: correct, no
    frame cut, and the three metrics read, each in its range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    wl = registry.workload(CELL)
    wl.update(width=128, height=128, frames_per_call=1)
    config = registry.config(wl["config"])
    prog = program.setup(config, wl, torch.device("cuda"))
    cell.warm_up(prog, wl, 1)
    result, _ = cell.run_cell(prog, wl, config, registry.spec(), 2**31 + 13, math.inf, True,
                              0.0, max_calls=4)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["nee_sweep.ms_per_frame"] > 0
    assert 0 < m["nee_sweep_roofline"] <= 100
    assert 0 <= m["pt_compaction.fill_share"] <= 1
