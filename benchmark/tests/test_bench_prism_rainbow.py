"""The prism_rainbow configuration on the card: a traced run of its cell
(`prism_rainbow.bdpt_spec`: spectral BDPT, the reference's walk
compaction, the shadow batch capped at 0.09 on the dense kernel) reads
its five metrics, the shares in [0, 1] and the roofline at most 100%.
The CPU cases of this configuration (the copy's host dict and
configuration against the port's, the program against the replay, the
control, the spans and the readers off the card) are in the repository's
tests/test_torch_prism_cell.py."""

import math

import pytest
import torch

from harness import cell, program, registry

CELL = "prism_rainbow.bdpt_spec"
SHARES = ("shadow_sweep.culled_share", "shadow_cap.fill_share", "walk_compaction.fill_share")


@pytest.mark.gpu
def test_prism_metrics_read_on_the_card():
    """A traced run of the cell at 128x128, 1-frame calls: correct, no
    frame cut, and the five metrics read, each in its range."""
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
    assert m["shadow_sweep.ms_per_frame"] > 0
    assert 0 < m["shadow_sweep_roofline"] <= 100
    for name in SHARES:
        assert 0 <= m[name] <= 1, name
