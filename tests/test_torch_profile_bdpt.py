"""The profiling tools' op counter (tools/profile_bdpt.count_ops): a call
is charged to the innermost open span of the program, attribute reads
are not counted, and nothing is left recording afterwards; on BDPT's
splat and on the path tracer's bounce loop."""

from types import SimpleNamespace

import pytest
import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.integrators import bdpt_rgb, pt_rgb
from ti_raytrace_tpu_torch.tools import profile_bdpt


def _bdpt():
    flat = torch.zeros((8, 3))

    def render():
        px = torch.arange(4) % 2  # two calls, outside every span
        _ = px.shape  # an attribute read: not counted
        bdpt_rgb._splat_add(flat, px, torch.ones((4, 3)))  # one call outside, the rest inside

    def check(counts):
        assert counts[profile_bdpt.OTHER] == 3
        assert counts["bdpt.splat"] > 0 and set(counts) == {"bdpt.splat", profile_bdpt.OTHER}
        assert flat[:2].sum().item() == 12.0 and flat[2:].sum().item() == 0.0

    return render, check


def _pt():
    scene = SimpleNamespace(mat_type=torch.tensor([0, 1, 2]))
    carry = dict(alive=torch.tensor([False, True]))

    def render():
        assert pt_rgb._any_alive(carry)  # .any() and bool(): two calls in sync.alive
        pt_rgb.has_nee_materials(scene)  # .cpu() in the span, the test after it outside
        torch.zeros(2)

    def check(counts):
        assert counts["sync.alive"] == 2 and counts["sync.nee_materials"] == 1
        assert counts[profile_bdpt.OTHER] >= 2
        assert set(counts) == {"sync.alive", "sync.nee_materials", profile_bdpt.OTHER}

    return render, check


@pytest.mark.parametrize("case", [_bdpt, _pt], ids=["bdpt_rgb", "pt_rgb"])
def test_count_ops_charges_innermost_section(case):
    render, check = case()
    counts = profile_bdpt.count_ops(render)
    check(counts)
    n = len(metrics.spans())
    with metrics.span("after"):
        pass
    assert metrics.current_span() is None and len(metrics.spans()) == n
