"""The BDPT profiling tool's op counter (tools/profile_bdpt.py): a call is
charged to the innermost open section, attribute reads are not counted,
and bdpt_rgb's functions are restored afterwards."""

import torch

from ti_raytrace_tpu_torch.integrators import bdpt_rgb
from ti_raytrace_tpu_torch.tools import profile_bdpt


def test_count_ops_charges_innermost_section():
    before = {n: getattr(bdpt_rgb, n) for names in profile_bdpt.SECTIONS.values()
              for n in names}
    flat = torch.zeros((8, 3))

    def render():
        px = torch.arange(4) % 2  # two calls, outside every section
        _ = px.shape  # an attribute read: not counted
        bdpt_rgb._splat_add(flat, px, torch.ones((4, 3)))  # one call outside, the rest inside

    counts = profile_bdpt.count_ops(render)
    assert counts[profile_bdpt.OTHER] == 3
    assert counts["splat"] > 0
    assert sum(v for k, v in counts.items() if k not in ("splat", profile_bdpt.OTHER)) == 0
    assert flat[:2].sum().item() == 12.0 and flat[2:].sum().item() == 0.0
    assert all(getattr(bdpt_rgb, n) is fn for n, fn in before.items())
