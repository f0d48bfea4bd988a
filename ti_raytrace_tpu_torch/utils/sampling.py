"""Monte-Carlo sampling helpers (twin of ti_raytrace_tpu/utils/sampling.py,
the function the NEE path calls).  The planar samplers live in
ops/planar.py."""

import torch


def power_heuristic(a, b):
    """Veach beta=2 power heuristic: a^2 / (a^2 + b^2), floored at 1e-20."""
    t = a * a
    return t / torch.clamp(b * b + t, min=1e-20)
