"""Monte-Carlo sampling helpers over (..., 3) rows (twin of
ti_raytrace_tpu/utils/sampling.py), cut to the disk map and the power
heuristic.  The planar samplers of the render loop live in ops/planar.py."""

import torch

from reference.plain.core.constants import PI


def map_to_disk(u1, u2):
    """Concentric square -> disk map without data-dependent branches.
    Returns (r, phi)."""
    a = 2.0 * u1 - 1.0
    b = 2.0 * u2 - 1.0
    use_a = torch.abs(a) > torch.abs(b)
    r = torch.where(use_a, torch.abs(a), torch.abs(b))
    safe_a = torch.where(a == 0.0, 1.0, a)
    safe_b = torch.where(b == 0.0, 1.0, b)
    phi = torch.where(
        use_a,
        (PI / 4.0) * (b / safe_a) + torch.where(a < 0.0, PI, 0.0),
        (PI / 4.0) * (2.0 - a / safe_b) + torch.where(b < 0.0, PI, 0.0),
    )
    return r, torch.where(r == 0.0, 0.0, phi)


def power_heuristic(a, b):
    """Veach beta=2 power heuristic: a^2 / (a^2 + b^2), floored at 1e-20."""
    t = a * a
    return t / torch.clamp(b * b + t, min=1e-20)

