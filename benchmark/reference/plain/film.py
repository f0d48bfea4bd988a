"""Progressive film: accumulation and tone mapping (the port's film.py as
the benchmark froze it, without PNG and checkpoint output)."""

from dataclasses import dataclass

import numpy as np
import torch

from reference.plain.core import rng
from reference.plain.utils.colorsp import tone_map


@dataclass(frozen=True)
class Film:
    hdr: torch.Tensor   # (W, H, 3) running mean radiance
    frame: int          # frames accumulated so far
    key: torch.Tensor   # (2,) int64 key for the *next* frame (host)


def new_film(width: int, height: int, seed: int = 0, device="cuda") -> Film:
    return Film(hdr=torch.zeros((width, height, 3), dtype=torch.float32, device=device),
                frame=0, key=rng.PRNGKey(seed))


def accumulate(film: Film, radiance: torch.Tensor) -> Film:
    """Running mean with coff = 1/(frame+1)."""
    coff = 1.0 / (torch.tensor(film.frame, dtype=torch.float32) + 1.0)
    coff = coff.to(film.hdr.device)
    hdr = radiance * coff + film.hdr * (1.0 - coff)
    return Film(hdr=hdr, frame=film.frame + 1, key=rng.split(film.key)[0])


def accumulate_group(film: Film, radiance_sum: torch.Tensor, n: int) -> Film:
    """Fold n frames' summed radiance into the running mean in one step;
    the key advances by the same n splits as n accumulate() calls."""
    f = float(np.float32(film.frame))
    # a device tensor, not a Python scalar: CUDA divides by a host scalar
    # as a multiply by its reciprocal, one rounding off the reference
    denom = torch.tensor(f + n, dtype=torch.float32, device=film.hdr.device)
    hdr = (film.hdr * f + radiance_sum) / denom
    key = film.key
    for _ in range(n):
        key = rng.split(key)[0]
    return Film(hdr=hdr, frame=film.frame + n, key=key)


def to_srgb(film: Film, exposure: float = 0.5) -> torch.Tensor:
    """Tone-mapped (W, H, 3) sRGB film."""
    return tone_map(film.hdr, exposure)
