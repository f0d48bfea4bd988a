"""Progressive film: accumulation, tone mapping, checkpoint/resume (twin
of ti_raytrace_tpu/film.py).

The checkpoint npz holds `hdr` (W, H, 3) f32, `frame` int32 and `key`
(2,) uint32 (JAX's raw key data), so either package resumes the other's
checkpoints on the same key chain.
"""

import os
from dataclasses import dataclass

import numpy as np
import torch

from ti_raytrace_tpu_torch.core import rng
from ti_raytrace_tpu_torch.io.image import film_to_image, write_png
from ti_raytrace_tpu_torch.utils.colorsp import tone_map


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


def save_png(film: Film, path: str, exposure: float = 0.5) -> None:
    write_png(path, film_to_image(to_srgb(film, exposure).cpu().numpy()))


def save_checkpoint(film: Film, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(
        path,
        hdr=film.hdr.cpu().numpy(),
        frame=np.asarray(film.frame, np.int32),
        key=film.key.numpy().astype(np.uint32),
    )


def load_checkpoint(path: str, device="cuda") -> Film:
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return Film(
            hdr=torch.as_tensor(z["hdr"], dtype=torch.float32).to(device),
            frame=int(z["frame"]),
            key=torch.as_tensor(z["key"].astype(np.int64)),
        )
