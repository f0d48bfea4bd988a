"""RGB -> reflectance-spectrum upsampling, Jakob & Hanika 2019 (the port's
spectral/rgb2spec.py as the benchmark froze it): a reflectance spectrum
is a smooth sigmoid of a quadratic in wavelength, and a 3 x 64^3
coefficient table maps linear RGB to (c0, c1, c2).

`fetch` runs on the host (scene/packs.py bakes per-material coefficients
into the packed attribute tables); `eval_hero` is the sigmoid on device
lanes, what the spectral BDPT evaluates.  The table is read from
assets/spec_table.npz and never fitted here: a missing file raises.
"""

from dataclasses import dataclass

import numpy as np
import torch

from reference.plain.io.assets import asset_path


@dataclass
class Rgb2SpecTable:
    res: int
    scale: np.ndarray  # (res,) the non-uniform z lattice
    data: np.ndarray   # (3, res, res, res, 3): [maxcomp, z, y, x, coeff]

    def fetch(self, rgb: np.ndarray) -> np.ndarray:
        """Linear RGB (..., 3) in [0, 1] -> sigmoid coefficients (..., 3)
        in nanometre lambda units: max-component reordering, interval
        lookup on the z lattice, trilinear interpolation."""
        rgb = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0)
        flat = rgb.reshape(-1, 3)
        rows = np.arange(len(flat))
        k = np.argmax(flat, axis=-1)
        z = np.maximum(flat[rows, k], 1e-5)
        a = flat[rows, (k + 1) % 3]
        b = flat[rows, (k + 2) % 3]
        s = (self.res - 1) / z
        x = a * s
        y = b * s

        xi = np.minimum(x.astype(np.int64), self.res - 2)
        yi = np.minimum(y.astype(np.int64), self.res - 2)
        zi = np.clip(np.searchsorted(self.scale, z, side="right") - 1, 0, self.res - 2)

        x0 = x - xi
        y0 = y - yi
        z0 = (z - self.scale[zi]) / (self.scale[zi + 1] - self.scale[zi])

        def corner(dz, dy, dx):
            return self.data[k, zi + dz, yi + dy, xi + dx]  # (n, 3)

        def lerp(c0, c1, t):
            return c0 * (1 - t)[:, None] + c1 * t[:, None]

        out = lerp(
            lerp(lerp(corner(0, 0, 0), corner(0, 0, 1), x0),
                 lerp(corner(0, 1, 0), corner(0, 1, 1), x0), y0),
            lerp(lerp(corner(1, 0, 0), corner(1, 0, 1), x0),
                 lerp(corner(1, 1, 0), corner(1, 1, 1), x0), y0),
            z0,
        )
        return out.reshape(rgb.shape)


def eval_hero(c0, c1, c2, lam):
    """The sigmoid on device lanes: coefficient rows (N,), lam (K, N) or
    (N,) -> spectrum values of lam's shape."""
    x = (c0 * lam + c1) * lam + c2
    return 0.5 * x * torch.rsqrt(x * x + 1.0) + 0.5


def load_table(path: str | None = None) -> Rgb2SpecTable:
    """The coefficient table of `path` (default: assets/spec_table.npz)."""
    with np.load(path or asset_path("spec_table.npz")) as z:
        return Rgb2SpecTable(int(z["res"]), z["scale"], z["data"])
