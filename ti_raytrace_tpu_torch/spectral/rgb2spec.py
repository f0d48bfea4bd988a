"""RGB -> reflectance-spectrum upsampling, Jakob & Hanika 2019 (twin of
ti_raytrace_tpu/spectral/rgb2spec.py): a reflectance spectrum is a smooth
sigmoid of a quadratic in wavelength, and a 3 x 64^3 coefficient table
maps linear RGB to (c0, c1, c2).

`fetch` runs on the host: materials are few, so scene/build.py bakes
per-material coefficients into the packed attribute tables
(scene/packs.py) and the render loop never touches the table.
`eval_hero` is the sigmoid on device lanes, what the spectral integrators
evaluate.  The table is read from
assets/spec_table.npz; where it is missing, `load_table` fits it
(spectral/jakob_fit.py, ~1 minute) and writes it there.
"""

import os
from dataclasses import dataclass

import numpy as np
import torch

N_COEFFS = 3
RES = 64

TABLE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
    "spec_table.npz",
)


def smoothstep(x):
    return x * x * (3.0 - 2.0 * x)


def scale_lattice(res: int = RES) -> np.ndarray:
    """The non-uniform z lattice: smoothstep(smoothstep(i / (res - 1)))."""
    return smoothstep(smoothstep(np.arange(res, dtype=np.float64) / (res - 1)))


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


def eval_np(coeffs, lam):
    """sigmoid(c0 lam^2 + c1 lam + c2), lam in nm (host numpy)."""
    c = np.asarray(coeffs, np.float64)
    x = (c[..., 0] * lam + c[..., 1]) * lam + c[..., 2]
    return 0.5 * x / np.sqrt(x * x + 1.0) + 0.5


def eval_hero(c0, c1, c2, lam):
    """The sigmoid on device lanes: coefficient rows (N,), lam (K, N) or
    (N,) -> spectrum values of lam's shape."""
    x = (c0 * lam + c1) * lam + c2
    return 0.5 * x * torch.rsqrt(x * x + 1.0) + 0.5


def save_table(table: Rgb2SpecTable, path: str) -> None:
    """Write `table` as the npz that load_table reads (atomically)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"  # np.savez_compressed appends .npz
    np.savez_compressed(tmp, res=table.res, scale=table.scale, data=table.data)
    os.replace(tmp, path)


def load_table(path: str | None = None, generate: bool = True) -> Rgb2SpecTable:
    """The coefficient table of `path` (default: assets/spec_table.npz).
    A missing file is fitted at RES (spectral/jakob_fit.fit_table) and
    written there with generate=True, and raises FileNotFoundError with
    generate=False."""
    p = path or TABLE_PATH
    if os.path.exists(p):
        with np.load(p) as z:
            return Rgb2SpecTable(int(z["res"]), z["scale"], z["data"])
    if not generate:
        raise FileNotFoundError(f"{p}: the rgb2spec coefficient table is missing")
    from ti_raytrace_tpu_torch.spectral.jakob_fit import fit_table

    table = fit_table(RES)
    save_table(table, p)
    return table


def load_reference_format(path: str) -> Rgb2SpecTable:
    """Read the text format of the original renderer's spec_table: res,
    then res scale lines, then res^3 * 3 lines of 9 floats (three
    coefficient triples a line)."""
    with open(path) as f:
        res = int(f.readline())
        scale = np.array([float(f.readline()) for _ in range(res)])
        vals = np.loadtxt(f).reshape(-1)[: res * res * res * 9]
    return Rgb2SpecTable(res, scale, vals.reshape(3, res, res, res, 3))
