"""CIE 1931 observer + standard illuminants, host-side tables (the port's
spectral/cie.py as the benchmark froze it): the colorimetry CSVs under
assets/spectrum/, the reference's 3/8-Simpson white-point quadrature and
the Y-normalisation of the illuminant; with the XYZ -> linear sRGB
matrix of the port's core/constants.py, which the frozen constants lack.
"""

from dataclasses import dataclass

import numpy as np

from reference.plain.io.assets import asset_path
from reference.plain.spectral.spd import Spd, load_spd_csv

# XYZ -> linear sRGB (the reference's matrix, rows r, g, b)
XYZ_TO_SRGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)


@dataclass
class CieSensor:
    lambdas: np.ndarray  # (S,)
    xyz: np.ndarray      # (S, 3)

    @property
    def lambda_min(self):
        return float(self.lambdas[0])

    @property
    def lambda_max(self):
        return float(self.lambdas[-1])

    @property
    def step(self):
        return (self.lambda_max - self.lambda_min) / (len(self.lambdas) - 1)

    def sample(self, lam):
        """(K,) lambdas -> (K, 3) xyz bar values, 0 outside the range."""
        lam = np.asarray(lam, np.float64)
        inside = (lam >= self.lambda_min) & (lam <= self.lambda_max)
        off = (lam - self.lambda_min) / self.step
        idx = np.clip(off.astype(np.int64), 0, len(self.lambdas) - 2)
        w = (off - idx)[..., None]
        v = self.xyz[idx] * (1 - w) + self.xyz[idx + 1] * w
        return np.where(inside[..., None], v, 0.0)


def load_cie_sensor(path: str | None = None) -> CieSensor:
    path = path or asset_path("spectrum/ciexyz31_1.csv")
    lams, rows = [], []
    with open(path) as f:
        for line in f:
            p = line.strip().split(",")
            if len(p) < 4 or not p[0]:
                continue
            lams.append(float(p[0]))
            rows.append([float(p[1]), float(p[2]), float(p[3])])
    return CieSensor(np.asarray(lams, np.float64), np.asarray(rows, np.float64))


def load_d65() -> Spd:
    return load_spd_csv(asset_path("spectrum/Illuminantd65.csv"))


def simpson38_weights(n: int, lambda_min: float, lambda_max: float) -> np.ndarray:
    """The reference's 3/8-rule weight pattern."""
    h = (lambda_max - lambda_min) / (n - 1)
    w = np.full(n, 3.0 / 8.0 * h)
    i = np.arange(n)
    inner = (i != 0) & (i != n - 1)
    return np.where(inner & ((i - 1) % 3 == 2), w * 2.0, np.where(inner, w * 3.0, w))


def white_point(sensor: CieSensor, illuminant: Spd) -> np.ndarray:
    """The illuminant integrated through the observer."""
    w = simpson38_weights(len(sensor.lambdas), sensor.lambda_min, sensor.lambda_max)
    ill = illuminant.sample(sensor.lambdas)
    return (sensor.xyz * (ill * w)[:, None]).sum(axis=0)


def normalized_d65(sensor: CieSensor | None = None) -> Spd:
    """D65 scaled so that its white point has Y = 1."""
    sensor = sensor or load_cie_sensor()
    d65 = load_d65()
    wp = white_point(sensor, d65)
    d65.scale(1.0 / float(wp[1]))
    return d65
