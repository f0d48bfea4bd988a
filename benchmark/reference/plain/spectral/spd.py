"""Spectral power distribution tables (the port's spectral/spd.py as the
benchmark froze it, cut to what the spectral BDPT reads): host CSV tables
with linear interpolation."""

from dataclasses import dataclass

import numpy as np


@dataclass
class Spd:
    """Host-side SPD: regular wavelength grid + linear interpolation."""
    lambdas: np.ndarray  # (S,)
    values: np.ndarray   # (S,)

    @property
    def lambda_min(self):
        return float(self.lambdas[0])

    @property
    def lambda_max(self):
        return float(self.lambdas[-1])

    @property
    def step(self):
        return (self.lambda_max - self.lambda_min) / (len(self.values) - 1)

    def sample(self, lam):
        """Linear interpolation at lam (nm), 0 outside the table."""
        lam = np.asarray(lam, np.float64)
        inside = (lam >= self.lambda_min) & (lam <= self.lambda_max)
        off = (lam - self.lambda_min) / self.step
        idx = np.clip(off.astype(np.int64), 0, len(self.values) - 2)
        w = off - idx
        v = self.values[idx] * (1 - w) + self.values[idx + 1] * w
        return np.where(inside, v, 0.0)

    def scale(self, coeff: float):
        self.values = self.values * coeff


def load_spd_csv(path: str) -> Spd:
    """Two-column CSV: wavelength, value."""
    lams, vals = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 2 or not parts[0]:
                continue
            lams.append(float(parts[0]))
            vals.append(float(parts[1]))
    return Spd(np.asarray(lams, np.float64), np.asarray(vals, np.float64))
