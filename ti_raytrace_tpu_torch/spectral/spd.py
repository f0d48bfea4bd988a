"""Spectral power distribution tables (twin of ti_raytrace_tpu/spectral/spd.py):
host CSV tables with linear interpolation, and the hero-wavelength
machinery: 4 correlated wavelengths lambda_i = lambda0 + i * 100 nm with
lambda0 in [360, 460).

Every SPD an integrator needs is evaluated on the host into a hero matrix
of shape (4, HERO_BINS): column b holds the SPD at the 4 hero wavelengths
of lambda0 bin b (lambda0 is quantised to HERO_BINS bins over the 100 nm
hero window, ~0.2 nm).  At render time a lane's 4-vector is column
`hero_bin(u)` of the matrix: an exact index gather (`hero_select`), where
the reference multiplies by a one-hot matrix.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ti_raytrace_tpu_torch.core import constants as C

N_HERO = C.N_HERO
LAMBDA_MIN = C.LAMBDA_MIN
LAMBDA_MAX = C.LAMBDA_MAX
LAMBDA_STEP = (LAMBDA_MAX - LAMBDA_MIN) / N_HERO  # 100 nm
HERO_BINS = 512


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


def hero_lambdas(lambda0):
    """The 4 correlated wavelengths of a hero lambda0."""
    lambda0 = np.asarray(lambda0, np.float64)
    return lambda0[..., None] + np.arange(N_HERO) * LAMBDA_STEP


def hero_bin_centers():
    """lambda0 value of each hero bin."""
    u = (np.arange(HERO_BINS) + 0.5) / HERO_BINS
    return LAMBDA_MIN + u * LAMBDA_STEP


def hero_matrix(fn) -> np.ndarray:
    """(4, HERO_BINS) matrix of fn(lambda) evaluated at the hero
    wavelengths of every lambda0 bin.  fn maps (K,) lambdas -> (K,)."""
    lam = hero_lambdas(hero_bin_centers())  # (NB, 4)
    return np.asarray(fn(lam.reshape(-1)), np.float64).reshape(HERO_BINS, N_HERO).T


def hero_bin(u):
    """(N,) int64 lambda0 bin of uniform u in [0, 1): truncate, then clamp."""
    return torch.clamp((u * HERO_BINS).to(torch.int32), max=HERO_BINS - 1).long()


def hero_onehot(u):
    """(NB, N) float one-hot of the lambda0 bin of uniform u in [0, 1)
    (the reference's matmul form of hero_bin)."""
    b = hero_bin(u)
    return (torch.arange(HERO_BINS, device=u.device)[:, None] == b[None, :]).to(torch.float32)


def hero_select(matrix, bins):
    """(R, NB) table, (N,) int64 bins -> (R, N) per-lane hero values."""
    return matrix.index_select(1, bins)
