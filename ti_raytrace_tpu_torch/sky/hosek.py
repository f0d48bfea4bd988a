"""Hosek-Wilkie full-spectral sky dome (twin of ti_raytrace_tpu/sky/hosek.py).

Host side: the coefficient CSVs under assets/sky/ and the quintic-Bezier
interpolation over (turbidity, albedo, solar elevation) into 9 config
parameters + a radiance scale per spectral band (11 bands, 320-720 nm at
40 nm), with numpy oracles of the radiance formula.

Device side: `sky_radiance_hero`, the F(theta, gamma) sky radiance with
linear interpolation between the two neighbouring bands, over planar
wavefronts.  The per-band values are computed densely (11 bands of
elementwise math); each wavelength row then reads its two bands by an
index gather, where the reference sums over one-hot masks.  The solar
disc's limb-darkened radiance is a host oracle only
(`solar_disc_radiance_np`): it is off the render path, as in the
reference.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ti_raytrace_tpu_torch.io.assets import asset_path

PI = float(np.pi)
N_BANDS = 11
ALBEDO_NUM = 2
TURB_NUM = 10
THETA_NUM = 9
GAMMA_NUM = 6
MIN_LAMBDA = 320.0
MAX_LAMBDA = 720.0
BAND_STEP = 40.0
PIECES = 45
ORDER = 4


def _load_csv(rel, cols):
    out = np.zeros((N_BANDS, cols), np.float64)
    with open(asset_path(rel)) as f:
        for i, line in enumerate(f):
            vals = line.strip().split(",")
            out[i, :cols] = [float(v) for v in vals[:cols]]
    return out


def _bezier5(t, a):
    """Quintic Bezier along axis -1 of a (..., 6) coefficient stack."""
    s = 1.0 - t
    w = np.array(
        [s**5, 5 * s**4 * t, 10 * s**3 * t**2, 10 * s**2 * t**3, 5 * s * t**4, t**5]
    )
    return np.tensordot(a, w, axes=([a.ndim - 1], [0]))


@dataclass
class SkyModel:
    configs: np.ndarray     # (11, 9)
    radiances: np.ndarray   # (11,)
    sun_dir: np.ndarray     # (3,)
    turbidity: float
    albedo: float
    elevation: float
    solar_radius: float = 0.51 * PI / 180.0 / 2.0


def build_sky(turbidity=3.0, albedo=0.5, elevation=10.0 * PI / 180.0) -> SkyModel:
    """The per-band config and radiance parameters of one sky."""
    data = _load_csv("sky/data.csv", TURB_NUM * ALBEDO_NUM * THETA_NUM * GAMMA_NUM)
    data_rad = _load_csv("sky/data_rad.csv", TURB_NUM * ALBEDO_NUM * 6)

    it = int(turbidity)
    rem = turbidity - it
    se = (elevation / (PI / 2.0)) ** (1.0 / 3.0)

    def cfg_block(base):
        """(11, 9) Bezier-interpolated config from a 9 * 6 block."""
        idx = base + np.arange(THETA_NUM)[None, :, None] + 9 * np.arange(6)[None, None, :]
        block = data[np.arange(N_BANDS)[:, None, None], idx]  # (11, 9, 6)
        return _bezier5(se, block)

    configs = (1.0 - albedo) * (1.0 - rem) * cfg_block(9 * 6 * (it - 1))
    configs += albedo * (1.0 - rem) * cfg_block(9 * 6 * 10 + 9 * 6 * (it - 1))
    if it < 10:
        configs += (1.0 - albedo) * rem * cfg_block(9 * 6 * it)
        configs += albedo * rem * cfg_block(9 * 6 * 10 + 9 * 6 * it)

    def rad_block(base):
        idx = base + np.arange(6)[None, :]
        block = data_rad[np.arange(N_BANDS)[:, None], idx]  # (11, 6)
        return _bezier5(se, block)

    radiances = (1.0 - albedo) * (1.0 - rem) * rad_block(6 * (it - 1))
    radiances += albedo * (1.0 - rem) * rad_block(6 * 10 + 6 * (it - 1))
    if it < 10:
        radiances += (1.0 - albedo) * rem * rad_block(6 * it)
        radiances += albedo * rem * rad_block(6 * 10 + 6 * it)

    sun_dir = np.array([0.0, np.sin(elevation), np.cos(elevation)], np.float32)
    return SkyModel(
        configs=configs.astype(np.float64),
        radiances=radiances.astype(np.float64),
        sun_dir=sun_dir,
        turbidity=turbidity,
        albedo=albedo,
        elevation=elevation,
    )


def radiance_band_np(sky: SkyModel, band, theta, gamma):
    """F(theta, gamma) of integer band(s) (numpy oracle for tests)."""
    c = sky.configs[band]
    cg = np.cos(gamma)
    exp_m = np.exp(c[..., 4] * gamma)
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / np.power(
        1.0 + c[..., 8] * c[..., 8] - 2.0 * c[..., 8] * cg, 1.5
    )
    zenith = np.sqrt(np.cos(theta))
    return (1.0 + c[..., 0] * np.exp(c[..., 1] / (np.cos(theta) + 0.01))) * (
        c[..., 2] + c[..., 3] * exp_m + c[..., 5] * ray_m + c[..., 6] * mie_m
        + c[..., 7] * zenith
    )


def sky_radiance_np(sky: SkyModel, theta, gamma, lam):
    """Spectral sky radiance (numpy oracle)."""
    theta = np.asarray(theta, np.float64)
    lam = np.asarray(lam, np.float64)
    inside = (lam >= MIN_LAMBDA) & (lam <= MAX_LAMBDA)
    pos = (lam - MIN_LAMBDA) / BAND_STEP
    low = np.clip(pos.astype(np.int64), 0, N_BANDS - 1)
    frac = pos - low
    v_low = radiance_band_np(sky, low, theta, gamma) * sky.radiances[low]
    hi_ok = (low + 1) < N_BANDS
    hi = np.minimum(low + 1, N_BANDS - 1)
    v_hi = radiance_band_np(sky, hi, theta, gamma) * sky.radiances[hi]
    out = np.where(
        frac < 1e-6, v_low, (1.0 - frac) * v_low + np.where(hi_ok, frac * v_hi, 0.0)
    )
    return np.where(inside, out, 0.0)


# ------------------------------------------------------------ device eval

def sky_radiance_hero(sky_configs, sky_radiances, theta, gamma, lam):
    """Planar device eval: theta/gamma (N,), lam (4, N) hero wavelengths ->
    (4, N) spectral radiance.  sky_configs (11, 9) and sky_radiances (11,)
    are tensors on the lanes' device."""
    cg = torch.cos(gamma)[None, :]                       # (1, N)
    ct = torch.cos(theta)[None, :]
    c = [sky_configs[:, i][:, None] for i in range(9)]   # (11, 1) each
    exp_m = torch.exp(c[4] * gamma[None, :])
    ray_m = cg * cg
    mie_m = (1.0 + cg * cg) / torch.pow(
        torch.clamp(1.0 + c[8] * c[8] - 2.0 * c[8] * cg, min=1e-8), 1.5
    )
    zenith = torch.sqrt(torch.clamp(ct, min=0.0))
    f_band = (1.0 + c[0] * torch.exp(c[1] / (ct + 0.01))) * (
        c[2] + c[3] * exp_m + c[5] * ray_m + c[6] * mie_m + c[7] * zenith
    )  # (11, N)
    f_band = f_band * sky_radiances[:, None]

    out = []
    for i in range(lam.shape[0]):
        li = lam[i]
        inside = (li >= MIN_LAMBDA) & (li <= MAX_LAMBDA)
        pos = (li - MIN_LAMBDA) / BAND_STEP
        low = torch.clamp(pos.to(torch.int32), 0, N_BANDS - 1)  # truncate, then clamp
        frac = pos - low.to(torch.float32)
        hi_ok = (low + 1) < N_BANDS
        hi = torch.clamp(low + 1, max=N_BANDS - 1)
        v_low = f_band.gather(0, low.long()[None, :])[0]
        v_hi = f_band.gather(0, hi.long()[None, :])[0]
        v = torch.where(
            frac < 1e-6,
            v_low,
            (1.0 - frac) * v_low + torch.where(hi_ok, frac * v_hi, 0.0),
        )
        out.append(torch.where(inside, v, 0.0))
    return torch.stack(out, dim=0)


def solar_disc_radiance_np(sky: SkyModel, lam, elevation, gamma):
    """Limb-darkened solar disc radiance at wavelength lam (nm), for a
    sun at `elevation` seen at angle gamma from its centre (0 outside the
    disc): the piecewise polynomial of assets/sky/data_solar.csv times
    the darkening polynomial of data_dark.csv.  Host oracle only."""
    data_solar = _load_csv("sky/data_solar.csv", TURB_NUM * PIECES * ORDER)
    data_dark = _load_csv("sky/data_dark.csv", 6)

    sol_rad_sin = np.sin(sky.solar_radius)
    ar2 = 1.0 / (sol_rad_sin * sol_rad_sin)
    sin_g = np.sin(gamma)
    sc2 = 1.0 - ar2 * sin_g * sin_g
    if sc2 < 0.0:
        return 0.0
    sample_cosine = np.sqrt(sc2)

    turb_low = int(sky.turbidity) - 1
    turb_frac = sky.turbidity - (turb_low + 1)
    if turb_low == 9:
        turb_low, turb_frac = 8, 1.0
    wl_low = int((lam - 320.0) / 40.0)
    wl_frac = (lam / 40.0) % 1.0
    if wl_low == 10:
        wl_low, wl_frac = 9, 1.0

    def sr(turb, wl):
        pos = min(int((2.0 * elevation / PI) ** (1.0 / 3.0) * PIECES), 44)
        break_x = ((pos / PIECES) ** 3.0) * (PI * 0.5)
        idx = ORDER * PIECES * turb + ORDER * (pos + 1) - 1
        ret, x_exp = 0.0, 1.0
        x = elevation - break_x
        for _ in range(ORDER):
            ret += x_exp * data_solar[wl, idx]
            x_exp *= x
            idx -= 1
        return ret

    dr = (1 - wl_frac) * (
        (1 - turb_frac) * sr(turb_low, wl_low) + turb_frac * sr(turb_low + 1, wl_low)
    ) + wl_frac * (
        (1 - turb_frac) * sr(turb_low, wl_low + 1)
        + turb_frac * sr(turb_low + 1, wl_low + 1)
    )
    ld = data_dark[wl_low] * (1 - wl_frac) + data_dark[min(wl_low + 1, 10)] * wl_frac
    darkening = sum(ld[i] * sample_cosine**i for i in range(6))
    return dr * darkening
