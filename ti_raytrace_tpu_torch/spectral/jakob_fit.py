"""Fit of the RGB -> spectrum coefficient table (twin of
ti_raytrace_tpu/spectral/jakob_fit.py), the Jakob-Hanika model: for every
lattice colour, sigmoid-quadratic coefficients whose spectrum integrates
(through the normalised D65 illuminant and the CIE 1931 observer, as the
spectral integrators integrate) back to that colour.  Damped Gauss-Newton
with an analytic Jacobian, the residual in CIELAB, continuation along the
brightness lattice (each z-slice warm-started from its neighbour).

Host numpy in float64: a build-time artifact, ~1 minute for the 64^3
table, cached by spectral/rgb2spec.load_table.  The quadratic uses a
normalised wavelength for conditioning; coefficients are converted to
nanometre units on output, as the integrators evaluate them.
"""

import numpy as np

from ti_raytrace_tpu_torch.core import constants as C
from ti_raytrace_tpu_torch.spectral.cie import (
    load_cie_sensor,
    normalized_d65,
    simpson38_weights,
    white_point,
)
from ti_raytrace_tpu_torch.spectral.rgb2spec import RES, Rgb2SpecTable, scale_lattice

# normalized wavelength: lam_n = (lam - LAM_M) / LAM_S
LAM_M = 595.0
LAM_S = 235.0


class _Integrator:
    def __init__(self):
        sensor = load_cie_sensor()
        d65 = normalized_d65(sensor)
        self.lam = sensor.lambdas                       # (L,)
        self.lam_n = (self.lam - LAM_M) / LAM_S
        w = simpson38_weights(len(self.lam), sensor.lambda_min, sensor.lambda_max)
        ill = d65.sample(self.lam)
        # response matrix: XYZ = R @ S  (S = spectrum on the lambda grid)
        self.R = (sensor.xyz * (ill * w)[:, None]).T     # (3, L)
        self.wp = white_point(sensor, d65)               # D65 white, Y=1
        self.M = np.asarray(C.XYZ_TO_SRGB, np.float64)

    def rgb_and_jac(self, coeffs):
        """coeffs (K, 3) in normalized-lambda units ->
        (rgb (K, 3), d_rgb/d_coeffs (K, 3, 3))."""
        ln = self.lam_n[None, :]                         # (1, L)
        x = (coeffs[:, 0:1] * ln + coeffs[:, 1:2]) * ln + coeffs[:, 2:3]
        inv = 1.0 / np.sqrt(x * x + 1.0)
        s = 0.5 * x * inv + 0.5                          # (K, L)
        ds_dx = 0.5 * inv * inv * inv                    # (K, L)
        xyz = s @ self.R.T                               # (K, 3)
        rgb = xyz @ self.M.T
        # dx/dc = [ln^2, ln, 1]
        basis = np.stack([ln[0] ** 2, ln[0], np.ones_like(ln[0])])  # (3, L)
        # d_xyz/dc_j = (ds_dx * basis_j) @ R.T
        jac = np.einsum("kl,jl,cl->kcj", ds_dx, basis, self.R)      # (K, 3c, 3j)
        jac = np.einsum("rc,kcj->krj", self.M, jac)
        return rgb, jac


def _lab(rgb_lin, integ):
    """Linear sRGB -> CIELAB under the D65 white point, plus d_lab/d_rgb."""
    Minv = np.linalg.inv(integ.M)
    xyz = rgb_lin @ Minv.T
    r = xyz / integ.wp[None, :]
    d = 6.0 / 29.0
    f = np.where(r > d**3, np.cbrt(np.maximum(r, 1e-20)), r / (3 * d * d) + 4.0 / 29.0)
    df = np.where(
        r > d**3,
        1.0 / (3.0 * np.cbrt(np.maximum(r, 1e-20)) ** 2),
        np.full_like(r, 1.0 / (3 * d * d)),
    )
    L = 116.0 * f[:, 1] - 16.0
    a = 500.0 * (f[:, 0] - f[:, 1])
    b = 200.0 * (f[:, 1] - f[:, 2])
    lab = np.stack([L, a, b], axis=-1)
    # d_lab/d_f
    dlab_df = np.zeros((len(r), 3, 3))
    dlab_df[:, 0, 1] = 116.0
    dlab_df[:, 1, 0] = 500.0
    dlab_df[:, 1, 1] = -500.0
    dlab_df[:, 2, 1] = 200.0
    dlab_df[:, 2, 2] = -200.0
    # d_f/d_xyz = diag(df / wp)
    dlab_dxyz = dlab_df * (df / integ.wp[None, :])[:, None, :]
    dlab_drgb = np.einsum("kij,jr->kir", dlab_dxyz, Minv)
    return lab, dlab_drgb


def _gauss_newton(targets, coeffs, integ, iters=24, damping=1e-8):
    """Vectorized damped GN over K fits: minimize |Lab(rgb(c)) - Lab(t)|."""
    t_lab, _ = _lab(targets, integ)
    for _ in range(iters):
        rgb, j_rgb = integ.rgb_and_jac(coeffs)
        lab, dlab_drgb = _lab(rgb, integ)
        r = lab - t_lab                                   # (K, 3)
        J = np.einsum("kir,krj->kij", dlab_drgb, j_rgb)   # (K, 3, 3)
        JtJ = np.einsum("kij,kil->kjl", J, J)
        JtJ += damping * np.eye(3)[None]
        Jtr = np.einsum("kij,ki->kj", J, r)
        try:
            step = np.linalg.solve(JtJ, Jtr[..., None])[..., 0]
        except np.linalg.LinAlgError:  # pragma: no cover
            step = np.zeros_like(coeffs)
        coeffs = coeffs - step
    return coeffs


def _to_nm_units(cn):
    """Normalized-lambda coefficients -> nanometre units for the device
    eval x = c0*lam^2 + c1*lam + c2."""
    a, b, c = cn[..., 0], cn[..., 1], cn[..., 2]
    c0 = a / (LAM_S * LAM_S)
    c1 = -2.0 * a * LAM_M / (LAM_S * LAM_S) + b / LAM_S
    c2 = a * LAM_M * LAM_M / (LAM_S * LAM_S) - b * LAM_M / LAM_S + c
    return np.stack([c0, c1, c2], axis=-1)


def _lattice_targets(k: int, zi: int, res: int, scale):
    """Target linear RGB colors of one (max-component k, brightness zi)
    slice, shape (res*res, 3): the inverse of fetch's max-component reorder."""
    z = scale[zi]
    xi, yi = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    a = xi.reshape(-1) / (res - 1) * z
    b = yi.reshape(-1) / (res - 1) * z
    rgb = np.zeros((res * res, 3))
    # index k: (x, y, z) -> rgb positions (see fetch reorder)
    # max component = k holds z; x-axis feeds (k+1)%3, y-axis (k+2)%3
    rgb[:, k] = z
    rgb[:, (k + 1) % 3] = a
    rgb[:, (k + 2) % 3] = b
    return rgb


def fit_table(res: int = RES, iters: int = 24, verbose: bool = False) -> Rgb2SpecTable:
    integ = _Integrator()
    scale = scale_lattice(res)
    data = np.zeros((3, res, res, res, 3))

    # continuation: start at mid-brightness with a flat-spectrum guess,
    # then sweep to both ends warm-starting each slice
    z_mid = res // 2
    for k in range(3):
        # lattice layout: data[k][zi][yi][xi]; targets built (xi, yi)
        # meshgrid 'ij' gives (xi-major); transpose to [yi][xi]
        def fit_slice(zi, warm, n_it):
            targets = _lattice_targets(k, zi, res, scale)
            cn = _gauss_newton(targets, warm, integ, iters=n_it)
            return cn

        warm = np.zeros((res * res, 3))
        order = list(range(z_mid, res)) + ["reset"] + list(range(z_mid - 1, -1, -1))
        mid_result = None
        first = True
        for zi in order:
            if zi == "reset":
                warm = mid_result.copy()
                continue
            warm = fit_slice(zi, warm, iters if first else max(6, iters // 3))
            first = False
            if zi == z_mid:
                mid_result = warm.copy()
            nm = _to_nm_units(warm)
            # warm/nm are (res*res, 3) with xi-major from meshgrid 'ij';
            # store as [yi][xi]
            data[k, zi] = nm.reshape(res, res, 3).transpose(1, 0, 2)
            if verbose:  # pragma: no cover
                print(f"k={k} zi={zi} done")
    return Rgb2SpecTable(res, scale, data)


if __name__ == "__main__":  # pragma: no cover
    import time

    from ti_raytrace_tpu_torch.spectral.rgb2spec import TABLE_PATH, save_table

    t0 = time.time()
    save_table(fit_table(verbose=True), TABLE_PATH)
    print(f"wrote {TABLE_PATH} in {time.time() - t0:.1f}s")
