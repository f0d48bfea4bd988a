"""Offline diagnostic plots (twin of ti_raytrace_tpu/tools/plots.py):

    python -m ti_raytrace_tpu_torch.tools.plots [outdir]

  draw_spd      the measured SPDs and D65 the spectral integrators use;
  draw_cmf      the CIE 1931 colour matching functions;
  draw_chroma   the CIE xy horseshoe with the sRGB gamut triangle
                (`in_srgb_gamut`, the point-in-triangle test);
  colour_check  the rgb2spec table's round-trip error.

matplotlib (Agg, headless) is imported by the functions that draw.
"""

import os
import sys

import numpy as np

from ti_raytrace_tpu_torch.io.assets import asset_path
from ti_raytrace_tpu_torch.spectral.cie import load_cie_sensor, normalized_d65, white_point
from ti_raytrace_tpu_torch.spectral.spd import load_spd_csv


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def draw_spd(outpath: str):
    """The measured SPDs + D65 the spectral integrators use."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, color in (("white", "gray"), ("red", "red"), ("green", "green")):
        spd = load_spd_csv(asset_path(f"spectrum/{name}-spec.csv"))
        ax.plot(spd.lambdas, spd.values, color=color, label=f"{name}-spec")
    d65 = normalized_d65()
    ax.plot(d65.lambdas, d65.values / d65.values.max(), "b--", label="D65 (norm.)")
    ax.set_xlabel("wavelength (nm)")
    ax.set_ylabel("reflectance / relative power")
    ax.legend()
    ax.set_title("spectral power distributions")
    fig.tight_layout()
    fig.savefig(outpath, dpi=110)
    plt.close(fig)


def draw_cmf(outpath: str):
    """CIE 1931 observer curves."""
    plt = _pyplot()
    s = load_cie_sensor()
    fig, ax = plt.subplots(figsize=(7, 4))
    for i, (name, color) in enumerate((("x̄", "r"), ("ȳ", "g"), ("z̄", "b"))):
        ax.plot(s.lambdas, s.xyz[:, i], color, label=name)
    ax.set_xlabel("wavelength (nm)")
    ax.set_ylabel("response")
    ax.legend()
    ax.set_title("CIE 1931 color matching functions")
    fig.tight_layout()
    fig.savefig(outpath, dpi=110)
    plt.close(fig)


def _xy_of_xyz(xyz):
    s = xyz.sum(-1, keepdims=True)
    return np.where(s > 0, xyz[..., :2] / np.maximum(s, 1e-12), 0.0)


def in_srgb_gamut(xy):
    """Point-in-triangle test of chromaticities xy (..., 2) against the
    sRGB primaries."""
    r, g, b = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)

    def cross(o, a, p):
        return (a[0] - o[0]) * (p[..., 1] - o[1]) - (a[1] - o[1]) * (p[..., 0] - o[0])

    d1 = cross(r, g, xy)
    d2 = cross(g, b, xy)
    d3 = cross(b, r, xy)
    neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(neg & pos)


def draw_chroma(outpath: str):
    """CIE xy horseshoe + sRGB gamut triangle + the D65 white point."""
    plt = _pyplot()
    s = load_cie_sensor()
    locus = _xy_of_xyz(s.xyz)
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(locus[:, 0], locus[:, 1], "k-", lw=1, label="spectral locus")
    tri = np.array([[0.64, 0.33], [0.30, 0.60], [0.15, 0.06], [0.64, 0.33]])
    ax.plot(tri[:, 0], tri[:, 1], "m-", label="sRGB gamut")
    xs, ys = np.meshgrid(np.linspace(0, 0.8, 160), np.linspace(0, 0.9, 180))
    mask = in_srgb_gamut(np.stack([xs, ys], -1))
    ax.contourf(xs, ys, mask.astype(float), levels=[0.5, 1.5], alpha=0.15, colors=["m"])
    wp = white_point(s, normalized_d65(s))
    ax.plot(*_xy_of_xyz(wp[None, :])[0], "bo", label="D65 white")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.legend()
    ax.set_title("CIE 1931 chromaticity")
    fig.tight_layout()
    fig.savefig(outpath, dpi=110)
    plt.close(fig)


def colour_check() -> float:
    """Mean |rgb - rgb2spec round trip| over 256 random colours in
    [0.05, 0.95]^3 (seed 0): the table's self-consistency."""
    from ti_raytrace_tpu_torch.spectral.jakob_fit import _Integrator
    from ti_raytrace_tpu_torch.spectral.rgb2spec import eval_np, load_table

    table = load_table()
    integ = _Integrator()
    rgb = np.random.default_rng(0).uniform(0.05, 0.95, (256, 3))
    spectra = eval_np(table.fetch(rgb)[:, None, :], integ.lam[None, :])
    back = (spectra @ integ.R.T) @ integ.M.T
    return float(np.abs(back - rgb).mean())


def main(argv=None):
    outdir = (argv or sys.argv[1:] or ["plots"])[0]
    os.makedirs(outdir, exist_ok=True)
    draw_spd(os.path.join(outdir, "spd.png"))
    draw_cmf(os.path.join(outdir, "cmf.png"))
    draw_chroma(os.path.join(outdir, "chroma.png"))
    print(f"plots written to {outdir}; rgb2spec round-trip mean err = {colour_check():.5f}")


if __name__ == "__main__":
    main()
