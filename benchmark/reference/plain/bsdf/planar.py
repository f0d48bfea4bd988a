"""Planar-layout BSDFs of the wavefront loop (twin of
ti_raytrace_tpu/bsdf/planar.py): (3, N) vectors, per-lane parameters."""

import torch

from reference.plain.core.constants import PI, TWO_PI
from reference.plain.ops import planar as pv
from reference.plain.utils import microfacet as mf
from reference.plain.utils.geometry import schlick


def disney_sample(u3, in_dir, n, metallic, roughness):
    """u3: (3, N) uniforms.  Returns next_dir (3, N)."""
    diffuse_ratio = 0.5 * (1.0 - metallic)
    alpha = torch.clamp(roughness, min=0.001)
    u_sel, r1, r2 = u3[0], u3[1], u3[2]

    d_diff = pv.to_world(pv.cosine_sample_hemisphere(r1, r2), n)

    phi = r1 * TWO_PI
    cos_t = torch.sqrt((1.0 - r2) / (1.0 + (alpha * alpha - 1.0) * r2))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    half = pv.to_world(pv.p3(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t), n)
    d_spec = pv.reflect(in_dir, half)

    return pv.where(u_sel < diffuse_ratio, d_diff, d_spec)


def disney_evaluate_pdf(n, v, l, metallic, roughness, true_pdf: bool = False):
    """Returns (brdf, pdf); (0, -1) outside the upper hemisphere.  The
    diffuse-branch pdf is the reference's 1/pi (PARITY.md 'Disney diffuse
    pdf'), though disney_sample draws that branch cosine-weighted;
    true_pdf=True returns the sampler's real density cos(theta)/pi (the
    corrected estimators' mode)."""
    n_dot_l = pv.dot(n, l)
    n_dot_v = pv.dot(n, v)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)

    h = pv.normalize(l + v)
    n_dot_h = pv.dot(h, n)
    l_dot_h = pv.dot(h, l)

    cspec0 = 0.04 + 0.96 * metallic
    fl = mf.schlick_fresnel(n_dot_l)
    fv = mf.schlick_fresnel(n_dot_v)
    fd90 = 0.5 + 2.0 * l_dot_h * l_dot_h * roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    alpha = torch.clamp(roughness, min=0.001)
    ds = mf.gtr2(n_dot_h, alpha)
    fh = mf.schlick_fresnel(l_dot_h)
    fs = cspec0 + (1.0 - cspec0) * fh
    rough_g = mf.sqr(roughness * 0.5 + 0.5)
    gs = mf.smith_g_ggx(n_dot_l, rough_g) * mf.smith_g_ggx(n_dot_v, rough_g)
    brdf = (fh * 0.5 + 1.0 / PI) * fd * (1.0 - metallic) + gs * fs * ds

    diffuse_ratio = 0.5 * (1.0 - metallic)
    pdf_spec = ds * n_dot_h / (4.0 * torch.clamp(torch.abs(l_dot_h), min=1e-8))
    pdf_diff = n_dot_l / PI if true_pdf else 1.0 / PI
    pdf = diffuse_ratio * pdf_diff + (1.0 - diffuse_ratio) * pdf_spec
    return torch.where(valid, brdf, 0.0), torch.where(valid, pdf, -1.0)


def glass_sample(u, in_dir, n, ior):
    """Smooth dielectric sample.  Returns (next_dir, f_or_b)."""
    cos_i = pv.dot(in_dir, n)
    exiting = cos_i > 0.0
    n_eff = pv.where(exiting, -n, n)
    cos_theta_i = torch.abs(cos_i)
    eta = torch.where(exiting, ior, 1.0 / ior)

    refr, ok = pv.refract(in_dir, n_eff, eta)
    r = torch.where(ok, schlick(cos_theta_i, ior), u + 1.0)

    refl = pv.reflect(in_dir, n_eff)
    reflect_mask = u < r
    next_dir = pv.where(reflect_mask, refl, refr)
    f_or_b = torch.where(reflect_mask, 1.0, -1.0)
    return next_dir, f_or_b
