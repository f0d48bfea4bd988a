"""Simplified Disney principled BRDF (diffuse + GTR2 specular) over (..., 3)
rows (twin of ti_raytrace_tpu/bsdf/disney.py; the render loop's planar
form is bsdf/planar.py).

Metallic/roughness parameters with spec 0.5 and sheen 0.5 fixed;
sampling picks the diffuse lobe with probability 0.5 * (1 - metallic) and
the GGX half-vector lobe otherwise; evaluation is (Fsheen + 1/pi) * Fd *
(1 - metal) + Gs * Fs * Ds with the mixed-lobe pdf.  Every function takes
its uniforms and per-lane material parameters as arguments.
"""

import torch

from ti_raytrace_tpu_torch.core.constants import PI
from ti_raytrace_tpu_torch.utils import microfacet as mf
from ti_raytrace_tpu_torch.utils import sampling, vec


def sample(u3, in_dir, n, metallic, roughness):
    """An outgoing direction from uniforms u3 (..., 3), the incident
    direction in_dir (toward the surface) and the shading normal n."""
    diffuse_ratio = 0.5 * (1.0 - metallic)
    alpha = torch.clamp(roughness, min=0.001)
    u_sel, r1, r2 = u3[..., 0], u3[..., 1], u3[..., 2]
    d_diff = sampling.to_world(sampling.cosine_sample_hemisphere(r1, r2), n)
    half = sampling.to_world(mf.sample_gtr2_half(r1, r2, alpha), n)
    d_spec = vec.reflect(in_dir, half)
    return torch.where((u_sel < diffuse_ratio)[..., None], d_diff, d_spec)


def evaluate_pdf(n, v, l, metallic, roughness):
    """(BRDF scalar, pdf) for the view v and the light l (both away from
    the surface) about n; (0, -1) outside the upper hemisphere."""
    n_dot_l = vec.dot(n, l)
    n_dot_v = vec.dot(n, v)
    valid = (n_dot_l > 0.0) & (n_dot_v > 0.0)

    h = vec.normalize(l + v)
    n_dot_h = vec.dot(h, n)
    l_dot_h = vec.dot(h, l)

    cspec0 = 0.04 + 0.96 * metallic
    csheen = 0.5
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
    brdf = (fh * csheen + 1.0 / PI) * fd * (1.0 - metallic) + gs * fs * ds

    diffuse_ratio = 0.5 * (1.0 - metallic)
    pdf_spec = ds * n_dot_h / (4.0 * torch.clamp(torch.abs(l_dot_h), min=1e-8))
    pdf_ = diffuse_ratio * (1.0 / PI) + (1.0 - diffuse_ratio) * pdf_spec
    return torch.where(valid, brdf, 0.0), torch.where(valid, pdf_, -1.0)


def pdf(n, v, l, metallic, roughness):
    """The pdf alone, 0 where invalid."""
    return torch.clamp(evaluate_pdf(n, v, l, metallic, roughness)[1], min=0.0)


def evaluate(n, v, l, metallic, roughness):
    return evaluate_pdf(n, v, l, metallic, roughness)[0]
