"""Planar-layout BSDFs of the wavefront loop (twin of
ti_raytrace_tpu/bsdf/planar.py): (3, N) vectors, per-lane parameters.

The Disney BSDF has two routes.  `disney_evaluate_pdf` and `disney_sample`
dispatch on the tensors' device: CUDA tensors go to the hand kernels of
csrc/disney.cu (`DISNEY_KERNEL`, one launch a call), CPU tensors to the
plain twins `disney_evaluate_pdf_plain` and `disney_sample_plain`
(tensor ops, ~100 elementwise launches and 148 or 289 top-level torch
calls a call), which the kernels equal on the card bit for bit.  Each
dispatch is a span "bsdf.disney" (op eval or sample, route kernel or
plain, width)."""

import collections
import ctypes

import torch

from ti_raytrace_tpu_torch import metrics
from ti_raytrace_tpu_torch.core.constants import PI, TWO_PI
from ti_raytrace_tpu_torch.ops import planar as pv
from ti_raytrace_tpu_torch.utils import microfacet as mf
from ti_raytrace_tpu_torch.utils.geometry import schlick


def disney_sample_plain(u3, in_dir, n, metallic, roughness):
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


def disney_evaluate_pdf_plain(n, v, l, metallic, roughness, true_pdf: bool = False):
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


class _DisneyKernel:
    """ctypes binding of csrc/disney.cu.  `launches` counts kernel launches
    by op ("eval", "sample"); the wrapper adds to it per launch and nowhere
    else, and `reset_counts` zeroes it."""

    def __init__(self):
        self.launches = collections.Counter()
        self.build_info = None
        self._lib = None

    def reset_counts(self):
        self.launches.clear()

    def library(self):
        if self._lib is None:
            from ti_raytrace_tpu_torch.ops import cuda_build

            lib, self.build_info = cuda_build.load("disney.cu")
            p, i = ctypes.c_void_p, ctypes.c_longlong
            vec, lane = [p, i, i], [p, i]
            lib.disney_evaluate_pdf_launch.argtypes = (
                vec * 3 + lane * 2 + [ctypes.c_int, p, i, p])
            lib.disney_evaluate_pdf_launch.restype = ctypes.c_int
            lib.disney_sample_launch.argtypes = vec * 3 + lane * 2 + [p, i, p]
            lib.disney_sample_launch.restype = ctypes.c_int
            lib.disney_error_string.argtypes = [ctypes.c_int]
            lib.disney_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    @staticmethod
    def check(name, vecs, lanes):
        """Raise ValueError unless every tensor of `vecs` is (3, N) and
        every one of `lanes` is (N,), all float32 on one CUDA device.
        Returns (device, N).  Reads attributes only: no torch call."""
        for t in (*vecs, *lanes):
            if not isinstance(t, torch.Tensor):
                raise ValueError(f"{name}: every input must be a tensor, got {type(t).__name__}")
        first = vecs[0]
        if len(first.shape) != 2 or first.shape[0] != 3:
            raise ValueError(f"{name}: vectors must be (3, N), got {tuple(first.shape)}")
        device, n = first.device, first.shape[1]
        for t in vecs:
            if t.shape != (3, n):
                raise ValueError(f"{name}: vectors must be (3, {n}), got {tuple(t.shape)}")
        for t in lanes:
            if t.shape != (n,):
                raise ValueError(f"{name}: lane values must be ({n},), got {tuple(t.shape)}")
        for t in (*vecs, *lanes):
            if t.dtype != torch.float32:
                raise ValueError(f"{name}: every input must be float32, got {t.dtype}")
            if t.device != device:
                raise ValueError(f"{name}: the inputs lie on {device} and {t.device}")
        if device.type != "cuda":
            raise ValueError(f"{name}: the kernel runs on a CUDA device, got {device}")
        return device, n

    def _run(self, op, vecs, lanes, rows, flags=()):
        """One launch of entry `op` ("eval" or "sample") over the (3, N)
        `vecs` and (N,) `lanes`, read by their strides, into a new
        contiguous (rows, N) block; zero lanes launch nothing."""
        device, count = self.check(f"disney {op}", vecs, lanes)
        out = torch.empty((rows, count), dtype=torch.float32, device=device)
        if count:
            lib = self.library()
            args = []
            for t in vecs:
                args += [t.data_ptr(), *t.stride()]
            for t in lanes:
                args += [t.data_ptr(), t.stride()[0]]
            launch = lib.disney_evaluate_pdf_launch if op == "eval" else lib.disney_sample_launch
            with torch.cuda.device(device):
                err = launch(*args, *flags, out.data_ptr(), count,
                             torch.cuda.current_stream(device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"disney {op} kernel launch failed: "
                                   + lib.disney_error_string(err).decode())
            self.launches[op] += 1
        return out

    def evaluate_pdf(self, n, v, l, metallic, roughness, true_pdf: bool = False):
        """(brdf, pdf) of disney_evaluate_pdf_plain by one launch: the two
        rows of one new (2, N) block."""
        brdf, pdf = self._run("eval", (n, v, l), (metallic, roughness), 2,
                              (int(bool(true_pdf)),)).unbind(0)
        return brdf, pdf

    def sample(self, u3, in_dir, n, metallic, roughness):
        """next_dir of disney_sample_plain by one launch: a new (3, N)
        tensor."""
        return self._run("sample", (u3, in_dir, n), (metallic, roughness), 3)


DISNEY_KERNEL = _DisneyKernel()


def disney_evaluate_pdf(n, v, l, metallic, roughness, true_pdf: bool = False):
    """disney_evaluate_pdf_plain's (brdf, pdf): the kernel when `n` lies on
    a CUDA device, the plain twin otherwise."""
    route = "kernel" if n.device.type == "cuda" else "plain"
    with metrics.span("bsdf.disney", op="eval", route=route, width=n.shape[-1]):
        if route == "kernel":
            return DISNEY_KERNEL.evaluate_pdf(n, v, l, metallic, roughness, true_pdf)
        return disney_evaluate_pdf_plain(n, v, l, metallic, roughness, true_pdf=true_pdf)


def disney_sample(u3, in_dir, n, metallic, roughness):
    """disney_sample_plain's next_dir: the kernel when `n` lies on a CUDA
    device, the plain twin otherwise."""
    route = "kernel" if n.device.type == "cuda" else "plain"
    with metrics.span("bsdf.disney", op="sample", route=route, width=n.shape[-1]):
        if route == "kernel":
            return DISNEY_KERNEL.sample(u3, in_dir, n, metallic, roughness)
        return disney_sample_plain(u3, in_dir, n, metallic, roughness)


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
