// The Disney BSDF of the wavefront loop as __device__ functions, one lane
// at a time, for csrc/disney.cu and for any later kernel that shades a hit
// (include this header; it has no kernel and no state).
//
// The plain twins are ti_raytrace_tpu_torch/bsdf/planar.py::
// disney_evaluate_pdf_plain and disney_sample_plain, tensor ops over (3, N)
// and (N,) lanes.  Each function here equals its twin on the card bit for
// bit, given -fmad=false, IEEE division and square root (nvcc's defaults
// without --use_fast_math), because it computes the same float32
// operations in the same order as ATen's CUDA kernels do for the twin's
// ops:
//   * a Python scalar in a tensor op is a double cast to float before the
//     op (so `1.0 / PI` is folded in double first, and `0.04` is
//     (float)0.04, not the literal 0.04f); `a op scalar` and `scalar op a`
//     round once, as the commuted float op does;
//   * `x / PI` with a Python float is `x * (float)(1.0 / PI)` (ATen's
//     div_true with a CPU scalar multiplies by the scalar's reciprocal,
//     taken in double and cast to float; for PI that is 1.0f / (float)PI,
//     for 1.055 it is not);
//   * `1.0 / t` is `reciprocal(t) * 1.0`, i.e. 1.0f / t;
//   * torch.rsqrt is rsqrtf (not 1.0f / sqrtf); torch.sqrt, sin and cos
//     are sqrtf, sinf and cosf;
//   * torch.clamp keeps a NaN and is otherwise fmaxf / fminf of the value
//     and the bound, in that order;
//   * a sum of several terms adds left to right, a product multiplies
//     left to right, each step rounded.
// The comments name the twin's line each step follows.

#pragma once

namespace disney {

struct f3 {
    float x, y, z;
};

constexpr double PI_D = 3.141592653589793;  // core/constants.PI
constexpr float PI_F = (float)PI_D;
constexpr float TWO_PI_F = (float)(2.0 * PI_D);  // core/constants.TWO_PI
constexpr float INV_PI_F = (float)(1.0 / PI_D);  // `1.0 / PI` folded in double; `/ PI`

// torch.clamp(x, min=lo)
__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

// torch.clamp(x, lo, hi)
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// ops/planar.dot
__device__ __forceinline__ float dot(f3 a, f3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}

// ops/planar.cross
__device__ __forceinline__ f3 cross(f3 a, f3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// ops/planar.normalize (eps 1e-20)
__device__ __forceinline__ f3 normalize(f3 a) {
    const float inv = rsqrtf(clamp_min(dot(a, a), (float)1e-20));
    return {a.x * inv, a.y * inv, a.z * inv};
}

// ops/planar.reflect: i - (2 dot(i, n)) n
__device__ __forceinline__ f3 reflect(f3 i, f3 n) {
    const float k = 2.0f * dot(i, n);
    return {i.x - k * n.x, i.y - k * n.y, i.z - k * n.z};
}

// utils/microfacet.schlick_fresnel: (1 - u)^5 as m2 * m2 * m
__device__ __forceinline__ float schlick_fresnel(float u) {
    const float m = clamp(1.0f - u, 0.0f, 1.0f);
    const float m2 = m * m;
    return m2 * m2 * m;
}

// utils/microfacet.gtr2: a2 / (PI * t * t)
__device__ __forceinline__ float gtr2(float n_dot_h, float a) {
    const float a2 = a * a;
    const float t = 1.0f + (a2 - 1.0f) * n_dot_h * n_dot_h;
    return a2 / (t * PI_F * t);
}

// utils/microfacet.smith_g_ggx: 1 / clamp(n.v + sqrt(clamp(a + b - a b, 0)), 1e-8)
__device__ __forceinline__ float smith_g_ggx(float n_dot_v, float alpha_g) {
    const float a = alpha_g * alpha_g;
    const float b = n_dot_v * n_dot_v;
    const float s = sqrtf(clamp_min(a + b - a * b, 0.0f));
    return 1.0f / clamp_min(n_dot_v + s, (float)1e-8);
}

// bsdf/planar.disney_evaluate_pdf_plain for one lane: (brdf, pdf), (0, -1)
// outside the upper hemisphere.
__device__ __forceinline__ void evaluate_pdf(f3 n, f3 v, f3 l, float metallic, float roughness,
                                             bool true_pdf, float& brdf_out, float& pdf_out) {
    const float n_dot_l = dot(n, l);
    const float n_dot_v = dot(n, v);
    const bool valid = (n_dot_l > 0.0f) & (n_dot_v > 0.0f);

    const f3 h = normalize({l.x + v.x, l.y + v.y, l.z + v.z});
    const float n_dot_h = dot(h, n);
    const float l_dot_h = dot(h, l);

    const float cspec0 = (float)0.96 * metallic + (float)0.04;
    const float fl = schlick_fresnel(n_dot_l);
    const float fv = schlick_fresnel(n_dot_v);
    const float fd90 = 2.0f * l_dot_h * l_dot_h * roughness + 0.5f;
    const float fd = (1.0f + (fd90 - 1.0f) * fl) * (1.0f + (fd90 - 1.0f) * fv);
    const float alpha = clamp_min(roughness, (float)0.001);
    const float ds = gtr2(n_dot_h, alpha);
    const float fh = schlick_fresnel(l_dot_h);
    const float fs = cspec0 + (1.0f - cspec0) * fh;
    const float rg = roughness * 0.5f + 0.5f;
    const float rough_g = rg * rg;
    const float gs = smith_g_ggx(n_dot_l, rough_g) * smith_g_ggx(n_dot_v, rough_g);
    const float brdf = (fh * 0.5f + INV_PI_F) * fd * (1.0f - metallic) + gs * fs * ds;

    const float diffuse_ratio = 0.5f * (1.0f - metallic);
    const float pdf_spec = ds * n_dot_h / (clamp_min(fabsf(l_dot_h), (float)1e-8) * 4.0f);
    const float pdf_diff = true_pdf ? n_dot_l * INV_PI_F : INV_PI_F;
    const float pdf = diffuse_ratio * pdf_diff + (1.0f - diffuse_ratio) * pdf_spec;
    brdf_out = valid ? brdf : 0.0f;
    pdf_out = valid ? pdf : -1.0f;
}

// ops/planar.onb around n with the unit normal beside it: to_world's frame.
struct frame {
    f3 t, b, n;
};

__device__ __forceinline__ frame onb(f3 n) {
    const f3 nu = normalize(n);
    const bool use_x = fabsf(nu.x) > fabsf(nu.z);
    f3 b = use_x ? f3{-nu.y, nu.x, 0.0f} : f3{0.0f, -nu.z, nu.y};
    b = normalize(b);
    const f3 t = normalize(cross(b, nu));
    return {t, b, nu};
}

// ops/planar.to_world: t l0 + b l1 + n l2
__device__ __forceinline__ f3 to_world(const frame& f, f3 l) {
    return {f.t.x * l.x + f.b.x * l.y + f.n.x * l.z,
            f.t.y * l.x + f.b.y * l.y + f.n.y * l.z,
            f.t.z * l.x + f.b.z * l.y + f.n.z * l.z};
}

// ops/planar.cosine_sample_hemisphere, z up
__device__ __forceinline__ f3 cosine_sample_hemisphere(float u1, float u2) {
    const float r = sqrtf(u1);
    const float phi = TWO_PI_F * u2;
    const float x = r * cosf(phi);
    const float y = r * sinf(phi);
    const float z = sqrtf(clamp_min(1.0f - x * x - y * y, 0.0f));
    return normalize({x, y, z});
}

// bsdf/planar.disney_sample_plain for one lane: the next direction.
__device__ __forceinline__ f3 sample(float u_sel, float r1, float r2, f3 in_dir, f3 n,
                                     float metallic, float roughness) {
    const float diffuse_ratio = 0.5f * (1.0f - metallic);
    const float alpha = clamp_min(roughness, (float)0.001);
    const frame f = onb(n);  // to_world's frame, the same for both lobes

    const f3 d_diff = to_world(f, cosine_sample_hemisphere(r1, r2));

    const float phi = r1 * TWO_PI_F;
    const float cos_t = sqrtf((1.0f - r2) / (1.0f + (alpha * alpha - 1.0f) * r2));
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
    const f3 half = to_world(f, {sin_t * cosf(phi), sin_t * sinf(phi), cos_t});
    const f3 d_spec = reflect(in_dir, half);

    return u_sel < diffuse_ratio ? d_diff : d_spec;
}

}  // namespace disney
