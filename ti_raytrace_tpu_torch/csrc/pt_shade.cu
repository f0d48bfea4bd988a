// The path tracer's shading step for Hopper (sm_90a): integrators/pt_rgb.
// _shade_plain in one launch a bounce (two under NEE), one lane per thread.
//
// Replaces no TPU kernel: the JAX package's shading
// (ti_raytrace_tpu/integrators/pt_rgb.py) is plain XLA, fused by the
// compiler.  In the port the plain twin is some 270 top-level torch calls a
// bounce (decode_hit, faceforward, srgb_to_lrgb, the emitter term, the
// glass sample, two Disney launches, Beer-Lambert and the carry's where's),
// each a small elementwise launch that the card runs in a few us while the
// host dispatches the next: the host, not the card, is the cost.
//
// Three entries, one algorithm, chosen by the scene's NEE flag:
//   FULL (nee=False): the whole of _shade_plain -> the new carry;
//   HEAD (nee=True):  the hit's position and the lanes that take NEE (a
//                     Disney hit), for sample_li and the shadow ray, which
//                     stay torch ops between the launches;
//   TAIL (nee=True):  from the same hit record and the shadow trace's
//                     result, the emitter term with its power-heuristic MIS,
//                     the NEE contribution, the glass and Disney samples,
//                     Beer-Lambert and the carry update -> the new carry.
// TAIL decodes the hit again rather than reading back a record the head
// wrote: the decode repeats the same float32 operations, so it gives the
// same bits, and the ~20 rows of such a record would cost more bytes than
// the attribute rows read twice.
//
// Equality with the plain twin: each lane computes _shade_plain's float32
// operations in the order ATen's CUDA kernels compute them, as disney.cuh
// sets out (Python scalars cast to float, `x / scalar` as x times the
// scalar's reciprocal taken in double and cast to float, torch.clamp
// keeping a NaN, sums and products left to right), under -fmad=false, so
// every output equals the twin's on the card bit for bit (NaN payloads
// aside).  torch.pow with a Python float exponent other than 0.5, -0.5, -1,
// 2, 3 and -2 is powf of the exponent cast to float, and torch.exp is expf:
// pow_f and exp_f below.  ATen's pow kernel takes its exponent as an
// argument; so does this kernel (params::e_srgb, e_schlick) and so does the
// probe entry pt_math_launch, so that the tests that hold the probe to
// torch.pow and torch.exp over every float32 of their domains hold the very
// code the kernel runs.
//
// What bounds it on an H100: bytes.  Per lane FULL reads 198 B (the ray 24,
// t and prim 8, alive 1, barycentrics 8, 22 attribute rows 88, the rest of
// the carry 53, 4 uniform rows 16) and writes 78 (19 float rows, 2 flag
// rows): 276 B, 86 us for 1,048,576 lanes at 3.35 TB/s.  HEAD reads 37 B
// (ray, t, prim, alive, the material row) and writes 13; TAIL reads FULL's
// 198 B, the area row (4 B), the light sample (44 B) and the shadow hit
// (4 B): 250 B, and writes 78.
// The arithmetic (some 1,000 instructions a lane with the Disney sample and
// evaluation, two of them under NEE, and powf / expf) is ~4 us at 1,048,576
// lanes at 128 instructions a clock per SM: the design only has to read and
// write each value once, coalesced.
//
// Design: THREADS threads per block, one lane each, no shared memory, no
// synchronisation.  Each input is read through its strides (the camera's
// shared origin is an expanded, stride-0 view); outputs are one contiguous
// (rows, N) float block and one (rows, N) bool block, whose rows the wrapper
// hands out as the carry's tensors.

#include <cuda_runtime.h>

#include "disney.cuh"

#define THREADS 256

namespace pt {

using disney::f3;

constexpr int MAT_GLASS = 1;  // core/constants
constexpr int MAT_LIGHT = 2;
constexpr float INF_F = (float)1.0e6;  // core/constants.INF: a miss has t >= INF
constexpr float PARK_F = (float)1e9;   // a terminated lane's origin

// the input slots, in the order of the wrapper's words (pointer, row stride,
// lane stride; strides in elements, a (N,) input's row stride 0)
enum slot_id {
    O, D, T, PRIM, UV, ATTR, U, THR, RAD, ALIVE, BPDF, PS, MDIR, MW,  // the hit and carry
    L_DIR, L_NRM, L_EM, L_DIST, L_CPDF, SH_PRIM,                    // TAIL: NEE's inputs
    N_SLOTS
};

enum mode_id { FULL = 0, HEAD = 1, TAIL = 2 };

// the output rows of FULL and TAIL (HEAD: pos in rows 0-2, is_disney in
// flag row 0)
enum out_row { R_ORIGIN = 0, R_DIR = 3, R_THR = 6, R_RAD = 9, R_MDIR = 12, R_MW = 15,
               R_BPDF = 18 };
enum flag_row { F_ALIVE = 0, F_PS = 1 };

struct slot {
    const void* p;
    long long row, lane;
};

struct params {
    slot s[N_SLOTS];
    float* out;            // (rows, count), contiguous
    unsigned char* flags;  // (rows, count) bool, contiguous
    long long count;
    float n_lights;  // scene.n_lights as ATen casts the Python int
    float e_srgb;     // (float)2.4, srgb_to_lrgb's exponent, passed at run time
    float e_schlick;  // 5, schlick's exponent, likewise
    int mode;
    bool corrected;  // the Disney pdfs are the sampler's true densities
};

__device__ __forceinline__ float at(const slot& s, long long i, int r = 0) {
    return static_cast<const float*>(s.p)[i * s.lane + r * s.row];
}

__device__ __forceinline__ f3 at3(const slot& s, long long i, int r = 0) {
    return {at(s, i, r), at(s, i, r + 1), at(s, i, r + 2)};
}

__device__ __forceinline__ int at_i32(const slot& s, long long i) {
    return static_cast<const int*>(s.p)[i * s.lane];
}

__device__ __forceinline__ bool at_bool(const slot& s, long long i) {
    return static_cast<const unsigned char*>(s.p)[i * s.lane] != 0;
}

__device__ __forceinline__ f3 add(f3 a, f3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ f3 sub(f3 a, f3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ f3 mul(f3 a, f3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
// a * s[None]
__device__ __forceinline__ f3 scale(f3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ f3 neg(f3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ f3 sel(bool m, f3 a, f3 b) { return m ? a : b; }

// torch.pow(x, e) for a Python float e outside ATen's special cases
__device__ __forceinline__ float pow_f(float x, float e) { return powf(x, e); }

// torch.exp
__device__ __forceinline__ float exp_f(float x) { return expf(x); }

// ops/planar.sign_nonzero
__device__ __forceinline__ float sign_nonzero(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// utils/sampling.power_heuristic: a^2 / clamp(b^2 + a^2, 1e-20)
__device__ __forceinline__ float power_heuristic(float a, float b) {
    const float t = a * a;
    return t / disney::clamp_min(b * b + t, (float)1e-20);
}

// utils/colorsp.srgb_to_lrgb, one channel; e: (float)2.4
__device__ __forceinline__ float srgb_to_lrgb(float s, float e) {
    constexpr float INV_12_92 = (float)(1.0 / 12.92);  // `/ 12.92`, as ATen takes it
    constexpr float INV_1_055 = (float)(1.0 / 1.055);  // not 1.0f / (float)1.055
    const float lin = s * INV_12_92;
    const float gam = pow_f(disney::clamp_min(s + (float)0.055, 0.0f) * INV_1_055, e);
    return s < (float)0.04045 ? lin : gam;
}

// utils/geometry.schlick; e: 5
__device__ __forceinline__ float schlick(float cosine, float ior, float e) {
    float r0 = (1.0f - ior) / (ior + 1.0f);
    r0 = r0 * r0;
    return r0 + (1.0f - r0) * pow_f(disney::clamp_min(1.0f - cosine, 0.0f), e);
}

// bsdf/planar.glass_sample with ops/planar.refract: (next_dir, f_or_b);
// e_schlick: schlick's exponent
__device__ __forceinline__ void glass_sample(float u, f3 in_dir, f3 n, float ior,
                                             float e_schlick, f3& dir, float& f_or_b) {
    const float cos_i = disney::dot(in_dir, n);
    const bool exiting = cos_i > 0.0f;
    const f3 n_eff = sel(exiting, neg(n), n);
    const float cos_theta_i = fabsf(cos_i);
    const float eta = exiting ? ior : 1.0f / ior;

    const float n_dot_i = disney::dot(n_eff, in_dir);
    const float k = 1.0f - eta * eta * (1.0f - n_dot_i * n_dot_i);
    const bool ok = k > 0.0f;
    const f3 r = sub(scale(in_dir, eta),
                     scale(n_eff, eta * n_dot_i + sqrtf(disney::clamp_min(k, 0.0f))));
    const f3 refr = sel(ok, r, f3{0.0f, 0.0f, 0.0f});
    const float rr = ok ? schlick(cos_theta_i, ior, e_schlick) : u + 1.0f;

    const f3 refl = disney::reflect(in_dir, n_eff);
    const bool reflect_mask = u < rr;
    dir = sel(reflect_mask, refl, refr);
    f_or_b = reflect_mask ? 1.0f : -1.0f;
}

// ops/planar.offset_ray, one component: the float's bits walked by
// int(256 n) ulps (int32 wrap-around, as ATen's int adds), a fixed float
// offset near the origin
__device__ __forceinline__ float offset1(float p, float n) {
    const int i_of = (int)(256.0f * n);
    const unsigned int i_p = (unsigned int)__float_as_int(p);
    const unsigned int moved = p < 0.0f ? i_p - (unsigned int)i_of : i_p + (unsigned int)i_of;
    const float f_p = __int_as_float((int)moved);
    return fabsf(p) < (float)(1.0 / 256.0) ? p + (float)(1.0 / 2048.0) * n : f_p;
}

__device__ __forceinline__ f3 offset_ray(f3 p, f3 n) {
    return {offset1(p.x, n.x), offset1(p.y, n.y), offset1(p.z, n.z)};
}

__device__ __forceinline__ void put(const params& p, int row, long long i, float v) {
    p.out[row * p.count + i] = v;
}

__device__ __forceinline__ void put3(const params& p, int row, long long i, f3 v) {
    put(p, row, i, v.x);
    put(p, row + 1, i, v.y);
    put(p, row + 2, i, v.z);
}

__device__ __forceinline__ void put_flag(const params& p, int row, long long i, bool v) {
    p.flags[row * p.count + i] = v;
}

// One lane of _shade_plain (its comments name the steps).
__device__ __forceinline__ void shade_lane(const params& p, long long i) {
    const slot& A = p.s[ATTR];
    const f3 o = at3(p.s[O], i);
    const f3 d = at3(p.s[D], i);
    const float t = at(p.s[T], i);
    const int prim = at_i32(p.s[PRIM], i);
    const bool alive = at_bool(p.s[ALIVE], i);

    // ops/shading.decode_hit
    const bool hit_valid = (t < INF_F) & (prim >= 0);
    const f3 pos = add(o, scale(d, t));
    const int mat_type = (int)at(A, i, 18);

    const bool valid = hit_valid & alive;
    const bool is_disney = valid & (mat_type != MAT_GLASS) & (mat_type != MAT_LIGHT);
    if (p.mode == HEAD) {
        put3(p, 0, i, pos);
        put_flag(p, 0, i, is_disney);
        return;
    }
    const bool is_glass = valid & (mat_type == MAT_GLASS);
    const bool is_light = valid & (mat_type == MAT_LIGHT);

    const float bu = at(p.s[UV], i, 0);
    const float bv = at(p.s[UV], i, 1);
    const float a = 1.0f - bu - bv;
    const f3 n_tri = add(add(scale(at3(A, i, 3), a), scale(at3(A, i, 6), bu)),
                         scale(at3(A, i, 9), bv));
    const bool is_shape = at(A, i, 25) > 0.5f;
    const f3 n_sph = sub(pos, at3(A, i, 26));
    const f3 gnormal = disney::normalize(sel(is_shape, n_sph, at3(A, i, 0)));
    const f3 normal = disney::normalize(sel(is_shape, n_sph, n_tri));
    const f3 color = at3(A, i, 19);
    const float p0 = at(A, i, 22);
    const float p1 = at(A, i, 23);

    // faceforward(normal, -d, gnormal); srgb_to_lrgb(mat_color)
    const f3 fnormal = scale(normal, sign_nonzero(disney::dot(neg(d), gnormal)));
    const f3 reflect_color = {srgb_to_lrgb(color.x, p.e_srgb), srgb_to_lrgb(color.y, p.e_srgb),
                              srgb_to_lrgb(color.z, p.e_srgb)};

    const f3 throughput = at3(p.s[THR], i);
    const float brdf_pdf_prev = at(p.s[BPDF], i);
    const bool perfect_spec = at_bool(p.s[PS], i);

    // miss: defer the env lookup
    const bool miss = alive & !hit_valid;
    put3(p, R_MDIR, i, sel(miss, d, at3(p.s[MDIR], i)));
    put3(p, R_MW, i, sel(miss, throughput, at3(p.s[MW], i)));

    // emitter hit: under NEE weighed against light sampling
    f3 emitted = mul(throughput, color);
    if (p.mode == TAIL) {
        const float fcos = fabsf(disney::dot(d, gnormal));
        const float area = at(A, i, 24) * p.n_lights;
        const float light_pdf_hit = (t * t) / disney::clamp_min(area * fcos, (float)1e-12);
        const float mis_w = perfect_spec ? 1.0f : power_heuristic(brdf_pdf_prev, light_pdf_hit);
        emitted = mul(scale(throughput, mis_w), color);
    }
    const f3 zero = {0.0f, 0.0f, 0.0f};
    f3 radiance = add(at3(p.s[RAD], i), sel(is_light, emitted, zero));

    f3 g_dir;
    float g_forb;
    glass_sample(at(p.s[U], i, 3), d, normal, p0, p.e_schlick, g_dir, g_forb);

    if (p.mode == TAIL) {  // the NEE contribution, given the shadow ray's hit
        const f3 l_dir = at3(p.s[L_DIR], i);
        const float ndl_surf = disney::dot(fnormal, l_dir);
        const float ndl_light = disney::dot(at3(p.s[L_NRM], i), l_dir);
        const bool nee_geo_ok = is_disney & (ndl_surf < 0.0f) & (ndl_light > 0.0f);
        const bool unoccluded = at_i32(p.s[SH_PRIM], i) == prim;
        float nee_brdf, nee_pdf;
        disney::evaluate_pdf(fnormal, neg(d), neg(l_dir), p0, p1, p.corrected, nee_brdf,
                             nee_pdf);
        const float dist = at(p.s[L_DIST], i);
        const float light_pdf = (dist * dist * at(p.s[L_CPDF], i))
                                / disney::clamp_min(ndl_light, (float)1e-12);
        const bool nee_ok = nee_geo_ok & unoccluded & (nee_pdf > 0.0f);
        const float nee_w = power_heuristic(light_pdf, nee_pdf)
                            / disney::clamp_min(light_pdf, (float)1e-4) * nee_brdf
                            * fabsf(ndl_surf);
        const f3 contrib = mul(mul(scale(at3(p.s[L_EM], i), nee_w), throughput), reflect_color);
        radiance = add(radiance, sel(nee_ok, contrib, zero));
    }
    put3(p, R_RAD, i, radiance);

    const f3 d_dir = disney::sample(at(p.s[U], i, 3), at(p.s[U], i, 4), at(p.s[U], i, 5), d,
                                    fnormal, p0, p1);
    float d_brdf, d_pdf;
    disney::evaluate_pdf(fnormal, neg(d), d_dir, p0, p1, p.corrected, d_brdf, d_pdf);
    d_brdf = d_brdf * fabsf(disney::dot(normal, d_dir));

    const f3 next_dir = sel(is_glass, g_dir, d_dir);
    const float f_or_b = is_glass ? g_forb : 1.0f;
    const float brdf = is_glass ? 1.0f : d_brdf;
    const float brdf_pdf = is_glass ? 1.0f : d_pdf;
    const bool new_perfect_spec = is_glass | (!is_disney & perfect_spec);

    const f3 next_origin = offset_ray(pos, scale(fnormal, sign_nonzero(f_or_b)));

    // Beer-Lambert transmission roulette
    const bool transmitted = f_or_b < 0.0f;
    const float beer_r = exp_f(-t / disney::clamp_min(p1, (float)1e-12));
    const bool beer_kill = transmitted & (at(p.s[U], i, 6) >= beer_r);

    const bool cont = (is_glass | is_disney) & (brdf_pdf > 0.0f) & !beer_kill;
    const f3 weighted = mul(scale(throughput, brdf / disney::clamp_min(brdf_pdf, (float)1e-12)),
                            reflect_color);
    put3(p, R_THR, i, sel(cont, weighted, throughput));
    put3(p, R_ORIGIN, i, sel(cont, next_origin, f3{PARK_F, PARK_F, PARK_F}));
    put3(p, R_DIR, i, sel(cont, next_dir, d));
    put(p, R_BPDF, i, cont ? brdf_pdf : brdf_pdf_prev);
    put_flag(p, F_ALIVE, i, cont);
    put_flag(p, F_PS, i, cont ? new_perfect_spec : perfect_spec);
}

}  // namespace pt

__global__ void __launch_bounds__(THREADS) pt_shade_kernel(const pt::params p) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= p.count) return;
    pt::shade_lane(p, i);
}

// The probe of pt_math_launch: out[i] = pow_f(x[i], e) (pow true) or
// exp_f(x[i]).
__global__ void __launch_bounds__(THREADS)
pt_math_kernel(bool pow, float e, const float* __restrict__ x, float* __restrict__ out,
               long long count) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= count) return;
    out[i] = pow ? pt::pow_f(x[i], e) : pt::exp_f(x[i]);
}

static unsigned int blocks_for(long long count) {
    return (unsigned int)((count + THREADS - 1) / THREADS);
}

extern "C" {

// Launch on `stream` (a cudaStream_t) for count > 0 lanes.  words: 3 per
// input slot in pt::slot_id order (pointer, row stride, lane stride; strides
// in elements; slots a mode does not read may be 0).  mode: pt::FULL, HEAD or
// TAIL; out: contiguous float32 rows of count, rows 0-18 written (0-2 under
// HEAD; see out_row), flags a contiguous (2, count) bool block (1 under
// HEAD).  Returns cudaGetLastError() as int.
int pt_shade_launch(const long long* words, int mode, int corrected, long long n_lights,
                    float* out, unsigned char* flags, long long count, void* stream) {
    pt::params p;
    for (int k = 0; k < pt::N_SLOTS; ++k) {
        p.s[k] = pt::slot{(const void*)words[3 * k], words[3 * k + 1], words[3 * k + 2]};
    }
    p.out = out;
    p.flags = flags;
    p.count = count;
    p.n_lights = (float)n_lights;
    p.e_srgb = (float)2.4;
    p.e_schlick = 5.0f;
    p.mode = mode;
    p.corrected = corrected != 0;
    pt_shade_kernel<<<blocks_for(count), THREADS, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

// The probe: out = pow_f(x, e) (pow != 0) or exp_f(x) over count > 0
// contiguous float32 values.
int pt_math_launch(int pow, float e, const float* x, float* out, long long count,
                   void* stream) {
    pt_math_kernel<<<blocks_for(count), THREADS, 0, (cudaStream_t)stream>>>(pow != 0, e, x, out,
                                                                             count);
    return (int)cudaGetLastError();
}

const char* pt_shade_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
