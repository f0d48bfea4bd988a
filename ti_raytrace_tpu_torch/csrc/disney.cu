// The Disney BSDF of the wavefront loop for Hopper (sm_90a): two kernels,
// one lane per thread, over the math of disney.cuh.
//
// Replaces no TPU kernel: the JAX package leaves its Disney BSDF
// (ti_raytrace_tpu/bsdf/planar.py::disney_evaluate_pdf, disney_sample)
// to XLA, which fuses each call into a loop fusion.  In the port the plain
// twins (bsdf/planar.py::disney_evaluate_pdf_plain, disney_sample_plain)
// are some 100 elementwise launches and 148 (evaluate) or 289 (sample)
// top-level torch calls each, and every integrator calls them several
// times a bounce: the host's dispatch, not the card, is the cost.  Each
// kernel is one launch and equals its twin on the card bit for bit (the
// argument is in disney.cuh).
//
// What bounds it on an H100: bytes.  Per lane, evaluate_pdf reads 11
// floats (n, v, l, metallic, roughness: 44 B) and writes 2 (8 B); sample
// reads 11 (u3, in_dir, n, metallic, roughness) and writes 3 (12 B).  At
// 3.35 TB/s that is ~2.0 us (evaluate) and ~2.2 us (sample) for 131,072
// lanes.  The arithmetic, some 150 (evaluate) and 300 (sample, with its
// four sinf/cosf) instructions a lane at 128 a clock per SM, takes less
// (~0.6 and ~1.2 us at 1,980 MHz), and at such widths a launch's own
// latency of a few us is larger than either: the design only has to read
// and write each value once, coalesced.
//
// Design: THREADS threads per block, one lane each, no shared memory, no
// synchronisation.  Inputs are read through their strides (a (3, N)
// vector by its row and lane strides, a (N,) scalar by its lane stride),
// so a row slice, a transposed view or an expanded (stride 0) tensor
// needs no copy; neighbouring threads read neighbouring lanes when the
// lane stride is 1.  Outputs are contiguous: evaluate writes a (2, N)
// block (brdf row, pdf row), sample a (3, N) block.

#include <cuda_runtime.h>

#include "disney.cuh"

#define THREADS 256

struct vec3_in {  // (3, N) float32 by strides (elements)
    const float* p;
    long long row, lane;
};

struct lane_in {  // (N,) float32 by stride (elements)
    const float* p;
    long long lane;
};

__device__ __forceinline__ disney::f3 load3(const vec3_in& a, long long i) {
    const float* q = a.p + i * a.lane;
    return {q[0], q[a.row], q[2 * a.row]};
}

__device__ __forceinline__ float load1(const lane_in& a, long long i) {
    return a.p[i * a.lane];
}

__global__ void __launch_bounds__(THREADS)
disney_evaluate_pdf_kernel(vec3_in n, vec3_in v, vec3_in l, lane_in metallic, lane_in roughness,
                           bool true_pdf, float* __restrict__ out, long long count) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= count) return;
    float brdf, pdf;
    disney::evaluate_pdf(load3(n, i), load3(v, i), load3(l, i), load1(metallic, i),
                         load1(roughness, i), true_pdf, brdf, pdf);
    out[i] = brdf;
    out[count + i] = pdf;
}

__global__ void __launch_bounds__(THREADS)
disney_sample_kernel(vec3_in u3, vec3_in in_dir, vec3_in n, lane_in metallic, lane_in roughness,
                     float* __restrict__ out, long long count) {
    const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (i >= count) return;
    const disney::f3 u = load3(u3, i);
    const disney::f3 d = disney::sample(u.x, u.y, u.z, load3(in_dir, i), load3(n, i),
                                        load1(metallic, i), load1(roughness, i));
    out[i] = d.x;
    out[count + i] = d.y;
    out[2 * count + i] = d.z;
}

static unsigned int blocks_for(long long count) {
    return (unsigned int)((count + THREADS - 1) / THREADS);
}

extern "C" {

// Launch on `stream` (a cudaStream_t) for count > 0 lanes.  Each (3, N)
// input comes as (pointer, row stride, lane stride), each (N,) input as
// (pointer, lane stride), strides in elements; out is a contiguous (2,
// count) block (brdf, pdf).  Returns cudaGetLastError() as int.
int disney_evaluate_pdf_launch(const float* n, long long n_row, long long n_lane,
                               const float* v, long long v_row, long long v_lane,
                               const float* l, long long l_row, long long l_lane,
                               const float* metallic, long long metallic_lane,
                               const float* roughness, long long roughness_lane, int true_pdf,
                               float* out, long long count, void* stream) {
    disney_evaluate_pdf_kernel<<<blocks_for(count), THREADS, 0, (cudaStream_t)stream>>>(
        vec3_in{n, n_row, n_lane}, vec3_in{v, v_row, v_lane}, vec3_in{l, l_row, l_lane},
        lane_in{metallic, metallic_lane}, lane_in{roughness, roughness_lane}, true_pdf != 0, out,
        count);
    return (int)cudaGetLastError();
}

// As above for disney_sample; out is a contiguous (3, count) block.
int disney_sample_launch(const float* u3, long long u3_row, long long u3_lane,
                         const float* in_dir, long long in_dir_row, long long in_dir_lane,
                         const float* n, long long n_row, long long n_lane,
                         const float* metallic, long long metallic_lane,
                         const float* roughness, long long roughness_lane,
                         float* out, long long count, void* stream) {
    disney_sample_kernel<<<blocks_for(count), THREADS, 0, (cudaStream_t)stream>>>(
        vec3_in{u3, u3_row, u3_lane}, vec3_in{in_dir, in_dir_row, in_dir_lane},
        vec3_in{n, n_row, n_lane}, lane_in{metallic, metallic_lane},
        lane_in{roughness, roughness_lane}, out, count);
    return (int)cudaGetLastError();
}

const char* disney_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
