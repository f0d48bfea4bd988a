// The cluster tracer's coherence sort key for Hopper (sm_90a): one int64 a
// lane, (origin morton << 30) | direction morton, in one launch.
//
// Replaces no TPU kernel: the JAX package builds the key with plain XLA
// (ti_raytrace_tpu/ops/cluster_trace.py, `_coherence_key`, then
// jax.lax.sort).  In the port the plain twin
// (ops/cluster_trace.coherence_key60_plain, with the padding and masks of
// `_sort_key_plain`) is some 130 top-level int64 torch calls a wavefront:
// two utils/morton.morton3d codes of three expand_bits each, the
// quantisation, the where and the pad.  Each is a small elementwise launch
// that the card runs in a few us while the host dispatches the next.  The
// stable sort of the key stays torch.sort.
//
// Lane i of n_pad:
//   i >= n, or active given and !active[i]:  key = PAD_KEY (1 << 62);
//   else  span = clamp(hi - lo, min=1e-12)            (the scene box)
//         qo[k] = q((o[k] - lo[k]) / span[k])         k = x, y, z
//         qd[k] = q(d[k] * 0.5 + 0.5)
//         q(c)  = int64(clamp(c * 1024, 0, 1023))
//         key   = (morton(qo) << 30) | morton(qd)
//         alive given and !alive[i]: key |= 1 << 60   (the dead lanes last)
//   morton(x, y, z) = expand(x) | expand(y) << 1 | expand(z) << 2, with
//   utils/morton.expand_bits's four shift-or-mask steps.
//
// Equality with the plain twin: each float32 operation is the one ATen's
// CUDA kernel computes, rounded on its own (the __f*_rn intrinsics are never
// contracted into a fused multiply-add).  lo[k] and span[k] are 0-dim CUDA
// tensors there, not CPU scalars, so `/ span[k]` is ATen's true division
// (div.rn), not a product with a reciprocal; `d * 0.5 + 0.5` multiplies and
// adds by Python scalars that are exact in float.  torch.clamp keeps a NaN
// (ATen's clamp returns a NaN operand as it is), and the float -> int64
// cast is ATen's static_cast, cvt.rzi.s64.f32, here __float2ll_rz: NaN and
// the bits it casts to go through the interleave as in the twin.  The
// integer steps run on 64-bit unsigned words, as ATen's shifts do for int64.
// So every key equals the twin's on the card bit for bit.
//
// What bounds it on an H100: bytes, the arithmetic close behind.  Per lane
// it reads 24 B (o and d, 3 floats each), one mask byte where a mask is
// given, and writes the 8 B key: 33 B with one mask, 10.3 us for 1,048,576
// lanes at 3.35 TB/s.  The arithmetic is of the same order: 18 float
// operations (three of them divisions of several instructions) and six
// interleaves of 12 steps on 64-bit words, two or more 32-bit instructions
// a step, some 250 instructions a lane, ~8 us at that width at 128 a clock
// per SM.  On an H100 the kernel ran at 0.58-0.63 of the bytes bound on
// wavefronts of 0.8-2.6M lanes (chip_smoke.py, phase 29).
//
// Design: a grid-stride loop, THREADS threads per block, one lane per
// thread per step; o and d are read through their strides (a carry's rows
// are views of one block), the box's six floats through theirs, the masks
// through their lane strides.  Neighbouring threads read neighbouring
// floats and write neighbouring keys.  No shared memory, no
// synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_BLOCKS 65536  // the grid-stride loop covers the rest

#define PAD_KEY (1ULL << 62)
#define DEAD_BIT (1ULL << 60)

// utils/morton.expand_bits: 10 bits -> 30 bits with 2-bit gaps.
__device__ __forceinline__ uint64_t expand_bits(uint64_t x) {
    x = (x | (x << 16)) & 0x030000FFULL;
    x = (x | (x << 8)) & 0x0300F00FULL;
    x = (x | (x << 4)) & 0x030C30C3ULL;
    x = (x | (x << 2)) & 0x09249249ULL;
    return x;
}

// utils/morton.morton3d's quantisation: clamp(c * 1024, 0, 1023) keeping a
// NaN, then ATen's float -> int64 cast.
__device__ __forceinline__ uint64_t quantise(float c) {
    float v = __fmul_rn(c, 1024.0f);
    if (!isnan(v)) v = fminf(fmaxf(v, 0.0f), 1023.0f);
    return (uint64_t)__float2ll_rz(v);
}

__device__ __forceinline__ uint64_t morton3(float x, float y, float z) {
    return expand_bits(quantise(x)) | (expand_bits(quantise(y)) << 1)
        | (expand_bits(quantise(z)) << 2);
}

__global__ void __launch_bounds__(THREADS)
coherence_key_kernel(const float* __restrict__ o, long long o_row, long long o_lane,
                     const float* __restrict__ d, long long d_row, long long d_lane,
                     const float* __restrict__ lo, long long lo_stride,
                     const float* __restrict__ hi, long long hi_stride,
                     const bool* __restrict__ active, long long active_lane,
                     const bool* __restrict__ alive, long long alive_lane,
                     unsigned long long* __restrict__ key, long long n, long long n_pad) {
    float lo_k[3], span[3];
    for (int k = 0; k < 3; ++k) {
        lo_k[k] = lo[k * lo_stride];
        const float s = __fsub_rn(hi[k * hi_stride], lo_k[k]);
        span[k] = isnan(s) ? s : fmaxf(s, 1e-12f);  // torch.clamp(min=1e-12)
    }
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n_pad; i += stride) {
        if (i >= n || (active != nullptr && !active[i * active_lane])) {
            key[i] = PAD_KEY;
            continue;
        }
        float q[3], h[3];
        for (int k = 0; k < 3; ++k) {
            q[k] = __fdiv_rn(__fsub_rn(o[k * o_row + i * o_lane], lo_k[k]), span[k]);
            h[k] = __fadd_rn(__fmul_rn(d[k * d_row + i * d_lane], 0.5f), 0.5f);
        }
        uint64_t k60 = (morton3(q[0], q[1], q[2]) << 30) | morton3(h[0], h[1], h[2]);
        if (alive != nullptr && !alive[i * alive_lane]) k60 |= DEAD_BIT;
        key[i] = k60;
    }
}

extern "C" {

// Launch on `stream` (a cudaStream_t) for n_pad > 0 lanes, n <= n_pad of
// them keyed; `active` and `alive` may be null.  Strides are in elements.
// Returns cudaGetLastError() as int.
int coherence_key_launch(const float* o, long long o_row, long long o_lane, const float* d,
                         long long d_row, long long d_lane, const float* lo, long long lo_stride,
                         const float* hi, long long hi_stride, const bool* active,
                         long long active_lane, const bool* alive, long long alive_lane,
                         long long* key, long long n, long long n_pad, void* stream) {
    long long blocks = (n_pad + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    coherence_key_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        o, o_row, o_lane, d, d_row, d_lane, lo, lo_stride, hi, hi_stride, active, active_lane,
        alive, alive_lane, (unsigned long long*)key, n, n_pad);
    return (int)cudaGetLastError();
}

const char* coherence_key_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
