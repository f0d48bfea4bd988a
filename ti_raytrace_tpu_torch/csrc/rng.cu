// Threefry-2x32 uniforms for Hopper (sm_90a).
//
// Replaces jax.random.uniform(key, shape, float32) with the threefry2x32
// implementation in its partitionable form, as the JAX package draws it
// inside jitted functions (ti_raytrace_tpu/integrators/pt_rgb.py:186,
// :514, camera.py:192, bdpt_rgb.py:219, :466, :706, :960, pt_spec.py:156,
// :345, bdpt_spec.py:97).  Not a Pallas kernel: XLA compiles each draw
// into one loop fusion.  Its plain PyTorch twin is
// ti_raytrace_tpu_torch/core/rng.py::uniform_plain (int64 tensor ops
// masked to 32 bits, ~180 torch calls per draw), which the kernel equals
// bit for bit.  Element i of the row-major flattened output:
//   ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
//   x0 = (i >> 32) + ks[0], y = (i & 0xFFFFFFFF) + ks[1]   (64-bit i)
//   5 groups g of 4 rounds (rotations 13 15 26 6, then 17 29 16 24):
//     x0 += y; y = rotl(y, r) ^ x0
//   after group g: x0 += ks[(g+1)%3]; y += ks[(g+2)%3] + g + 1
//   bits = x0 ^ y; out = float((bits >> 9) | 0x3F800000) - 1.0f
// The float in [1, 2) has the top 23 bits as its mantissa; subtracting 1
// is exact, so every output equals the plain version's bits.
//
// What bounds it on an H100: operations.  Per element, counted from this
// source: 75 32-bit integer operations (2 initial adds; 20 rounds of an
// add, a funnel shift and a xor; 5 injections of two adds, their
// constants ks + g + 1 hoisted out of the loop; the final xor, shift and
// or) and one FP32 subtract.  The 43 shifts and logic ops run only on the
// integer ALU pipe (64 lanes per clock per SM); the 32 adds may also issue
// as IMAD on the FMA pipe, and ptxas moves 19 of them there (cuobjdump
// -sass: 77 instructions per element, 54 of them on the ALU pipe).  So the
// least time is max(43 / 64, 75 / 128 issued) clocks per element and SM
// lane: ~5.4 us for (8, 262,144) on 132 SMs at 1,980 MHz.  (At 64 integer
// operations per clock for all 75 it would be ~9.4 us, which the kernel
// beats on the wide draws.)  The bytes are 4 per element written and none
// read (~2.5 us at 3.35 TB/s for the same draw).
//
// Design, right and simple first: a grid-stride loop over the 64-bit
// element index, one element per thread per step, THREADS threads per
// block; neighbouring threads store neighbouring floats (coalesced).
// Nothing is read, nothing is allocated and nothing is synchronised.
// The device-key twins (threefry_uniform_key_kernel, threefry_keys_kernel,
// below) read the key's two words from device memory instead.
//
// Layout: out (n) f32, row-major over the caller's shape.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_BLOCKS 65536  // the grid-stride loop covers the rest

__device__ __forceinline__ void mix(uint32_t& x, uint32_t& y, int r) {
    x += y;
    y = __funnelshift_l(y, y, r) ^ x;
}

// Four rounds with the rotations of an even (13 15 26 6) or odd group.
__device__ __forceinline__ void group(uint32_t& x, uint32_t& y, bool odd) {
    mix(x, y, odd ? 17 : 13);
    mix(x, y, odd ? 29 : 15);
    mix(x, y, odd ? 16 : 26);
    mix(x, y, odd ? 24 : 6);
}

// Threefry-2x32 of the counter pair (x, y) under the key (k1, k2), in place.
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2, uint32_t& x, uint32_t& y) {
    const uint32_t ks0 = k1, ks1 = k2, ks2 = k1 ^ k2 ^ 0x1BD11BDAu;
    x += ks0;
    y += ks1;
    group(x, y, false);
    x += ks1;
    y += ks2 + 1u;
    group(x, y, true);
    x += ks2;
    y += ks0 + 2u;
    group(x, y, false);
    x += ks0;
    y += ks1 + 3u;
    group(x, y, true);
    x += ks1;
    y += ks2 + 4u;
    group(x, y, false);
    x += ks2;
    y += ks0 + 5u;
}

__device__ __forceinline__ void uniform_into(float* __restrict__ out, uint32_t k1, uint32_t k2,
                                             long long n) {
    const long long stride = (long long)gridDim.x * THREADS;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n; i += stride) {
        uint32_t x = (uint32_t)((unsigned long long)i >> 32);
        uint32_t y = (uint32_t)i;
        threefry(k1, k2, x, y);
        const uint32_t bits = x ^ y;
        out[i] = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    }
}

__global__ void __launch_bounds__(THREADS)
threefry_uniform_kernel(float* __restrict__ out, uint32_t k1, uint32_t k2, long long n) {
    uniform_into(out, k1, k2, n);
}

// Device keys (core/rng.DeviceKey): the key's two words are read from
// device memory (int64, low 32 bits) when the kernel runs, so a render
// captured into a CUDA graph draws from whatever key was written there
// before each replay.  The same draw as threefry_uniform_kernel.
__global__ void __launch_bounds__(THREADS)
threefry_uniform_key_kernel(float* __restrict__ out, const long long* __restrict__ key,
                            long long n) {
    uniform_into(out, (uint32_t)key[0], (uint32_t)key[1], n);
}

// Key i of `num`: threefry(key, (0, first + i)) as two int64 words, the
// plain chain's split (first 0) and fold_in (first = data, num 1).
__global__ void __launch_bounds__(THREADS)
threefry_keys_kernel(const long long* __restrict__ key, long long* __restrict__ out,
                     uint32_t first, uint32_t num) {
    const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= num) return;
    uint32_t x = 0u, y = first + i;
    threefry((uint32_t)key[0], (uint32_t)key[1], x, y);
    out[2 * i] = (long long)x;
    out[2 * i + 1] = (long long)y;
}

extern "C" {

// Launch on `stream` (a cudaStream_t) for n > 0 elements.  Returns
// cudaGetLastError() as int.
int threefry_uniform_launch(float* out, unsigned int k1, unsigned int k2, long long n,
                            void* stream) {
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    threefry_uniform_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        out, k1, k2, n);
    return (int)cudaGetLastError();
}

// The device-key draw on `stream` for n > 0 elements.
int threefry_uniform_key_launch(float* out, const long long* key, long long n, void* stream) {
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    threefry_uniform_key_kernel<<<(unsigned int)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        out, key, n);
    return (int)cudaGetLastError();
}

// num > 0 device keys derived from `key` into out (num, 2) on `stream`.
int threefry_keys_launch(const long long* key, long long* out, unsigned int first,
                         unsigned int num, void* stream) {
    threefry_keys_kernel<<<(num + THREADS - 1) / THREADS, THREADS, 0, (cudaStream_t)stream>>>(
        key, out, first, num);
    return (int)cudaGetLastError();
}

const char* threefry_uniform_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
