// Dense closest-hit sweep for Hopper (sm_90a).
//
// Replaces ti_raytrace_tpu/ops/dense_trace.py::_sweep, the JAX package's
// dense tracer (not a Pallas kernel: a `lax.fori_loop` over 128-prim
// blocks that XLA compiles into one loop).  Its plain PyTorch twin is
// ti_raytrace_tpu_torch/ops/dense_trace.py::_sweep, which the kernel
// equals bit for bit.  For each lane, every prim 0..P-1 in index order:
//   * a triangle row gets two-sided Moller-Trumbore's t (`_triangle_t_uv`);
//   * a sphere row gets the nearest root of the quadratic where the ray's
//     squared distance to the centre is below rad^2 (`_block_t_uv`);
//   * any other row (a laser or quad shape, padding) gets INF;
//   * then t > 0 ? t : INF, and the best hit is replaced only on a strict
//     `<`, so among equal t the lowest prim index wins (the plain
//     version's first minimum in a block, strict `<` across blocks).
// A lane with no hit leaves with (INF, -1).
//
// What bounds it on an H100: operations.  Every lane tests every prim,
// ~60 FP32 operations each (tools/dense_sweep.py::sweep_bound_ms: lanes x
// prims x 60 at 67 TFLOP/s); the bytes are ~32 per lane (rays in, t and
// prim out) plus 64 per prim, far below that.  Under -fmad=false no
// product fuses with a sum, so at most half of that peak is reachable.
//
// Design, right and simple first: one thread per lane, THREADS lanes per
// block.  The block stages the prim table through shared memory in tiles
// of TILE_ROWS rows; every thread of a warp reads the same row (a
// broadcast) and keeps (best_t, best_prim) in registers.  Nothing is
// allocated and nothing is written but the two outputs.  Narrow
// wavefronts give fewer blocks than the card has SMs: slow, not wrong.
//
// Numerics: compiled with -fmad=false and IEEE division and square root,
// every expression in the plain version's operation order (sums left to
// right, sign(0) = 0, the reciprocal of adet, then t * inv), so the
// results equal the plain version's bit for bit.  A NaN t (0 x INF in a
// degenerate test) fails `t > 0` and becomes INF, as there.  The clamps
// are written as `x < lo ? lo : x`: like torch.clamp they keep a NaN,
// where fmaxf would replace it.
//
// Layout (f32, row-major):
//   o, d    (3, n) planar ray origins / directions
//   table   (n_prims, 16) rows of ops/dense_trace.py::dense_table:
//           0:3 v0, 3:6 e1, 6:9 e2, 9 kind (KIND_*), 10:13 sphere centre,
//           13 radius, 14:16 zero; 16-byte aligned
//   outputs t (n) f32, prim (n) int32 (-1 = miss)

#include <cuda_runtime.h>

#define THREADS 256
#define TILE_ROWS 128  // prim rows staged per pass: 8 KB of shared memory
#define ROW_F4 4       // float4s per table row
#define KIND_TRI 1.0f
#define KIND_SPHERE 2.0f
#define INF_T 1.0e6f

__device__ __forceinline__ float sign_of(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__global__ void __launch_bounds__(THREADS)
dense_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d, int n,
                   const float4* __restrict__ table, int n_prims, float* __restrict__ t_out,
                   int* __restrict__ prim_out) {
    __shared__ float4 rows[TILE_ROWS * ROW_F4];
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    const bool live = lane < n;
    const size_t N = (size_t)n;
    // dead lanes of the last block sweep a zero ray (det = 0 and a = 0:
    // every test misses) and write nothing
    const float ox = live ? o[lane] : 0.0f, oy = live ? o[N + lane] : 0.0f,
                oz = live ? o[2 * N + lane] : 0.0f;
    const float dx = live ? d[lane] : 0.0f, dy = live ? d[N + lane] : 0.0f,
                dz = live ? d[2 * N + lane] : 0.0f;
    // the sphere test's per-lane terms: a = |d|^2, the plain version's
    // clamp(a, min=1e-12) and 2 * that (the same bits at every prim)
    const float a = (dx * dx + dy * dy) + dz * dz;
    const float a4 = 4.0f * a;
    const float a2 = 2.0f * (a < 1e-12f ? 1e-12f : a);

    float best_t = INF_T;
    int best_prim = -1;
    for (int p0 = 0; p0 < n_prims; p0 += TILE_ROWS) {
        const int n_rows = min(TILE_ROWS, n_prims - p0);
        __syncthreads();  // the previous tile is read by every thread
        for (int i = threadIdx.x; i < n_rows * ROW_F4; i += THREADS) {
            rows[i] = table[(size_t)p0 * ROW_F4 + i];
        }
        __syncthreads();
#pragma unroll 2
        for (int r = 0; r < n_rows; ++r) {
            const float4 r0 = rows[r * ROW_F4], r1 = rows[r * ROW_F4 + 1],
                         r2 = rows[r * ROW_F4 + 2], r3 = rows[r * ROW_F4 + 3];
            const float kind = r2.y;
            float t = INF_T;
            if (kind == KIND_TRI) {
                const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
                const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
                const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
                const float px = dy * e2z - dz * e2y;
                const float py = dz * e2x - dx * e2z;
                const float pz = dx * e2y - dy * e2x;
                const float det = (e1x * px + e1y * py) + e1z * pz;
                const float s = sign_of(det);
                const float adet = fabsf(det);
                const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
                const float u = ((tx * px + ty * py) + tz * pz) * s;
                const float qx = ty * e1z - tz * e1y;
                const float qy = tz * e1x - tx * e1z;
                const float qz = tx * e1y - ty * e1x;
                const float v = ((dx * qx + dy * qy) + dz * qz) * s;
                const float tt = ((e2x * qx + e2y * qy) + e2z * qz) * s;
                const bool nondegenerate = adet > 1e-12f;
                const bool ok = nondegenerate && u >= 0.0f && u <= adet && v >= 0.0f &&
                                u + v <= adet;
                if (ok) t = tt * (1.0f / adet);  // ok implies inv = 1 / adet
            } else if (kind == KIND_SPHERE) {
                const float ocx = r2.z - ox, ocy = r2.w - oy, ocz = r3.x - oz;
                const float rad = r3.y;
                const float oc2 = (ocx * ocx + ocy * ocy) + ocz * ocz;
                const float dop = (dx * ocx + dy * ocy) + dz * ocz;
                const float disc2 = oc2 - dop * dop;
                const float b = -2.0f * dop;
                const float cc = oc2 - rad * rad;
                float discr = b * b - a4 * cc;
                discr = discr < 0.0f ? 0.0f : discr;
                const float t_sph = (-b - sqrtf(discr)) / a2;
                if (disc2 < rad * rad) t = t_sph;
            }
            t = t > 0.0f ? t : INF_T;
            if (t < best_t) {
                best_t = t;
                best_prim = p0 + r;
            }
        }
    }
    if (live) {
        t_out[lane] = best_t;
        prim_out[lane] = best_prim;
    }
}

extern "C" {

// Launch on `stream` (a cudaStream_t) for n > 0 lanes.  Returns
// cudaGetLastError() as int.
int dense_sweep_launch(const float* o, const float* d, int n, const float* table, int n_prims,
                       float* t_out, int* prim_out, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    dense_sweep_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        o, d, n, reinterpret_cast<const float4*>(table), n_prims, t_out, prim_out);
    return (int)cudaGetLastError();
}

const char* dense_sweep_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
