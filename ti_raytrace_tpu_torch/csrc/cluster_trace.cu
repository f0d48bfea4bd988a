// Cluster-stream closest-hit traversal for Hopper (sm_90a).
//
// Replaces ti_raytrace_tpu/ops/cluster_trace.py::_kernel, the JAX
// package's Pallas TPU kernel: for each ray, the closest hit among
// clusters of 128 triangles visited in a front-to-back order.
//
// What bounds it on an H100: the narrow phase, ~40 FLOPs per (ray,
// triangle) pair of every cluster a ray must test, and the L2 reads of
// the triangle table (12 x 128 floats per cluster, ~5.5 MB for the 100k
// scene, which stays resident in the 50 MB L2).  The design answers with
//   * block-level cluster skipping: a block (one 256-ray tile) walks the
//     tile's cluster order, every thread slab-tests its own ray against
//     the cluster box, and the block touches the cluster's triangles only
//     if some ray is a candidate (__syncthreads_or) — rays whose current
//     best hit lies before the box entry prune it (front-to-back);
//   * shared-memory staging: a visited cluster's triangle rows are read
//     from L2 once per block into shared memory, and every candidate
//     thread reads them from there (all threads read the same triangle,
//     a broadcast without bank conflicts).
// Warp-level candidate compaction, persistent blocks and the reference's
// supercluster pre-pass are left to later work.
//
// Numerics: compiled with -fmad=false, and every formula keeps the
// reference's operation order, so results equal the plain PyTorch version
// (ops/cluster_trace.py::cluster_trace_plain) to rounding.  Ties keep the
// reference's rule: strict `<` updates, so the winner is the first
// cluster in order with the minimal t, then the lowest triangle slot.
//
// Layout (all f32 planar, row-major):
//   o, d        (3, n_pad) ray origins / directions, n_pad = tiles * 256;
//               lanes >= n_valid are padding and never candidates
//   tmax        (n_pad) per-lane distance bound, or NULL: best_t starts at
//               the bound where it is > 0 (INF otherwise), so every cluster
//               and triangle beyond it is pruned, and a lane whose closest
//               hit lies at or beyond it leaves with t == tmax, prim == -1
//               (the reference's ray column 6)
//   bounds      (8, C): rows 0:3 box min, 3:6 box max, 6 validity (> 0)
//   order       (1, C) shared or (n_tiles, C) per-tile int32 sweep order
//   tri         (12, C * 128), one of two forms:
//               generic   [v0 | e1 | e2 | pid]          (rows 0..9)
//               origin_mt [n | s | q | pid | tconst]    (rows 0..10),
//               the shared-origin table of _origin_mt_table
//   outputs     t, prim (int32, -1 = miss), u, v (n_pad); visited
//               (n_tiles) = clusters whose triangles the block tested.

#include <cuda_runtime.h>

#define TILE 256
#define CLUSTER_B 128
#define MAX_ROWS 11
#define INF_T 1.0e6f

__device__ __forceinline__ float safe_inv(float v) {
    return 1.0f / (fabsf(v) < 1e-12f ? (v >= 0.0f ? 1e-12f : -1e-12f) : v);
}

__device__ __forceinline__ float sign_of(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__global__ void __launch_bounds__(TILE)
cluster_trace_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmax, int n_pad, int n_valid,
                     const float* __restrict__ bounds, int n_clusters,
                     const int* __restrict__ order, int order_per_tile,
                     const float* __restrict__ tri, int origin_mt,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     int* __restrict__ visited_out) {
    __shared__ float s_tri[MAX_ROWS * CLUSTER_B];

    const int tile = blockIdx.x;
    const int lane = tile * TILE + threadIdx.x;
    const bool live = lane < n_valid;
    const float ox = o[lane], oy = o[n_pad + lane], oz = o[2 * n_pad + lane];
    const float dx = d[lane], dy = d[n_pad + lane], dz = d[2 * n_pad + lane];
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

    const size_t tri_stride = (size_t)n_clusters * CLUSTER_B;
    const int rows = origin_mt ? 11 : 10;
    const int* ord = order + (order_per_tile ? (size_t)tile * n_clusters : 0);

    const float bound = tmax ? tmax[lane] : 0.0f;
    float best_t = bound > 0.0f ? bound : INF_T, best_u = 0.0f, best_v = 0.0f;
    int best_p = -1;
    int visited = 0;

    for (int k = 0; k < n_clusters; ++k) {
        const int cid = ord[k];
        // slab test (reference _kernel.slab): row 6 is the validity flag
        const float t1x = (bounds[0 * n_clusters + cid] - ox) * ix;
        const float t2x = (bounds[3 * n_clusters + cid] - ox) * ix;
        float tn = fminf(t1x, t2x), tf = fmaxf(t1x, t2x);
        const float t1y = (bounds[1 * n_clusters + cid] - oy) * iy;
        const float t2y = (bounds[4 * n_clusters + cid] - oy) * iy;
        tn = fmaxf(tn, fminf(t1y, t2y));
        tf = fminf(tf, fmaxf(t1y, t2y));
        const float t1z = (bounds[2 * n_clusters + cid] - oz) * iz;
        const float t2z = (bounds[5 * n_clusters + cid] - oz) * iz;
        tn = fmaxf(tn, fminf(t1z, t2z));
        tf = fminf(tf, fmaxf(t1z, t2z));
        const bool cand = live && fmaxf(tn, 0.0f) <= tf &&
                          bounds[6 * n_clusters + cid] > 0.0f && tn < best_t;
        if (!__syncthreads_or(cand)) continue;  // uniform across the block

        const float* src = tri + (size_t)cid * CLUSTER_B;
        for (int i = threadIdx.x; i < rows * CLUSTER_B; i += TILE) {
            s_tri[i] = src[(size_t)(i / CLUSTER_B) * tri_stride + (i % CLUSTER_B)];
        }
        __syncthreads();
        ++visited;

        if (cand) {
            float tmin = INF_T, wu = 0.0f, wv = 0.0f;
            int wp = -1;
            for (int j = 0; j < CLUSTER_B; ++j) {
                float det, u, v, t;
                if (origin_mt) {
                    // det = d.n, u = d.s, v = d.q, t = tconst (_origin_mt_table)
                    det = dx * s_tri[0 * CLUSTER_B + j] + dy * s_tri[1 * CLUSTER_B + j]
                          + dz * s_tri[2 * CLUSTER_B + j];
                    const float sg = sign_of(det);
                    u = (dx * s_tri[3 * CLUSTER_B + j] + dy * s_tri[4 * CLUSTER_B + j]
                         + dz * s_tri[5 * CLUSTER_B + j]) * sg;
                    v = (dx * s_tri[6 * CLUSTER_B + j] + dy * s_tri[7 * CLUSTER_B + j]
                         + dz * s_tri[8 * CLUSTER_B + j]) * sg;
                    t = s_tri[10 * CLUSTER_B + j] * sg;
                } else {
                    // two-sided Moller-Trumbore, generic form
                    const float v0x = s_tri[0 * CLUSTER_B + j], v0y = s_tri[1 * CLUSTER_B + j],
                                v0z = s_tri[2 * CLUSTER_B + j];
                    const float e1x = s_tri[3 * CLUSTER_B + j], e1y = s_tri[4 * CLUSTER_B + j],
                                e1z = s_tri[5 * CLUSTER_B + j];
                    const float e2x = s_tri[6 * CLUSTER_B + j], e2y = s_tri[7 * CLUSTER_B + j],
                                e2z = s_tri[8 * CLUSTER_B + j];
                    const float px = dy * e2z - dz * e2y;
                    const float py = dz * e2x - dx * e2z;
                    const float pz = dx * e2y - dy * e2x;
                    det = e1x * px + e1y * py + e1z * pz;
                    const float sg = sign_of(det);
                    const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
                    u = (tx * px + ty * py + tz * pz) * sg;
                    const float qx = ty * e1z - tz * e1y;
                    const float qy = tz * e1x - tx * e1z;
                    const float qz = tx * e1y - ty * e1x;
                    v = (dx * qx + dy * qy + dz * qz) * sg;
                    t = (e2x * qx + e2y * qy + e2z * qz) * sg;
                }
                const float adet = fabsf(det);
                const bool ok = adet > 1e-12f && u >= 0.0f && u <= adet && v >= 0.0f &&
                                u + v <= adet;
                const float inv = 1.0f / (adet > 1e-12f ? adet : 1.0f);
                t = ok ? t * inv : INF_T;
                t = t > 0.0f ? t : INF_T;
                if (t < tmin) {  // strict: the first slot of the minimum wins
                    tmin = t;
                    wu = u * inv;
                    wv = v * inv;
                    wp = (int)s_tri[9 * CLUSTER_B + j];
                }
            }
            if (tmin < best_t) {
                best_t = tmin;
                best_u = wu;
                best_v = wv;
                best_p = wp;
            }
        }
        __syncthreads();  // s_tri is rewritten by the next visit
    }

    t_out[lane] = best_t;
    prim_out[lane] = best_p;
    u_out[lane] = best_u;
    v_out[lane] = best_v;
    if (threadIdx.x == 0) visited_out[tile] = visited;
}

extern "C" {

// Launch on `stream` (a cudaStream_t) with n_pad / 256 > 0 blocks; tmax
// may be NULL (every lane unbounded).  Returns cudaGetLastError() as int.
int cluster_trace_launch(const float* o, const float* d, const float* tmax,
                         int n_pad, int n_valid,
                         const float* bounds, int n_clusters, const int* order,
                         int order_per_tile, const float* tri, int origin_mt,
                         float* t_out, int* prim_out, float* u_out, float* v_out,
                         int* visited_out, void* stream) {
    cluster_trace_kernel<<<n_pad / TILE, TILE, 0, (cudaStream_t)stream>>>(
        o, d, tmax, n_pad, n_valid, bounds, n_clusters, order, order_per_tile, tri,
        origin_mt, t_out, prim_out, u_out, v_out, visited_out);
    return (int)cudaGetLastError();
}

const char* cluster_trace_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
