// Cluster-stream closest-hit traversal for Hopper (sm_90a).
//
// Replaces ti_raytrace_tpu/ops/cluster_trace.py::_kernel, the JAX
// package's Pallas TPU kernel: for each ray, the closest hit among
// clusters of 128 triangles visited in a front-to-back order.
//
// What bounds it on an H100: the operations of the narrow phase (~60
// FP32 operations per generic Moller-Trumbore test, 128 tests per
// candidate (ray, cluster) pair) and of the broad phase (one slab test
// per lane and super box, and 32 cluster-box tests for each super box the
// lane enters: tools/kernel_wavefronts.py::bound); the bytes (rays, hit
// records, the ~5.5 MB triangle table of the 100k scene) take
// microseconds.  What held
// the first design far from that bound was latency: a serial walk of every
// sweep position with dependent L2 loads and a block barrier each, one
// thread testing 128 triangles for its ray alone, and a copy of each
// visited cluster that nothing overlapped.  The design, per block (one
// tile of TILE rays, NT = 256 or 512 threads):
//   * broad phase from shared memory, in chunks of CHUNK sweep positions:
//     the chunk's order entries, cluster boxes and supercluster boxes are
//     staged with cp.async, double-buffered, so chunk c + 1 loads while
//     chunk c is swept; each warp slab-tests its 32 rays against the
//     chunk's boxes and ORs its ballots into the chunk mask of clusters
//     that some ray may need, and the block walks only the mask's set bits;
//   * supercluster skip: the positions 32s .. 32s+31 of an order hold the
//     32 clusters of one supercluster (ops/cluster_trace.py::_expand_supers),
//     so a warp none of whose rays enters the supercluster's box before its
//     best hit skips those 32 slab tests.  This is exact.  A super box
//     contains its clusters' boxes (min over their mins, max over their
//     maxes), and every step of the slab test is monotonic in the box planes
//     under round-to-nearest: b - o is nondecreasing in b, times a fixed
//     inverse direction it is monotonic, and min/max keep order.  So a ray
//     that enters a cluster's box at tn, leaving at tf, enters the super box
//     at tn' <= tn and leaves at tf' >= tf; the super's validity is the max
//     of its clusters'.  A cluster that is a candidate at visit time
//     (tn < best_t there <= best_t at the chunk's start) thus has a super
//     that the test below passes;
//   * exact candidacy at visit time: at each set bit the tile's rays are
//     slab-tested against the current best hit, as in the plain version;
//     the chunk mask (made from the best hits at the chunk's start) is only
//     a superset.  The candidates are packed into a dense list in shared
//     memory (ballots and one shared-memory atomic per warp);
//   * narrow phase spread over the candidates: one warp per candidate
//     (ray, cluster) pair, 4 of the 128 triangle slots per lane, the
//     lane results reduced by (t, slot) with two warp reductions, so a
//     tile with one candidate costs one warp four tests, not one thread
//     128.  The next set bit's triangle rows are prefetched with cp.async
//     into a second buffer while the current cluster is tested; a prefetch
//     that turns out pruned is dropped.
// The wrapper's tile count picks the threads per tile (threads_per_tile):
// small wavefronts take more warps per tile to fill the SMs.
//
// Numerics: compiled with -fmad=false, and every formula keeps the
// reference's operation order, so results equal the plain PyTorch version
// (ops/cluster_trace.py::cluster_trace_plain) bit for bit.  Ties keep the
// reference's rule: strict `<` updates across clusters, so the winner is
// the first cluster in order with the minimal t, then the lowest triangle
// slot (a cluster's minimum t and its lowest slot, as the plain version's
// amin + first-argmin).  `visited` keeps its meaning: the clusters at whose
// visit some ray of the tile was a candidate.
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
//   supers      (8, C / 32): the same rows for each run of 32 clusters
//               (ops/cluster_trace.py::super_table)
//   order       (1, C) shared or (n_tiles, C) per-tile int32 sweep order,
//               whole superclusters: positions 32s .. 32s+31 hold the
//               clusters of one supercluster
//   tri         (12, C * 128), one of two forms:
//               generic   [v0 | e1 | e2 | pid]          (rows 0..9)
//               origin_mt [n | s | q | pid | tconst]    (rows 0..10),
//               the shared-origin table of _origin_mt_table
//   outputs     t, prim (int32, -1 = miss), u, v (n_pad); visited
//               (n_tiles) = clusters whose triangles the block tested.

#include <cuda_runtime.h>

#define TILE 256
#define CLUSTER_B 128
#define GROUP 32
#define CHUNK 128
#define SUPERS_PER_CHUNK (CHUNK / GROUP)
#define BOUND_ROWS 7
#define MAX_ROWS 11
#define INF_T 1.0e6f
#define FULL_MASK 0xffffffffu
// Wavefronts of fewer tiles than this get 512 threads per tile, wider
// ones 256.  Measured on an H100 under the 64-register cap below (PERF.md):
// 512 threads are 12% faster on the bench's 128-tile deep wavefront and
// 10% on its 1,024-tile camera wavefront, tie at 683 tiles and on
// veach_bdpt's walks, and take 11% less kernel time per veach_pt frame;
// 256 are 6% faster at 3,277 tiles and 7% at 10,240.
#define SMALL_TILES 2048

struct __align__(16) Shared {
    float tri[2][MAX_ROWS][CLUSTER_B];  // triangle rows, double-buffered
    float bnd[2][BOUND_ROWS][CHUNK];    // the chunk's cluster boxes
    float sup[2][BOUND_ROWS][SUPERS_PER_CHUNK];
    int ord[2][CHUNK];                  // the chunk's order entries
    float o[3][TILE], d[3][TILE];       // the tile's rays
    float best_t[TILE], best_u[TILE], best_v[TILE];
    int best_p[TILE];
    int cand[TILE];                     // candidate lanes of one visit
    int n_cand[2];
    unsigned mask[2][SUPERS_PER_CHUNK]; // chunk masks, one word per super
};

__device__ __forceinline__ float safe_inv(float v) {
    return 1.0f / (fabsf(v) < 1e-12f ? (v >= 0.0f ? 1e-12f : -1e-12f) : v);
}

__device__ __forceinline__ float sign_of(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Ray {
    float ox, oy, oz, ix, iy, iz;
    bool live;
};

// Slab test (reference _kernel.slab) of ray r against box p of rows b
// (row stride `stride`), candidate if it enters before `best`; row 6 is
// the validity flag.
__device__ __forceinline__ bool enters(const Ray& r, const float* b, int stride, int p,
                                       float best) {
    const float t1x = (b[0 * stride + p] - r.ox) * r.ix;
    const float t2x = (b[3 * stride + p] - r.ox) * r.ix;
    float tn = fminf(t1x, t2x), tf = fmaxf(t1x, t2x);
    const float t1y = (b[1 * stride + p] - r.oy) * r.iy;
    const float t2y = (b[4 * stride + p] - r.oy) * r.iy;
    tn = fmaxf(tn, fminf(t1y, t2y));
    tf = fminf(tf, fmaxf(t1y, t2y));
    const float t1z = (b[2 * stride + p] - r.oz) * r.iz;
    const float t2z = (b[5 * stride + p] - r.oz) * r.iz;
    tn = fmaxf(tn, fminf(t1z, t2z));
    tf = fminf(tf, fmaxf(t1z, t2z));
    return r.live && fmaxf(tn, 0.0f) <= tf && b[6 * stride + p] > 0.0f && tn < best;
}

// One two-sided Moller-Trumbore test of slot j of a staged cluster:
// t (INF_T on a miss), and u, v before the 1/|det| scale in `inv`.
template <bool ORIGIN_MT>
__device__ __forceinline__ float mt_test(const float (*s)[CLUSTER_B], int j, float ox,
                                         float oy, float oz, float dx, float dy, float dz,
                                         float& u, float& v, float& inv) {
    float det, t;
    if (ORIGIN_MT) {
        // det = d.n, u = d.s, v = d.q, t = tconst (_origin_mt_table)
        det = dx * s[0][j] + dy * s[1][j] + dz * s[2][j];
        const float sg = sign_of(det);
        u = (dx * s[3][j] + dy * s[4][j] + dz * s[5][j]) * sg;
        v = (dx * s[6][j] + dy * s[7][j] + dz * s[8][j]) * sg;
        t = s[10][j] * sg;
    } else {
        const float v0x = s[0][j], v0y = s[1][j], v0z = s[2][j];
        const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
        const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
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
    const bool ok = adet > 1e-12f && u >= 0.0f && u <= adet && v >= 0.0f && u + v <= adet;
    inv = 1.0f / (adet > 1e-12f ? adet : 1.0f);
    t = ok ? t * inv : INF_T;
    return t > 0.0f ? t : INF_T;
}

// The narrow phase of one visit: warp w takes candidates w, w + NW, ...;
// lane l tests slots l, l + 32, l + 64, l + 96 of the staged cluster.
template <int NT, bool ORIGIN_MT>
__device__ __forceinline__ void narrow(Shared& s, int tb, int n) {
    const int lane = threadIdx.x & 31;
    const float (*tri)[CLUSTER_B] = s.tri[tb];
    for (int i = threadIdx.x >> 5; i < n; i += NT / 32) {
        const int r = s.cand[i];
        const float ox = s.o[0][r], oy = s.o[1][r], oz = s.o[2][r];
        const float dx = s.d[0][r], dy = s.d[1][r], dz = s.d[2][r];
        float tmin = 0.0f, wu = 0.0f, wv = 0.0f;
        int slot = lane;
#pragma unroll
        for (int m = 0; m < CLUSTER_B / 32; ++m) {
            const int j = lane + 32 * m;
            float u, v, inv;
            const float t = mt_test<ORIGIN_MT>(tri, j, ox, oy, oz, dx, dy, dz, u, v, inv);
            if (m == 0 || t < tmin) {  // strict: the lane's lowest slot of its minimum
                tmin = t;
                wu = u * inv;
                wv = v * inv;
                slot = j;
            }
        }
        // t > 0 always, so its bits order as unsigned integers: the least t,
        // then the lowest slot holding it
        const unsigned tbits = __reduce_min_sync(FULL_MASK, __float_as_uint(tmin));
        const unsigned win = __reduce_min_sync(
            FULL_MASK, __float_as_uint(tmin) == tbits ? (unsigned)slot : 0xffffffffu);
        const float bu = __shfl_sync(FULL_MASK, wu, win & 31);
        const float bv = __shfl_sync(FULL_MASK, wv, win & 31);
        const float tw = __uint_as_float(tbits);
        if (lane == 0 && tw < s.best_t[r]) {
            s.best_t[r] = tw;
            s.best_u[r] = bu;
            s.best_v[r] = bv;
            s.best_p[r] = (int)tri[9][win];
        }
    }
}

// Stage chunk c's order entries, cluster boxes and super boxes into
// buffer `buf` with cp.async (the caller commits the group).
__device__ __forceinline__ void stage_chunk(Shared& s, int buf, const int* ord, int c,
                                            int n_clusters, const float* bounds,
                                            const float* supers) {
    const int base = c * CHUNK;
    const int npos = min(CHUNK, n_clusters - base);
    const int q = threadIdx.x;
    if (q < npos) {
        const int cid = ord[base + q];
        s.ord[buf][q] = cid;  // a plain store: visible after the next barrier
#pragma unroll
        for (int row = 0; row < BOUND_ROWS; ++row) {
            cp_async4(&s.bnd[buf][row][q], bounds + (size_t)row * n_clusters + cid);
        }
    } else if (q >= CHUNK && q < CHUNK + SUPERS_PER_CHUNK * BOUND_ROWS) {
        const int j = (q - CHUNK) / BOUND_ROWS, row = (q - CHUNK) % BOUND_ROWS;
        if (j * GROUP < npos) {
            const int sid = ord[base + j * GROUP] / GROUP;
            cp_async4(&s.sup[buf][row][j], supers + (size_t)row * (n_clusters / GROUP) + sid);
        }
    }
}

// Stage the triangle rows of cluster cid into triangle buffer tb.
__device__ __forceinline__ void stage_tri(Shared& s, int tb, const float* tri, int cid,
                                          int rows, size_t stride, int nt) {
    for (int q = threadIdx.x; q < rows * (CLUSTER_B / 4); q += nt) {
        const int row = q / (CLUSTER_B / 4), col = (q % (CLUSTER_B / 4)) * 4;
        cp_async16(&s.tri[tb][row][col], tri + row * stride + (size_t)cid * CLUSTER_B + col);
    }
}

// The next set bit of the 128-bit chunk mask after position `after`
// (-1: from the start), or -1.
__device__ __forceinline__ int next_bit(unsigned long long lo, unsigned long long hi,
                                        int after) {
    const int from = after + 1;
    if (from < 64) {
        const unsigned long long m = from == 0 ? lo : lo & (~0ull << from);
        if (m) return __ffsll((long long)m) - 1;
        return hi ? 63 + __ffsll((long long)hi) : -1;
    }
    if (from >= 128) return -1;
    const unsigned long long m = hi & (~0ull << (from - 64));
    return m ? 63 + __ffsll((long long)m) : -1;
}

// At most 64 registers a thread (four 256-thread or two 512-thread tiles
// per SM): measured on an H100, 3-8% faster than the uncapped 77 and 96
// registers on the wide wavefronts, equal on the others; a cap of 48
// spills and is slower on the camera wavefront.
template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT)
cluster_trace_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmax, int n_pad, int n_valid,
                     const float* __restrict__ bounds, const float* __restrict__ supers,
                     int n_clusters, const int* __restrict__ order, int order_per_tile,
                     const float* __restrict__ tri, int origin_mt,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     int* __restrict__ visited_out) {
    constexpr int RPT = NT / TILE;  // threads per ray in the broad phase
    __shared__ Shared s;

    const int tid = threadIdx.x;
    const int r = tid % TILE;     // this thread's ray in the broad phase
    const int part = tid / TILE;  // ... and its share of each super's positions
    const int lane_id = tid & 31;
    const int tile = blockIdx.x;
    const int lane = tile * TILE + r;
    const float dx = d[lane], dy = d[n_pad + lane], dz = d[2 * n_pad + lane];
    Ray ray;
    ray.ox = o[lane];
    ray.oy = o[n_pad + lane];
    ray.oz = o[2 * n_pad + lane];
    ray.ix = safe_inv(dx);
    ray.iy = safe_inv(dy);
    ray.iz = safe_inv(dz);
    ray.live = lane < n_valid;
    if (part == 0) {
        s.o[0][r] = ray.ox;
        s.o[1][r] = ray.oy;
        s.o[2][r] = ray.oz;
        s.d[0][r] = dx;
        s.d[1][r] = dy;
        s.d[2][r] = dz;
        const float bound = tmax ? tmax[lane] : 0.0f;
        s.best_t[r] = bound > 0.0f ? bound : INF_T;
        s.best_u[r] = 0.0f;
        s.best_v[r] = 0.0f;
        s.best_p[r] = -1;
    }
    if (tid < 2) s.n_cand[tid] = 0;
    if (tid < 2 * SUPERS_PER_CHUNK) s.mask[tid / SUPERS_PER_CHUNK][tid % SUPERS_PER_CHUNK] = 0;

    const size_t tri_stride = (size_t)n_clusters * CLUSTER_B;
    const int rows = origin_mt ? 11 : 10;
    const int* ord = order + (order_per_tile ? (size_t)tile * n_clusters : 0);
    const int n_chunks = (n_clusters + CHUNK - 1) / CHUNK;
    int visited = 0, q = 0, tb = 0;

    stage_chunk(s, 0, ord, 0, n_clusters, bounds, supers);
    cp_async_commit();
    for (int c = 0, buf = 0; c < n_chunks; ++c, buf ^= 1) {
        cp_async_wait<0>();
        __syncthreads();  // chunk c staged; the last chunk's walk is over
        if (c + 1 < n_chunks) stage_chunk(s, buf ^ 1, ord, c + 1, n_clusters, bounds, supers);
        cp_async_commit();
        if (tid < SUPERS_PER_CHUNK) s.mask[buf ^ 1][tid] = 0;  // for chunk c + 1

        // broad phase: each warp ORs its ballots into the chunk mask
        const int n_sup = min(CHUNK, n_clusters - c * CHUNK) / GROUP;
        const float best = s.best_t[r];
        for (int j = 0; j < n_sup; ++j) {
            if (!__any_sync(FULL_MASK, enters(ray, &s.sup[buf][0][0], SUPERS_PER_CHUNK, j, best)))
                continue;  // no ray of this warp enters the super box: skip its 32
            unsigned word = 0;
            for (int g = part; g < GROUP; g += RPT) {
                if (__any_sync(FULL_MASK, enters(ray, &s.bnd[buf][0][0], CHUNK, j * GROUP + g,
                                                 best)))
                    word |= 1u << g;
            }
            if (lane_id == 0 && word) atomicOr(&s.mask[buf][j], word);
        }
        __syncthreads();
        const unsigned long long lo =
            (unsigned long long)s.mask[buf][0] | ((unsigned long long)s.mask[buf][1] << 32);
        const unsigned long long hi =
            (unsigned long long)s.mask[buf][2] | ((unsigned long long)s.mask[buf][3] << 32);

        // walk the set bits in sweep order
        int k = next_bit(lo, hi, -1);
        if (k >= 0) stage_tri(s, tb, tri, s.ord[buf][k], rows, tri_stride, NT);
        cp_async_commit();
        while (k >= 0) {
            const int kn = next_bit(lo, hi, k);
            if (kn >= 0) stage_tri(s, tb ^ 1, tri, s.ord[buf][kn], rows, tri_stride, NT);
            cp_async_commit();
            if (part == 0) {  // exact candidacy against the current best hit
                const bool cand = enters(ray, &s.bnd[buf][0][0], CHUNK, k, s.best_t[r]);
                const unsigned bal = __ballot_sync(FULL_MASK, cand);
                if (bal) {
                    int off = 0;
                    if (lane_id == 0) off = atomicAdd(&s.n_cand[q], __popc(bal));
                    off = __shfl_sync(FULL_MASK, off, 0);
                    if (cand) s.cand[off + __popc(bal & ((1u << lane_id) - 1u))] = r;
                }
            }
            cp_async_wait<1>();  // cluster k's rows have landed
            __syncthreads();
            const int n = s.n_cand[q];
            if (tid == 0) s.n_cand[q ^ 1] = 0;
            if (n > 0) {
                ++visited;
                if (origin_mt) {
                    narrow<NT, true>(s, tb, n);
                } else {
                    narrow<NT, false>(s, tb, n);
                }
            }
            __syncthreads();  // best hits updated; the list and buffer tb are free
            q ^= 1;
            tb ^= 1;
            k = kn;
        }
    }

    __syncthreads();
    if (part == 0) {
        t_out[lane] = s.best_t[r];
        prim_out[lane] = s.best_p[r];
        u_out[lane] = s.best_u[r];
        v_out[lane] = s.best_v[r];
    }
    if (tid == 0) visited_out[tile] = visited;
}

template <int NT>
static void launch(int n_tiles, cudaStream_t stream, const float* o, const float* d,
                   const float* tmax, int n_pad, int n_valid, const float* bounds,
                   const float* supers, int n_clusters, const int* order, int order_per_tile,
                   const float* tri, int origin_mt, float* t_out, int* prim_out, float* u_out,
                   float* v_out, int* visited_out) {
    cluster_trace_kernel<NT><<<n_tiles, NT, 0, stream>>>(
        o, d, tmax, n_pad, n_valid, bounds, supers, n_clusters, order, order_per_tile, tri,
        origin_mt, t_out, prim_out, u_out, v_out, visited_out);
}

static int threads_per_tile(int n_tiles) { return n_tiles < SMALL_TILES ? 512 : 256; }

extern "C" {

// Launch on `stream` (a cudaStream_t) with n_pad / 256 > 0 blocks; tmax
// may be NULL (every lane unbounded).  Returns cudaGetLastError() as int.
int cluster_trace_launch(const float* o, const float* d, const float* tmax, int n_pad,
                         int n_valid, const float* bounds, const float* supers,
                         int n_clusters, const int* order, int order_per_tile,
                         const float* tri, int origin_mt, float* t_out, int* prim_out,
                         float* u_out, float* v_out, int* visited_out, void* stream) {
    const int n_tiles = n_pad / TILE;
    const cudaStream_t st = (cudaStream_t)stream;
    if (threads_per_tile(n_tiles) == 512) {
        launch<512>(n_tiles, st, o, d, tmax, n_pad, n_valid, bounds, supers, n_clusters, order,
                    order_per_tile, tri, origin_mt, t_out, prim_out, u_out, v_out, visited_out);
    } else {
        launch<256>(n_tiles, st, o, d, tmax, n_pad, n_valid, bounds, supers, n_clusters, order,
                    order_per_tile, tri, origin_mt, t_out, prim_out, u_out, v_out, visited_out);
    }
    return (int)cudaGetLastError();
}

const char* cluster_trace_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
