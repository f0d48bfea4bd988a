// Dense closest-hit sweep for Hopper (sm_90a), with a group cull.
//
// Replaces ti_raytrace_tpu/ops/dense_trace.py::_sweep, the JAX package's
// dense tracer (not a Pallas kernel: a `lax.fori_loop` over 128-prim
// blocks that XLA compiles into one loop).  Its plain PyTorch twin is
// ti_raytrace_tpu_torch/ops/dense_trace.py::_sweep, which the kernel
// equals bit for bit.  What `_sweep` computes, for each lane and prim:
//   * a triangle gets two-sided Moller-Trumbore's t (`_triangle_t_uv`);
//   * a sphere gets the nearest root of the quadratic where the ray's
//     squared distance to the centre is below rad^2 (`_block_t_uv`);
//   * any other prim (a laser or quad shape) gets INF;
//   * then t > 0 ? t : INF, never NaN, and the lane's answer is the
//     lexicographic minimum of (t, prim) over the prims with t < INF, or
//     (INF, -1) if there is none (its first minimum within a block and
//     strict `<` across blocks make the lowest prim index win a tie).
// The kernel visits the prims in another order (below), so it keeps the
// same minimum with the update `t < best_t || (t == best_t && id <
// best_id)`, which reaches it in any order: t is never NaN, and a row
// with t == INF never replaces (INF, -1) since no id is below -1.
//
// What bounds it on an H100: the issue rate.  A (lane, triangle) test is
// some 60 FP32 instructions; under -fmad=false none fuses, so each is one
// of the 128 instructions an SM issues per clock.  Brute force pays that
// for every pair; the cull below pays it only for groups of 32 rows that
// some lane of a warp can hit, plus a slab test per (lane, group).  Each
// part is a device function of its own (make_lane, slab_rejects,
// guard_threshold, grazes, test_row), so tools/sass.py can count its
// instructions in the SASS for the bound of the work done
// (tools/dense_sweep.py::work_counts).
//
// Design: one thread per lane, THREADS lanes per block.  The table
// (ops/dense_trace.py::dense_groups, built once per scene) holds the
// triangles in the morton order of their centroids, cut into groups of
// GROUP rows with one padded box per group, then a tail of sphere rows.
// The block stages STAGE groups (TILE_ROWS rows and their boxes) through
// shared memory; every thread of a warp reads the same row (a broadcast).
// For each group every lane runs a slab test of its ray against the box
// and the warp votes (`__any_sync`): if some lane passes, the warp tests
// the group's rows exactly as `_sweep` does.  If none does, the warp runs
// the grazing guard (below) and votes again; if no lane is at risk, the
// warp skips the group.  The guard first votes on a lane whose threshold
// alone puts it at risk on the group's thinnest row (|d . m| <= |d| |m|),
// and then tests the group without the guard's loop over the rows: rays
// from far away against sliver triangles, where the loop would only say
// the same.  The sphere tail is tested by every warp, unculled.  Nothing
// is allocated and nothing is written but the outputs (and, if asked,
// five counts per warp added into `counts`).
//
// Numerics: compiled with -fmad=false and IEEE division and square root,
// every expression of a row test in the plain version's operation order
// (sums left to right, sign(0) = 0, the reciprocal of adet, then t * inv),
// so the results equal the plain version's bit for bit.  A NaN t (0 x INF
// in a degenerate test) fails `t > 0` and becomes INF, as there.  The
// clamps are written as `x < lo ? lo : x`: like torch.clamp they keep a
// NaN, where fmaxf would replace it.
//
// Why the cull is exact.  Let eps = 2^-24 and g5 = 5 eps / (1 - 5 eps).
// A row test computes, from float inputs o, d, v0, e1, e2 and T = fl(o -
// v0) (take T as exact: o' = v0 + T differs from o by at most eps |T|),
// the triple products D = e1.(d x e2), U = T.(d x e2), V = d.(T x e1) and
// TT = e2.(T x e1), each a cross product then a dot without fused
// multiply-adds, so each is off its exact value by at most
// sqrt(3) g5 times the product of its three operands' norms (NOISE in
// dense_trace.py).  Exactly, D T - U e1 - V e2 + TT d = 0.  With the
// computed values the residual W obeys |W| <= 4 sqrt(3) g5 |T||d||e1||e2|.
// Dividing by adet = |D| and multiplying by s = sign(D) (computed values):
//     o' + (tt / adet) d - R = s W / adet,
// R = v0 + (u e1 + v e2) / adet.  If the test accepts (u >= 0, v >= 0,
// fl(u + v) <= adet), R lies in the triangle but for 2 eps of its edges,
// and the hit point o + t d with the computed t = fl(tt * fl(1 / adet))
// lies within
//     eta = 4 sqrt(3) g5 |T||d||e1||e2| / adet + 3.001 eps |T| + 4.01 eps |e|
// of the triangle (t rounds twice; |e| the longest edge).  The first term
// is where grazing rays go wrong.  With m = (e1 x e2) / (|e1||e2|) (stored
// in the row), |D| = |d . m||e1||e2| up to its own error, so
//     adet >= |e1||e2| (|d . m| - sqrt(3) g5 |d|).
// The guard: a lane is at risk on a row if
//     |d . m| < |d| (k0 + k1 |o - c|_1),
//     k0 = sqrt(3) g5 (1 + 8 r / pad) + 5 eps,   k1 = 8 sqrt(3) g5 / pad,
// c the group's centre, r the largest distance from c to a vertex (so
// |T| <= |o - c|_1 + r), pad the box's padding; both constants are raised
// by 1% and rounded up, which covers the rounding of the guard's own
// float arithmetic, and the 5 eps covers the computed dot's error and m's
// rounding.  A lane not at risk on any row of the group has, for every
// row, |d . m| - sqrt(3) g5 |d| >= 8 sqrt(3) g5 |d| |T| / pad, so the
// first term of eta is at most pad / 2, and |T| <= pad / (69 eps), which
// makes the other terms below 0.05 pad (pad >= extent / 16 >= |e| / 28).
// So every hit that row can report lies on its ray at t > 0 within 0.55
// pad of the unpadded box, inside the padded box with a margin of 0.45
// pad.
// The slab test then passes: with ix = fl(1 / d) each slab distance
// fl(fl(lo - o) * ix) is its exact value times (1 + theta), |theta| <=
// g3; a lane fails only if tfar < 0 or tnear > tfar * SLAB_SLACK, and
// the exact interval [tnear, tfar] of the padded box contains the hit's
// t > 0, so the computed tnear is below (1 + g3) / (1 - g3) times the
// computed tfar > 0: below SLAB_SLACK = 1 + 2^-20 times it.  A component
// d = 0 gives ix = +-inf; the exact origin coordinate then lies strictly
// inside the slab (the margin), so no 0 x inf arises on such a ray.  Any
// NaN in the slab all the same (an origin on a slab plane, an infinite
// input) propagates through min_nan / max_nan and fails both rejecting
// comparisons: a NaN passes.  So a warp skips a group only if no lane of
// it can get a hit from any of its rows.
//   The ray lying in a triangle's plane to within rounding (D, U, V and
// TT all rounding noise, `_sweep`'s answer noise, possibly anywhere along
// the ray) is the case the guard exists for: |d . m| is then at noise
// level, below k0 |d|, and the lane tests the group whatever its box
// says.  Degenerate triangles (m = 0) put every lane at risk: their group
// is always tested.
//   Assumptions: the inputs are finite; no product in a row test or the
// slab underflows to a subnormal other than harmlessly (a subnormal
// result's absolute error is below 2^-149, negligible against adet >
// 1e-12 and the margin, for |d| below 2^60 pad); the table is
// dense_groups' (boxes rounded outward to float32 from float64 corners,
// whose own rounding is far below the margin).  An overflow makes no hit:
// an infinite or NaN u or v fails `ok`, an infinite or NaN t never
// updates.
//
// Layout (f32, row-major):
//   o, d    (3, n) planar ray origins / directions
//   boxes   (n_groups, 16): 0:3 lo, 3:6 hi (padded), 6:9 c, 9 k0, 10 k1,
//           11 the group's real rows (<= GROUP), 12 the least |m| of them
//   rows    (GROUP * n_groups + n_tail, 16), dense_table's format with
//           the prim id in column 14: 0:3 v0, 3:6 e1, 6:9 e2, 9 kind
//           (KIND_*), 10:13 m (a triangle) or the centre (a sphere), 13
//           radius, 14 id (-1 on padding); 16-byte aligned
//   outputs t (n) f32, prim (n) int32 (-1 = miss); counts (5) int32 or
//           null: (warp, group) pairs tested, pairs whose box no lane of
//           the warp reached (the guard ran), pairs whose guard ran its
//           loop over the rows, and the rows of the tested pairs and of
//           the looped ones (a group's real rows), added per warp

#include <cuda_runtime.h>

#define THREADS 256
#define GROUP 32          // rows per group: one warp's width
#define STAGE 4           // groups staged per pass
#define TILE_ROWS (GROUP * STAGE)  // 128 rows: 8 KB of shared memory
#define ROW_F4 4          // float4s per table row (and per box)
#define KIND_TRI 1.0f
#define KIND_SPHERE 2.0f
#define INF_T 1.0e6f
#define SLAB_SLACK (1.0f + 0x1p-20f)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float sign_of(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// min and max that return NaN if either operand is NaN
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a > b || a != a) ? a : b;
}

struct Lane {
    float ox, oy, oz, dx, dy, dz;
    float a4, a2;    // the sphere test's 4 |d|^2 and 2 clamp(|d|^2, min=1e-12)
    float dn;        // |d|, for the guard
    float ix, iy, iz;  // 1 / d, for the slab test
};

// A lane's ray and what it computes once from it.
__device__ __forceinline__ Lane make_lane(float ox, float oy, float oz, float dx, float dy,
                                          float dz) {
    Lane L;
    L.ox = ox; L.oy = oy; L.oz = oz;
    L.dx = dx; L.dy = dy; L.dz = dz;
    const float a = (dx * dx + dy * dy) + dz * dz;
    L.a4 = 4.0f * a;
    L.a2 = 2.0f * (a < 1e-12f ? 1e-12f : a);
    L.dn = sqrtf(a);
    L.ix = 1.0f / dx;
    L.iy = 1.0f / dy;
    L.iz = 1.0f / dz;
    return L;
}

// The slab test of the lane's ray against a group's padded box (b0, b1):
// true if the ray cannot reach it.  A NaN anywhere fails both
// comparisons, so it passes.
__device__ __forceinline__ bool slab_rejects(const float4& b0, const float4& b1, const Lane& L) {
    const float t1x = (b0.x - L.ox) * L.ix, t2x = (b0.w - L.ox) * L.ix;
    const float t1y = (b0.y - L.oy) * L.iy, t2y = (b1.x - L.oy) * L.iy;
    const float t1z = (b0.z - L.oz) * L.iz, t2z = (b1.y - L.oz) * L.iz;
    const float tnear = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                                min_nan(t1z, t2z));
    const float tfar = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                               max_nan(t1z, t2z));
    return tfar < 0.0f || tnear > tfar * SLAB_SLACK;
}

// The grazing guard's threshold of the lane for a group (b1, b2):
// |d| (k0 + k1 |o - c|_1).
__device__ __forceinline__ float guard_threshold(const float4& b1, const float4& b2,
                                                 const Lane& L) {
    return L.dn * (b2.y + b2.z * ((fabsf(L.ox - b1.z) + fabsf(L.oy - b1.w)) +
                                  fabsf(L.oz - b2.x)));
}

// Whether the lane is at risk of a rounding-noise hit on a row: |d . m| < thr.
__device__ __forceinline__ bool grazes(const float4* row, const Lane& L, float thr) {
    const float4 m0 = row[2], m1 = row[3];
    return fabsf((L.dx * m0.z + L.dy * m0.w) + L.dz * m1.x) < thr;
}

// One row against the lane, as `_sweep` computes it, then the update.
__device__ __forceinline__ void test_row(const float4* row, const Lane& L, float& best_t,
                                         int& best_prim) {
    const float4 r0 = row[0], r1 = row[1], r2 = row[2], r3 = row[3];
    const float kind = r2.y;
    const float ox = L.ox, oy = L.oy, oz = L.oz, dx = L.dx, dy = L.dy, dz = L.dz;
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
        float discr = b * b - L.a4 * cc;
        discr = discr < 0.0f ? 0.0f : discr;
        const float t_sph = (-b - sqrtf(discr)) / L.a2;
        if (disc2 < rad * rad) t = t_sph;
    }
    t = t > 0.0f ? t : INF_T;
    const int id = (int)r3.z;
    if (t < best_t || (t == best_t && id < best_prim)) {
        best_t = t;
        best_prim = id;
    }
}

__global__ void __launch_bounds__(THREADS)
dense_sweep_kernel(const float* __restrict__ o, const float* __restrict__ d, int n,
                   const float4* __restrict__ boxes, int n_groups,
                   const float4* __restrict__ rows, int n_tail, float* __restrict__ t_out,
                   int* __restrict__ prim_out, int* __restrict__ counts) {
    __shared__ float4 srows[TILE_ROWS * ROW_F4];
    __shared__ float4 sboxes[STAGE * ROW_F4];
    const int lane = blockIdx.x * THREADS + threadIdx.x;
    const bool live = lane < n;
    const size_t N = (size_t)n;
    // dead lanes of the last block sweep a zero ray (det = 0 and a = 0:
    // every test misses), take no part in the votes and write nothing
    const Lane L = make_lane(live ? o[lane] : 0.0f, live ? o[N + lane] : 0.0f,
                             live ? o[2 * N + lane] : 0.0f, live ? d[lane] : 0.0f,
                             live ? d[N + lane] : 0.0f, live ? d[2 * N + lane] : 0.0f);

    float best_t = INF_T;
    int best_prim = -1;
    int tested = 0, guarded = 0, looped = 0, tested_rows = 0, looped_rows = 0;
    for (int g0 = 0; g0 < n_groups; g0 += STAGE) {
        const int ng = min(STAGE, n_groups - g0);
        __syncthreads();  // the previous stage is read by every thread
        for (int i = threadIdx.x; i < ng * GROUP * ROW_F4; i += THREADS) {
            srows[i] = rows[(size_t)g0 * GROUP * ROW_F4 + i];
        }
        if (threadIdx.x < ng * ROW_F4) sboxes[threadIdx.x] = boxes[g0 * ROW_F4 + threadIdx.x];
        __syncthreads();
        for (int g = 0; g < ng; ++g) {
            const float4 b0 = sboxes[g * ROW_F4], b1 = sboxes[g * ROW_F4 + 1],
                         b2 = sboxes[g * ROW_F4 + 2], b3 = sboxes[g * ROW_F4 + 3];
            const int n_rows = (int)b2.w;
            const float4* grow = srows + g * GROUP * ROW_F4;
            bool run = __any_sync(FULL_MASK, live && !slab_rejects(b0, b1, L));
            if (!run) {  // the grazing guard
                ++guarded;
                const float thr = guard_threshold(b1, b2, L);
                run = __any_sync(FULL_MASK, live && thr > L.dn * b3.x);
                if (!run) {
                    ++looped;
                    looped_rows += n_rows;
                    bool graze = false;
                    for (int r = 0; r < n_rows; ++r) graze |= grazes(grow + r * ROW_F4, L, thr);
                    run = __any_sync(FULL_MASK, live && graze);
                }
            }
            if (run) {
                ++tested;
                tested_rows += n_rows;
#pragma unroll 2
                for (int r = 0; r < n_rows; ++r) {
                    test_row(grow + r * ROW_F4, L, best_t, best_prim);
                }
            }
        }
    }
    const float4* tail = rows + (size_t)n_groups * GROUP * ROW_F4;
    for (int p0 = 0; p0 < n_tail; p0 += TILE_ROWS) {
        const int n_rows = min(TILE_ROWS, n_tail - p0);
        __syncthreads();
        for (int i = threadIdx.x; i < n_rows * ROW_F4; i += THREADS) {
            srows[i] = tail[(size_t)p0 * ROW_F4 + i];
        }
        __syncthreads();
        for (int r = 0; r < n_rows; ++r) test_row(srows + r * ROW_F4, L, best_t, best_prim);
    }
    if (live) {
        t_out[lane] = best_t;
        prim_out[lane] = best_prim;
    }
    if (counts != nullptr && (threadIdx.x & 31) == 0) {
        atomicAdd(counts, tested);
        atomicAdd(counts + 1, guarded);
        atomicAdd(counts + 2, looped);
        atomicAdd(counts + 3, tested_rows);
        atomicAdd(counts + 4, looped_rows);
    }
}

extern "C" {

// Launch on `stream` (a cudaStream_t) for n > 0 lanes.  counts may be
// null.  Returns cudaGetLastError() as int.
int dense_sweep_launch(const float* o, const float* d, int n, const float* boxes, int n_groups,
                       const float* rows, int n_tail, float* t_out, int* prim_out, int* counts,
                       void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    dense_sweep_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        o, d, n, reinterpret_cast<const float4*>(boxes), n_groups,
        reinterpret_cast<const float4*>(rows), n_tail, t_out, prim_out, counts);
    return (int)cudaGetLastError();
}

const char* dense_sweep_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
