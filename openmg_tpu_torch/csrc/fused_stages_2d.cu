// Whole-visit stage fusion for constant and cornered radius-1 2D stencils.
//
// Replaces the TPU kernel openmg_tpu/ops/kernels.py::fused_stages_2d (:1134, body
// _fused2d_kernel): all S smoothing stages of one level visit of the V-cycle
// on a 2D plane in ONE launch.  A stage is a weighted-Jacobi step
// x + omega * D^-1 (b - A x) or a red/black half-sweep
// where((y + x) & 1 == colour, D^-1 (b - sum_{k != diag} a_k x_k), x).  The
// visit starts from zero (reads only b), from x, or from x + P*ec (the
// prolongation is formed on load and never stored), and may end with the
// residual b - A x or with its restriction bc = R (b - A x) (the fine
// residual is never stored).  Cornered levels are exact: a point's taps are
// one row of an at most 4-row table chosen by (y == 0, x == 0).
//
// What bounds it on an H100: bytes.  A visit does at most 2*9 flops per
// point and stage against 9 bytes a point (down-leg: b read, x and bc
// written) or 13 (up-leg: b, x and ec read, x written), far below the card's
// flop:byte ratio, so the least time is the traffic over the memory rate.
//
// What the design does about it: a warp marches down a strip of rows with
// every level of the visit held in registers, so nothing waits on a block
// barrier or on shared memory, and each value moves through device memory
// once.
//   * A warp owns a strip of W = 128 columns (4 a lane), halo included, and
//     a chunk of `rows` rows.  It walks the rows of its chunk and H rows
//     above and below it (H = S, +1 with a residual, +1 more with a
//     restriction), one row a step.  At step t it makes row t of the start
//     iterate (0, x, or x + P ec: the two coarse rows under it are
//     interpolated on the spot) and row t - L of level L for every level:
//     stage L (L = 1..S), then the residual (level S + 1).  Each level
//     keeps its three newest rows in registers, the window a radius-1
//     stencil needs, and shifts them up a row a step.
//   * x-neighbours are the lane's own columns and one column of each
//     neighbouring lane, fetched by two shuffles as a level's row is made.
//     The lanes at the strip's ends read their own values instead; the error
//     moves in by a column a level, so a strip owns W - 2 hp columns (hp: H
//     rounded up to a multiple of 4, so a lane's columns are one 16-byte
//     word) and neighbouring strips overlap by hp.  The x-halo costs 128 /
//     112 of the arithmetic at depth 6 (a tile with a halo in both axes
//     paid 1.46x); the y-halo is 2H rows a chunk, so chunks are long where
//     the plane has warps to spare and short where it has not.
//   * Every load is issued a step before its use: b's row enters at level 1
//     and moves down a level a step in registers (read once); the start
//     iterate's row and its coarse rows come in while the step before
//     computes.
//   * A red/black stage computes two of a lane's four points: the colour of
//     column x0 + j is (y + j) & 1 (x0 a multiple of 4), the same in every
//     lane, so there is no divergence; the others are copied.  A stage's
//     kind and parameter are read from the plan (the same in every lane).
//   * The offsets are compile-time for the 5-point Poisson order and the
//     9-point Galerkin order (`Order`), summed through template recursion;
//     any other order of at most 9 radius-1 taps takes a generic instance
//     that picks each neighbour by its position at run time.
//   * Cornered levels: a point computes with the interior taps in
//     registers.  The column x == 0 (a lane's first point, in one lane of
//     the first strip) has its region row in that lane's registers and a
//     select between the two updates; the row y == 0 (a branch the whole
//     warp takes) is computed again with its region rows from a 4-row table
//     in shared memory.  A branch a lane took alone, or a call, in the
//     level's code cost 30-60 % on the cornered levels even untaken.
//   * The restriction reads three residual rows of the window when the
//     newest of them is odd (2c + 1) and writes coarse row c: a lane owns
//     coarse columns x0 / 2 and x0 / 2 + 1 and reads fine columns x0 - 1 ..
//     x0 + 3.
//   * The plan (hp, columns a strip owns, rows a chunk, strips, chunks)
//     comes from the wrapper (ops/kernels.py::fused2d_plan) and is checked
//     here.
//
// The batched form (the TPU kernel under jax.vmap, whose grid gains a
// leading batch axis): `members` planes of one level stacked along a leading
// axis, one launch for all of them with one table, plan and stage list.
// The member is blockIdx.y; its warps march its plane as a launch on it
// alone would (the same plan), so each member's outputs are that launch's,
// bit for bit.
//
// Rounding: taps are summed in the order of the offsets (the diagonal
// skipped in a red/black stage); interior points multiply by the reciprocal
// of the interior diagonal, region points divide by their own diagonal, as
// fused_stages.cu does.  nvcc may contract a*b+c into a fused multiply-add,
// which the plain PyTorch version does not, so the two agree to a few ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 9;
constexpr int MAX_DEPTH = 8;            // the caller splits deeper visits
constexpr int V = 4;                    // columns a lane
constexpr int W = 32 * V;               // strip columns, halo included
constexpr int WARPS = 4;                // warps a block
constexpr unsigned FULL = 0xffffffffu;

enum Mode { MODE_JACOBI = 0, MODE_RB = 1, MODE_RESIDUAL = 2 };

// Tap positions (dy + 1) * 3 + (dx + 1) in the order of the offsets.
// ORD 1: the 5-point Poisson order (centre, -y, +y, -x, +x); ORD 2: the
// 9-point Galerkin order (centre, then the others row by row).  ORD 0 is
// any other order, read from the plan at run time.
template <int ORD> struct Order;
template <> struct Order<1> {
    static constexpr int K = 5;
    static constexpr int pos[5] = {4, 1, 7, 3, 5};
};
template <> struct Order<2> {
    static constexpr int K = 9;
    static constexpr int pos[9] = {4, 0, 1, 2, 3, 5, 6, 7, 8};
};

struct Plan {
    int K;
    int di;                 // index of the (0,0) offset
    int pos[MAXK];          // position of offset k, (dy + 1) * 3 + (dx + 1)
    int rowmap[4];          // mask (bit 0: y == 0, bit 1: x == 0) -> table row, -1 = interior
    int corner;             // some rowmap entry is a table row
    int kind[MAX_DEPTH];
    float par[MAX_DEPTH];   // omega of a Jacobi stage, colour of a red/black one
    int H;                  // rows marched above and below a chunk
    int hp;                 // halo columns a side of a strip
    int ow;                 // columns a strip owns, W - 2 hp
    int strips, rows, chunks;
    int vec;                // rows and pointers allow 16-byte accesses
    int emit;               // 1: store the residual; 2: restrict it
    float rw[3], pw[3];     // transfer weights of taps -1, 0, +1
    int members;            // planes of a batch, one a blockIdx.y (1: one plane)
};

// neighbour at position p of a 3x3 neighbourhood, p known at run time only
__device__ __forceinline__ float pick(const float (&nb)[9], int p)
{
    float v = nb[0];
#pragma unroll
    for (int q = 1; q < 9; ++q) v = p == q ? nb[q] : v;
    return v;
}

// acc += tp[k] * nb[pos k] for the offsets k >= 1 of Order<ORD>, in order
// (offset 0 is the centre in both orders)
template <int ORD, int k>
struct TapSum {
    template <typename T>
    static __device__ __forceinline__ void run(float& acc, const float (&nb)[9],
                                               const T& tp)
    {
        if constexpr (k < Order<ORD>::K) {
            constexpr int p = Order<ORD>::pos[k];
            acc += tp[k] * nb[p];
            TapSum<ORD, k + 1>::run(acc, nb, tp);
        }
    }
};

// The sum of the taps in the order of the offsets, the diagonal skipped in
// a red/black stage.  ORD 0 reads the positions from pos (K of them).
template <int ORD, typename T>
__device__ __forceinline__ float tap_sum(const float (&nb)[9], const T& tp,
                                         bool skip_diag, const int* pos, int K,
                                         int di)
{
    float acc = 0.0f;
    if constexpr (ORD == 0) {
        for (int k = 0; k < K; ++k) {
            if (skip_diag && k == di) continue;
            acc += tp[k] * pick(nb, pos[k]);
        }
    } else {
        if (!skip_diag) acc += tp[0] * nb[4];
        TapSum<ORD, 1>::run(acc, nb, tp);
    }
    return acc;
}

// New value of a point from its neighbourhood nb (nb[4] is the point):
// mode 0 Jacobi (omega), 1 red/black, 2 the residual.  Interior points
// multiply by inv_d; a region point (taps tp from the table) divides by its
// own diagonal tp[di].
template <int ORD, typename T>
__device__ __forceinline__ float point(
    const float (&nb)[9], const T& tp, const int* pos, int K, int di, int mode,
    float bv, float inv_d, bool region, float omega)
{
    const float res = bv - tap_sum<ORD>(nb, tp, mode == MODE_RB, pos, K, di);
    if (mode == MODE_RESIDUAL) return res;
    if (!region)
        return mode == MODE_JACOBI ? nb[4] + omega * (inv_d * res) : inv_d * res;
    const float dg = tp[di];
    return mode == MODE_JACOBI ? nb[4] + (omega * res) / dg : res / dg;
}

struct Hood {
    float v[9];
};

// A level row: the lane's V values at [1..V], the left and right
// neighbours' at [0] and [V + 1].
struct Row {
    float v[V + 2];
};

__device__ __forceinline__ void zero_row(Row& r)
{
#pragma unroll
    for (int e = 0; e < V + 2; ++e) r.v[e] = 0.0f;
}

// fill the halo of a row from the neighbouring lanes (every lane calls it);
// lanes 0 and 31 get their own values, wrong, but inside the strip's halo
__device__ __forceinline__ void halo(Row& r)
{
    r.v[0] = __shfl_up_sync(FULL, r.v[V], 1);
    r.v[V + 1] = __shfl_down_sync(FULL, r.v[1], 1);
}

// What a warp needs of the grid: the lane's columns and the plan.
struct Ctx {
    int x0;                 // the lane's first column, a multiple of 4
    int lane, ny, nx;
    bool colin[V];          // column x0 + j lies in the grid
    bool vec;
};

// the lane's V values of row y of a (ny, nx) grid; zero outside the grid
__device__ __forceinline__ void load_row(float (&out)[V], const float* g,
                                         int y, const Ctx& c)
{
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = 0.0f;
    if (g == nullptr || y < 0 || y >= c.ny) return;
    const float* p = g + (size_t)y * c.nx + c.x0;
    if (c.vec) {
        if (c.colin[0]) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(p));
            out[0] = t.x;
            out[1] = t.y;
            out[2] = t.z;
            out[3] = t.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
            if (c.colin[j]) out[j] = __ldg(p + j);
    }
}

// What a lane reads for row t of the start iterate: x at its columns and
// ec at coarse columns x0 / 2 and x0 / 2 + 1 of the coarse rows under row t:
// ea of row (t + 1) / 2, eb of row (t - 1) / 2 for an odd t; ea of row t / 2
// for an even one.  Zero outside.
struct Start {
    float x[V];
    float ea[2], eb[2];
};

__device__ __forceinline__ void load_start(Start& s, const float* xin,
                                           const float* ec, int t, const Ctx& c)
{
    load_row(s.x, xin, t, c);
    s.ea[0] = s.ea[1] = s.eb[0] = s.eb[1] = 0.0f;
    const int ncy = c.ny >> 1, ncx = c.nx >> 1, c0 = c.x0 >> 1;
    if (ec != nullptr && t >= 0 && t < c.ny && c0 >= 0 && c0 < ncx) {
        const int ca = (t + 1) >> 1, cb = t >> 1;   // equal for an even t
        const bool two = c0 + 1 < ncx;
        if (ca < ncy) {
            const float* p = ec + (size_t)ca * ncx + c0;
            s.ea[0] = __ldg(p);
            if (two) s.ea[1] = __ldg(p + 1);
        }
        if (t & 1) {
            const float* p = ec + (size_t)cb * ncx + c0;
            s.eb[0] = __ldg(p);
            if (two) s.eb[1] = __ldg(p + 1);
        }
    }
}

// Row t of the start iterate: x (or 0) + (P ec), zero outside the grid,
// halo included.  (P ec)(f) for separable radius-1 taps: weight w[t + 1]
// couples fine index f = 2c + t with coarse index c; for each fine column
// the y sum inside the x sum, in the order of fused_stages.cu (for an odd
// index, coarse (f + 1) / 2 with w[0] first, then (f - 1) / 2 with w[2]).
__device__ __forceinline__ void start_row(Row& r, const float* w, const Start& s,
                                          bool prolong, int t, const Ctx& c)
{
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = s.x[j];
    if (prolong) {
        // y sums at coarse columns c0, c0 + 1, and c0 + 2 from the next lane;
        // every lane takes part in the shuffle, rows outside included
        float sy[3];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            float a = 0.0f;
            if ((t & 1) == 0) {
                a += w[1] * s.ea[q];
            } else {
                a += w[0] * s.ea[q];
                a += w[2] * s.eb[q];
            }
            sy[q] = a;
        }
        sy[2] = __shfl_down_sync(FULL, sy[0], 1);
        if (c.lane == 31) sy[2] = 0.0f;
        // fine x0 + 2q (even): c0 + q with w[1]; x0 + 2q + 1 (odd): c0 + q + 1
        // with w[0], then c0 + q with w[2]
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            float e = 0.0f, o = 0.0f;
            e += w[1] * sy[q];
            o += w[0] * sy[q + 1];
            o += w[2] * sy[q];
            v[2 * q] += e;
            v[2 * q + 1] += o;
        }
    }
    const bool rin = t >= 0 && t < c.ny;
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[1 + j] = rin && c.colin[j] ? v[j] : 0.0f;
    halo(r);
}

// What a level row needs besides its inputs.
struct Taps {
    float treg[MAXK];                 // interior taps
    float tcol[MAXK];                 // taps of the lane's first point: column 0's
                                      // region row in the lane that holds x = 0
    bool col0;                        // the lane's first point is a region point
    bool colwarp;                     // ... in some lane of the warp
    const float (*table)[MAXK];       // taps by zero-coordinate mask (shared)
    const int* rowmap;                // mask -> table row, -1 = interior (shared)
    const int* pos;                   // offset positions (shared)
    int K, di, corner;
    float inv_d;
};

// The 3x3 neighbourhood of point j of a level row from the previous
// level's rows a, m, c (y - 1, y, y + 1).
__device__ __forceinline__ void hood(Hood& h, const Row& a, const Row& m,
                                     const Row& c, int j)
{
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
        h.v[dx] = a.v[j + dx];
        h.v[3 + dx] = m.v[j + dx];
        h.v[6 + dx] = c.v[j + dx];
    }
}

// Point j of a level row with the interior taps; the lane's first point
// with its own taps (column 0's region row in one lane of the first strip:
// a select, not a branch, so the warp never diverges on it).
template <int ORD>
__device__ __forceinline__ float row_point(
    const Row& a, const Row& m, const Row& c, int j, const Taps& tp, int mode,
    float bv, float par)
{
    Hood h;
    hood(h, a, m, c, j);
    if (j != 0)
        return point<ORD>(h.v, tp.treg, tp.pos, tp.K, tp.di, mode, bv, tp.inv_d,
                          false, par);
    float v = point<ORD>(h.v, tp.tcol, tp.pos, tp.K, tp.di, mode, bv, tp.inv_d,
                         false, par);
    if (tp.colwarp) {
        const float w = point<ORD>(h.v, tp.tcol, tp.pos, tp.K, tp.di, mode, bv,
                                   tp.inv_d, true, par);
        v = tp.col0 ? w : v;
    }
    return v;
}

// Row y of a level (mode 0 Jacobi, 1 red/black, 2 the residual) from the
// previous level's rows y - 1, y, y + 1 (a, m, c) and b's row y.  Zero
// outside the grid.  A red/black row computes the points of the stage's
// colour, j = p and p + 2, and copies the others.  Row 0 of a cornered
// level is computed again with its region rows of the table, in a branch
// the whole warp takes or skips (column 0 is handled in row_point).
template <int ORD>
__device__ __forceinline__ void level_row(
    Row& out, const Row& a, const Row& m, const Row& c, const Taps& tp,
    const float (&bv)[V], int mode, float par, int y, const Ctx& cx)
{
    const bool rin = y >= 0 && y < cx.ny;
    const int p = ((int)par - y) & 1;   // a red/black stage's first j
    if (mode == MODE_RB) {
        if (p == 0) {
            out.v[1] = row_point<ORD>(a, m, c, 0, tp, MODE_RB, bv[0], par);
            out.v[2] = m.v[2];
            out.v[3] = row_point<ORD>(a, m, c, 2, tp, MODE_RB, bv[2], par);
            out.v[4] = m.v[4];
        } else {
            out.v[1] = m.v[1];
            out.v[2] = row_point<ORD>(a, m, c, 1, tp, MODE_RB, bv[1], par);
            out.v[3] = m.v[3];
            out.v[4] = row_point<ORD>(a, m, c, 3, tp, MODE_RB, bv[3], par);
        }
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
            out.v[1 + j] = row_point<ORD>(a, m, c, j, tp, mode, bv[j], par);
    }
    if (tp.corner && y == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
            const int msk = 1 | (cx.x0 + j == 0 ? 2 : 0);
            if (tp.rowmap[msk] >= 0 && (mode != MODE_RB || (j & 1) == p)) {
                Hood h;
                hood(h, a, m, c, j);
                out.v[1 + j] = point<ORD>(h.v, tp.table[msk], tp.pos, tp.K, tp.di,
                                          mode, bv[j], 0.0f, true, par);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
        out.v[1 + j] = rin && cx.colin[j] ? out.v[1 + j] : 0.0f;
    halo(out);
}

__device__ __forceinline__ void store_row(float* g, const Row& r, int y,
                                          const Ctx& c)
{
    float* p = g + (size_t)y * c.nx + c.x0;
    if (c.vec) {
        if (c.colin[0])
            *reinterpret_cast<float4*>(p) = make_float4(r.v[1], r.v[2], r.v[3], r.v[4]);
    } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
            if (c.colin[j]) p[j] = r.v[1 + j];
    }
}

// NL levels: 0 the start iterate, 1..S the stages, and with RES the
// residual, S + 1 (stored or restricted by pl.emit).  At most 168 registers
// a thread (12 warps an SM) up to six levels, 255 deeper.
template <int ORD, int S, int RES>
__global__ void __launch_bounds__(WARPS * 32, S + RES < 6 ? 3 : 2)
march2d_kernel(
    const Plan pl, const float* __restrict__ values,
    const float* __restrict__ table, const float* __restrict__ b,
    const float* __restrict__ xin, const float* __restrict__ ec,
    float* __restrict__ x_out, float* __restrict__ r_out, int ny, int nx)
{
    constexpr int NL = S + 1 + RES;
    // taps[m][k]: tap of offset k for a point whose zero-coordinate mask is m
    __shared__ float taps[4][MAXK];
    __shared__ int rowmap[4];
    __shared__ int pos[MAXK];
    const int tid = threadIdx.x;
    if (tid < 4 * MAXK) {
        const int m = tid / MAXK, k = tid - m * MAXK;
        const int row = pl.rowmap[m];
        taps[m][k] = k >= pl.K ? 0.0f : row < 0 ? values[k] : table[row * pl.K + k];
    }
    if (tid < 4) rowmap[tid] = pl.rowmap[tid];
    if (tid < MAXK) pos[tid] = pl.pos[tid];
    __syncthreads();

    const int wid = blockIdx.x * WARPS + (tid >> 5);
    if (wid >= pl.strips * pl.chunks) return;
    if (blockIdx.y > 0) {
        // member blockIdx.y of a batch: planes ny*nx floats apart, coarse
        // ones (ec, a restricted residual) a quarter of that
        const size_t mf = (size_t)blockIdx.y * ny * nx;
        const size_t mc = (size_t)blockIdx.y * (ny >> 1) * (nx >> 1);
        b += mf;
        x_out += mf;
        if (xin != nullptr) xin += mf;
        if (ec != nullptr) ec += mc;
        if (r_out != nullptr) r_out += pl.emit == 2 ? mc : mf;
    }
    const int strip = wid % pl.strips, chunk = wid / pl.strips;
    Ctx cx;
    cx.lane = tid & 31;
    cx.x0 = strip * pl.ow - pl.hp + V * cx.lane;
    cx.ny = ny;
    cx.nx = nx;
    cx.vec = pl.vec;
#pragma unroll
    for (int j = 0; j < V; ++j) cx.colin[j] = cx.x0 + j >= 0 && cx.x0 + j < nx;
    const int y0 = chunk * pl.rows;
    const int y1 = min(y0 + pl.rows, ny);
    const bool own = V * cx.lane >= pl.hp && V * cx.lane < W - pl.hp && cx.x0 < nx;

    Taps tp;
#pragma unroll
    for (int k = 0; k < MAXK; ++k) tp.treg[k] = taps[0][k];
    tp.col0 = pl.corner && cx.x0 == 0 && rowmap[2] >= 0;
    tp.colwarp = __any_sync(FULL, tp.col0);
#pragma unroll
    for (int k = 0; k < MAXK; ++k) tp.tcol[k] = tp.col0 ? taps[2][k] : taps[0][k];
    tp.table = taps;
    tp.rowmap = rowmap;
    tp.pos = pos;
    tp.K = pl.K;
    tp.di = pl.di;
    tp.corner = pl.corner;
    tp.inv_d = 1.0f / taps[0][pl.di];

    // lv[L][0..2]: level L's rows t - L - 2, t - L - 1, t - L after step t,
    // shifted up a row a step; bq[L]: b's row t - L, which level L reads at
    // step t (it moves down a level a step, so b is read once)
    Row lv[NL][3];
    float bq[NL][V];
#pragma unroll
    for (int L = 0; L < NL; ++L) {
#pragma unroll
        for (int s = 0; s < 3; ++s) zero_row(lv[L][s]);
#pragma unroll
        for (int j = 0; j < V; ++j) bq[L][j] = 0.0f;
    }

    const int t0 = y0 - pl.H, tlast = y1 - 1 + pl.H;
    // the next step's reads, in flight during this step
    float bn[V];
    Start sn;
    load_row(bn, b, t0 - 1, cx);
    load_start(sn, xin, ec, t0, cx);
    for (int t = t0; t <= tlast; ++t) {
#pragma unroll
        for (int L = NL - 1; L >= 2; --L)
#pragma unroll
            for (int j = 0; j < V; ++j) bq[L][j] = bq[L - 1][j];
#pragma unroll
        for (int j = 0; j < V; ++j) bq[1][j] = bn[j];
        const Start s = sn;
        load_row(bn, b, t, cx);
        load_start(sn, xin, ec, t + 1, cx);

#pragma unroll
        for (int L = 0; L < NL; ++L) {
            lv[L][0] = lv[L][1];
            lv[L][1] = lv[L][2];
            if (L == 0) {
                start_row(lv[0][2], pl.pw, s, ec != nullptr, t, cx);
            } else {
                const int st = L <= S ? L - 1 : 0;
                level_row<ORD>(lv[L][2], lv[L - 1][0], lv[L - 1][1], lv[L - 1][2],
                               tp, bq[L], L <= S ? pl.kind[st] : MODE_RESIDUAL,
                               L <= S ? pl.par[st] : 0.0f, t - L, cx);
            }
        }

        // the iterate: level S, row t - S
        const int yx = t - S;
        if (own && yx >= y0 && yx < y1) store_row(x_out, lv[S][2], yx, cx);
        if constexpr (RES) {
            const int y = t - S - 1;
            if (pl.emit == 1 && own && y >= y0 && y < y1)
                store_row(r_out, lv[S + 1][2], y, cx);
        }
        if (RES && pl.emit == 2) {
            // residual row y = 2 cy + 1 completes coarse row cy; the lane's
            // coarse columns c0, c0 + 1 sit over fine x0, x0 + 2
            const int y = t - S - 1;
            const int cy = (y - 1) >> 1, c0 = cx.x0 >> 1, ncx = nx >> 1;
            if (own && (y & 1) && y - 1 >= y0 && y - 1 < y1 && cy < (ny >> 1)) {
                const Row* r = lv[S + RES];
                const float* w = pl.rw;
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    float ax = 0.0f;
#pragma unroll
                    for (int e = 0; e < 3; ++e) {   // fine column x0 + 2q - 1 + e
                        float ay = 0.0f;
                        ay += w[0] * r[0].v[2 * q + e];
                        ay += w[1] * r[1].v[2 * q + e];
                        ay += w[2] * r[2].v[2 * q + e];
                        ax += w[e] * ay;
                    }
                    if (c0 + q < ncx) r_out[(size_t)cy * ncx + c0 + q] = ax;
                }
            }
        }
    }
}

template <int ORD, int S, int RES>
int launch(const Plan& pl, cudaStream_t stream, const float* values,
           const float* table, const float* b, const float* x, const float* ec,
           float* x_out, float* r_out, int ny, int nx)
{
    const long long warps = (long long)pl.strips * pl.chunks;
    const int blocks = (int)((warps + WARPS - 1) / WARPS);
    march2d_kernel<ORD, S, RES><<<dim3(blocks, pl.members), WARPS * 32, 0, stream>>>(
        pl, values, table, b, x, ec, x_out, r_out, ny, nx);
    return (int)cudaGetLastError();
}

// the instance of (ORD, S, RES), S + RES <= MAX_DEPTH, found by recursion
template <int ORD, int RES, int S>
int by_stages(int n_stages, const Plan& pl, cudaStream_t st, const float* values,
              const float* table, const float* b, const float* x, const float* ec,
              float* x_out, float* r_out, int ny, int nx)
{
    if (n_stages == S)
        return launch<ORD, S, RES>(pl, st, values, table, b, x, ec, x_out, r_out,
                                   ny, nx);
    if constexpr (S > 0)
        return by_stages<ORD, RES, S - 1>(n_stages, pl, st, values, table, b, x,
                                          ec, x_out, r_out, ny, nx);
    return -1;
}

template <int ORD>
int by_emit(int emit, int n_stages, const Plan& pl, cudaStream_t st,
            const float* values, const float* table, const float* b,
            const float* x, const float* ec, float* x_out, float* r_out, int ny,
            int nx)
{
    if (emit == 0)
        return by_stages<ORD, 0, MAX_DEPTH>(n_stages, pl, st, values, table, b, x,
                                            ec, x_out, r_out, ny, nx);
    return by_stages<ORD, 1, MAX_DEPTH - 1>(n_stages, pl, st, values, table, b, x,
                                            ec, x_out, r_out, ny, nx);
}

bool same_order(const Plan& pl, const int* pos, int K)
{
    if (pl.K != K) return false;
    for (int k = 0; k < K; ++k)
        if (pl.pos[k] != pos[k]) return false;
    return true;
}

}  // namespace

// The deepest visit one launch takes: stages, +1 with a residual, +1 more
// with a restriction.  The wrapper splits deeper visits.
extern "C" int omg_fused2d_max_depth() { return MAX_DEPTH; }

// Columns of a strip, halo included (the wrapper's plan is made for them).
extern "C" int omg_fused2d_strip() { return W; }

// One launch on `stream`: n_stages stages of kinds[s] (0 Jacobi with omega
// pars[s], 1 red/black with colour pars[s]), then the optional residual.
// Returns 0, a CUDA error code, or -1 for arguments the kernel does not take.
//
//   values (K,) and table (n_regions, K): device pointers (table may be null
//     when every rowmap entry is -1).
//   offs (2K ints), rowmap (4 ints), kinds / pars (n_stages), rw / pw (3
//     floats: weights of taps -1, 0, +1): host pointers.
//   b (ny, nx); x: start iterate or null (zero); ec (ny/2, nx/2) coarse
//     correction or null.  x_out (ny, nx) is always written.
//   emit: 0 none; 1 r_out (ny, nx) = b - A x; 2 r_out (ny/2, nx/2) =
//     R (b - A x).  A transfer needs even ny and nx.  Outputs must not alias
//     inputs.
//   plan (5 ints): hp, ow, rows, strips, chunks: a warp marches `rows` rows
//     of a strip of W columns that owns ow = W - 2 hp of them; hp a multiple
//     of 4 and at least the depth (+1 with a prolongation); strips * ow >=
//     nx, chunks * rows >= ny, rows even.
//   members: planes of a batch stacked along a leading axis (every grid
//     pointer then holds that many planes, one after another); 1 for one.
extern "C" int omg_fused_stages_2d(
    const float* values, const float* table, const int* offs, int K,
    const int* rowmap, const float* b, const float* x, const float* ec,
    float* x_out, float* r_out, int ny, int nx, int n_stages,
    const int* kinds, const float* pars, int emit, const float* rw,
    const float* pw, const int* plan, int members, void* stream_ptr)
{
    if (K < 1 || K > MAXK || ny < 1 || nx < 1 || x_out == nullptr) return -1;
    if (members < 1 || members > 65535) return -1;
    if (emit < 0 || emit > 2 || (emit != 0 && r_out == nullptr)) return -1;
    if ((ec != nullptr || emit == 2) && ((ny | nx) & 1)) return -1;
    const int H = n_stages + (emit >= 1 ? 1 : 0) + (emit == 2 ? 1 : 0);
    if (n_stages < 0 || H > MAX_DEPTH) return -1;

    Plan pl;
    pl.K = K;
    pl.di = -1;
    pl.H = H;
    pl.hp = plan[0];
    pl.ow = plan[1];
    pl.rows = plan[2];
    pl.strips = plan[3];
    pl.chunks = plan[4];
    // the prolongation reads the coarse column right of a lane's: one more
    // column of halo
    if (pl.hp < H + (ec != nullptr ? 1 : 0) || (pl.hp % V) || pl.ow != W - 2 * pl.hp
        || pl.ow < V || pl.rows < 2 || (pl.rows & 1) || pl.strips < 1
        || pl.chunks < 1 || (long long)pl.strips * pl.ow < nx
        || (long long)pl.chunks * pl.rows < ny)
        return -1;
    for (int k = 0; k < MAXK; ++k) pl.pos[k] = 4;
    for (int k = 0; k < K; ++k) {
        const int oy = offs[2 * k], ox = offs[2 * k + 1];
        if (oy < -1 || oy > 1 || ox < -1 || ox > 1) return -1;
        if (oy == 0 && ox == 0) pl.di = k;
        pl.pos[k] = (oy + 1) * 3 + (ox + 1);
    }
    if (pl.di < 0) return -1;
    pl.corner = 0;
    for (int m = 0; m < 4; ++m) {
        pl.rowmap[m] = rowmap[m];
        if (rowmap[m] >= 0 && table == nullptr) return -1;
        pl.corner |= rowmap[m] >= 0;
    }
    for (int s = 0; s < MAX_DEPTH; ++s) {
        pl.kind[s] = s < n_stages ? kinds[s] : 0;
        pl.par[s] = s < n_stages ? pars[s] : 0.0f;
        if (s < n_stages && kinds[s] != MODE_JACOBI && kinds[s] != MODE_RB)
            return -1;
    }
    for (int t = 0; t < 3; ++t) {
        pl.rw[t] = rw[t];
        pl.pw[t] = pw[t];
    }
    const uintptr_t ptrs = (uintptr_t)b | (uintptr_t)x | (uintptr_t)x_out
                           | (emit == 1 ? (uintptr_t)r_out : 0);
    pl.vec = (nx % V == 0) && (ptrs & 15) == 0;
    pl.emit = emit;
    pl.members = members;
    cudaStream_t st = (cudaStream_t)stream_ptr;
    if (same_order(pl, Order<1>::pos, Order<1>::K))
        return by_emit<1>(emit, n_stages, pl, st, values, table, b, x, ec, x_out,
                          r_out, ny, nx);
    if (same_order(pl, Order<2>::pos, Order<2>::K))
        return by_emit<2>(emit, n_stages, pl, st, values, table, b, x, ec, x_out,
                          r_out, ny, nx);
    return by_emit<0>(emit, n_stages, pl, st, values, table, b, x, ec, x_out,
                      r_out, ny, nx);
}
