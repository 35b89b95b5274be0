// One leg of a level visit on per-point coefficient grids, in one launch:
// S = P passes (weighted-Jacobi steps, or red/black half-sweeps of
// alternating colour) of a radius-1 3D stencil with K <= 27 coefficient
// grids coef[K, nz, ny, nx], started from zero (x is never read) or from a
// given x, optionally followed by the residual b - A x of the last iterate,
// for depths S of 2 and 3 (a single pass is csrc/half_sweep.cu's):
//
//   jacobi    x' = x + omega * (inv_d * (b - sum_k a_k x[i + o_k]))
//   rb        x' = inv_d * (b - sum_{k != diag} a_k x[i + o_k])  where the
//             point's global parity (z + y + x) & 1 is the pass's colour,
//             else x
//   residual  r  = b - sum_k a_k x[i + o_k]
//
// with inv_d = 1 / a_diag per point and zero outside the grid.
//
// Replaces the TPU kernel openmg_tpu/ops/kernels.py::_half_sweep_vary (body
// _vary_kernel), which the JAX package launches once a pass, for every pass
// of a leg and for the residual.
//
// What bounds it on an H100.  By bytes, a leg needs the K coefficient grids,
// b (and x) read once and x (and r) written once: 4 (K + 3) bytes a point,
// where one launch a pass reads them once a pass (9 times in a V(2,2)
// red/black visit).  The lagging passes of a launch read the coefficients
// of planes the leading pass read 2, 4 steps before; across the card that
// window is far larger than the 50 MB L2 (PERF.md), so without the ring
// below each pass reads them from device memory again.
//
// What the design does:
//   * Tiles of y and x, marching z.  A block owns OY = FY - 2S rows by
//     OX = 120 columns of a chunk of ZC planes and holds its tile with a
//     halo of S rows and 4 columns (a 16-byte word): FY rows of 128
//     columns, a thread a 16-byte word (four cells), a warp a row.  It
//     walks the chunk's planes and S more on either side.  FY is 16, or
//     with the coefficient ring as many rows as its shared memory allows;
//     ZC gives one wave of blocks where the tiles leave room for it.
//   * A pipeline of planes, one barrier a step.  At step t the input plane
//     t is loaded (level 0: its load is issued before the levels' work and
//     stored after it) and level s (pass s, the residual at s = S)
//     computes plane t - 2s from the three planes of level s - 1 around it,
//     which that level wrote at steps before t: nothing a level reads is
//     written in the same step.  Every level below S writes its own ring of
//     four planes in shared memory and never updates in place, so a pass
//     reads only the values before it, which is what a red/black pass needs
//     on 27-point operators (a red point has red neighbours there).  The
//     last pass and the residual write device memory, on the block's own
//     cells only.
//   * The coefficient ring (CR: depth 2, up to 9 taps, grids with one
//     16-byte load a word).
//     The coefficients, b and 1/diag a level needs are those of its own
//     cells, so a thread needs again, two steps later, what it read for the
//     level before.  With CR each thread copies the K + 2 grids of the
//     plane level 1 computes at the next step, every cell, into its slot of
//     a ring of 2S planes in shared memory (cp.async, one plane ahead, so
//     the copy runs under a step's work), and every level reads them there:
//     they cross device memory once a launch.  Its cost is shared memory:
//     2S (K + 2) words a thread, 36 at 7 taps, so one block of 10 or 11
//     rows fills an SM.  At depth 3 (54 words) or 27 taps (116) no tile of
//     useful height fits (PERF.md).  Measured, it pays where every level
//     computes every cell (Jacobi) and ties on red/black passes.
//   * Level s is exact on the rows, columns and planes at least s from the
//     loaded edge, so the owned cells are exact after S levels; a warp (a
//     row) outside that skips the level.  A halo cell is computed by every
//     block that holds it, from the same inputs in the same order, so it
//     has the same value in each.
//   * A red/black pass computes only its colour's cells: a word's first
//     cell is even, so along a row they are cells 0 and 2 or 1 and 3 of
//     every word, one branch a warp.
//   * 1/diag comes from the level's own grid where the caller passes it,
//     else as the correctly rounded reciprocal of the diagonal (the same
//     value).
//   * A row of the stencil is one 16-byte shared load; the x-neighbours of
//     a word's end cells come from the next lanes by shuffles.  The 7-point
//     and 27-point operators in the orders the port builds them have their
//     offsets fixed at compile time (recursion on template arguments);
//     another operator runs the same body with them read at run time.  The
//     depth is a template argument (the level loop unrolled).  Grids with
//     nx % 4 == 0 and 16-byte aligned arrays take one 16-byte load a word,
//     others cell by cell.
//   * What a launch needs of the device (SM count, the kernel's registers,
//     its shared-memory limit) is read once per kernel and process; the
//     tile and chunk then follow from the grid's shape by arithmetic.
//   * Out-of-grid cells are zero at every level (the Dirichlet zero), and
//     no address outside an array is ever formed into a load.
//
// The batched form (K4b: the TPU kernel under jax.vmap, whose grid gains a
// leading batch axis): nmem members of one grid, b, x_in, x_out and r_out
// (nmem, nz, ny, nx), one launch for all; the coefficient grids and 1/diag
// are shared.  The member is the fastest part of blockIdx.x, so the nmem
// blocks of one tile are neighbours in the launch order and read the
// tile's coefficient planes, most of a leg's bytes, through L2 once
// instead of once a member.  A member's cells are computed as in the
// scalar launch (the same instance, the same order; a cell's value does
// not depend on the tiling or the chunk), so each member equals the scalar
// launch on it bit for bit.  The batch changes no fit: FY and the ring
// depend on the operator and the depth alone, and only the chunk count ZC
// sees the nmem-fold grid.
//
// Rounding: the sum runs in the order of the offsets list (the diagonal is
// skipped in a red/black pass) and the update multiplies by 1/diag, as the
// plain PyTorch loop of passes does; nvcc may contract a*b+c into a fused
// multiply-add, which the plain version does not, so they agree to a few
// ulp a pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 27;
constexpr int MAX_LEG = 3;   // passes + residual in one launch: kernels.LEG_DEPTH
constexpr int PX = 128;      // tile columns, halo included
constexpr int WPR = PX / 4;  // 16-byte words a row: one warp a row
constexpr int HX = 4;        // halo columns: a depth of at most 3, rounded up to a word
constexpr int OX = PX - 2 * HX;
// tile rows (warps) a block: 512 threads, at most 128 registers a thread
// (at 768 threads the 27-point sums spilled)
constexpr int MAX_ROWS = 16;
constexpr int RING_MAXK = 9;          // the coefficient ring's operators
constexpr int SMEM_BLOCK = 232448;    // dynamic shared memory a block may take
constexpr int SMEM_SM = 233472;       // shared memory an SM has
constexpr int SMEM_RESERVED = 1024;   // the system's share of it a block
constexpr unsigned FULL = 0xffffffffu;

enum Mode { MODE_JACOBI = 0, MODE_RB = 1 };

struct Leg {
    int K, di;
    int oz[MAXK], oy[MAXK], ox[MAXK];
    int passes, residual, zero, color0;
    float omega;
    int FY, OY, ZC;
};

// the two operators the port builds, in their offsets order
struct Std7 {
    static constexpr int K = 7;
    static constexpr int oz[7] = {0, -1, 1, 0, 0, 0, 0};
    static constexpr int oy[7] = {0, 0, 0, -1, 1, 0, 0};
    static constexpr int ox[7] = {0, 0, 0, 0, 0, -1, 1};
};
struct Std27 {
    static constexpr int K = 27;
    // the centre, then (oz, oy, ox) in lexicographic order
    static constexpr int oz[27] = {0, -1, -1, -1, -1, -1, -1, -1, -1, -1,
                                   0, 0, 0, 0, 0, 0, 0, 0,
                                   1, 1, 1, 1, 1, 1, 1, 1, 1};
    static constexpr int oy[27] = {0, -1, -1, -1, 0, 0, 0, 1, 1, 1,
                                   -1, -1, -1, 0, 0, 1, 1, 1,
                                   -1, -1, -1, 0, 0, 0, 1, 1, 1};
    static constexpr int ox[27] = {0, -1, 0, 1, -1, 0, 1, -1, 0, 1,
                                   -1, 0, 1, -1, 1, -1, 0, 1,
                                   -1, 0, 1, -1, 0, 1, -1, 0, 1};
};
struct Generic {
    static constexpr int K = 0;
};

// Which cells of a word a level computes: all four, or the two of one
// colour (cells 0 and 2, or 1 and 3).
enum Cells { ALL = 0, EVEN = 1, ODD = 2 };

template <int CELLS>
__device__ __forceinline__ constexpr bool wants(int i)
{
    return CELLS == ALL || (CELLS == EVEN ? (i & 1) == 0 : (i & 1) == 1);
}

// What a level needs to sum its taps for one word.
struct Ctx {
    const float4* lo;   // planes p - 1, p, p + 1 of the level below
    const float4* mid;
    const float4* hi;
    int row, w, FY;
    const float* coef;  // tap 0's coefficient at the word's first cell
    const float* b;     // b at the word's first cell
    const float* inv;   // 1 / diag at the word's first cell, or null
    const float4* rc;   // CR: the thread's ring slot, grid g at rc[g * rs]
    int rs;             // (the taps, then b, then 1 / diag)
    int K;              // taps: b is grid K of the ring, 1 / diag grid K + 1
    size_t n;           // cells a grid
    bool any;           // a cell of the word is in the grid
    bool in0, in1, in2, in3;  // which cells are in the grid
};

// A word of a grid: with VEC (nx % 4 == 0, 16-byte aligned arrays) the
// word is in the grid or out of it as a whole and is one 16-byte load;
// else cell by cell.  Zero outside the grid.
template <bool VEC, int CELLS>
__device__ __forceinline__ float4 ld4(const float* p, const Ctx& c)
{
    if constexpr (VEC) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c.any) v = __ldg(reinterpret_cast<const float4*>(p));
        return v;
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (wants<CELLS>(0) && c.in0) v.x = __ldg(p);
    if (wants<CELLS>(1) && c.in1) v.y = __ldg(p + 1);
    if (wants<CELLS>(2) && c.in2) v.z = __ldg(p + 2);
    if (wants<CELLS>(3) && c.in3) v.w = __ldg(p + 3);
    return v;
}

// Grid g of the word (tap g's coefficients, b at g = K, 1 / diag at
// K + 1): from the thread's ring slot with CR, else from device memory at p.
template <bool CR, bool VEC, int CELLS>
__device__ __forceinline__ float4 grid(const Ctx& c, const float* p, int g)
{
    if constexpr (CR)
        return c.rc[g * c.rs];
    else
        return ld4<VEC, CELLS>(p, c);
}

// The four values of the level below at offset (oz, oy, ox) from the
// word's cells: one shared load, and for ox != 0 one shuffle from the next
// lane (a warp is a row).
__device__ __forceinline__ float4 nb(const Ctx& c, int oz, int oy, int ox)
{
    const float4* pl = oz < 0 ? c.lo : (oz > 0 ? c.hi : c.mid);
    int r = c.row + oy;
    r = r < 0 ? 0 : (r >= c.FY ? c.FY - 1 : r);
    const float4 v = pl[r * WPR + c.w];
    if (ox == 0) return v;
    if (ox < 0) {
        const float l = __shfl_up_sync(FULL, v.w, 1);
        return make_float4(l, v.x, v.y, v.z);
    }
    const float h = __shfl_down_sync(FULL, v.x, 1);
    return make_float4(v.y, v.z, v.w, h);
}

template <int CELLS>
__device__ __forceinline__ void mac(float4& acc, float4 a, float4 v)
{
    if (wants<CELLS>(0)) acc.x += a.x * v.x;
    if (wants<CELLS>(1)) acc.y += a.y * v.y;
    if (wants<CELLS>(2)) acc.z += a.z * v.z;
    if (wants<CELLS>(3)) acc.w += a.w * v.w;
}

// Sum of taps KI.. of a compile-time operator (template recursion: the
// offsets are constants in every term).
template <class OPT, bool CR, bool VEC, int CELLS, bool SKIP_DIAG, int KI>
__device__ __forceinline__ void taps(const Ctx& c, float4& acc)
{
    if constexpr (KI < OPT::K) {
        constexpr int oz = OPT::oz[KI], oy = OPT::oy[KI], ox = OPT::ox[KI];
        if constexpr (!(SKIP_DIAG && oz == 0 && oy == 0 && ox == 0))
            mac<CELLS>(acc, grid<CR, VEC, CELLS>(c, c.coef + (size_t)KI * c.n, KI),
                       nb(c, oz, oy, ox));
        taps<OPT, CR, VEC, CELLS, SKIP_DIAG, KI + 1>(c, acc);
    }
}

template <class OPT, bool CR, bool VEC, int CELLS, bool SKIP_DIAG>
__device__ __forceinline__ float4 sum_taps(const Ctx& c, const Leg& L)
{
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (OPT::K > 0) {
        taps<OPT, CR, VEC, CELLS, SKIP_DIAG, 0>(c, acc);
    } else {
        for (int k = 0; k < L.K; ++k) {
            if (SKIP_DIAG && k == L.di) continue;
            mac<CELLS>(acc, grid<CR, VEC, CELLS>(c, c.coef + (size_t)k * c.n, k),
                       nb(c, L.oz[k], L.oy[k], L.ox[k]));
        }
    }
    return acc;
}

// 1 / diag on the word's cells: the caller's grid of reciprocals where it
// gives one, else the correctly rounded reciprocal of the diagonal tap
// (equal to 1.0f / d).
template <bool CR, bool VEC, int CELLS>
__device__ __forceinline__ float4 inv_diag(const Ctx& c, const Leg& L)
{
    if (c.inv) return grid<CR, VEC, CELLS>(c, c.inv, c.K + 1);
    const float4 d = grid<CR, VEC, CELLS>(c, c.coef + (size_t)L.di * c.n, L.di);
    return make_float4(__frcp_rn(d.x), __frcp_rn(d.y), __frcp_rn(d.z),
                       __frcp_rn(d.w));
}

// 16 bytes from device memory into shared memory, asynchronously; zeros
// where `in` is false (nothing is read then).
__device__ __forceinline__ void cp16(float4* dst, const float* src, bool in)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(in ? 16 : 0));
}

// One red/black pass on the word's cells of one colour (CELLS EVEN or
// ODD): inv_d * (b - sum) there, the level below's value elsewhere.
template <class OPT, bool CR, bool VEC, int CELLS>
__device__ __forceinline__ float4 rb_word(const Ctx& c, const Leg& L,
                                          float4 xc, bool first)
{
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!first) acc = sum_taps<OPT, CR, VEC, CELLS, true>(c, L);
    const float4 bv = grid<CR, VEC, CELLS>(c, c.b, c.K);
    const float4 iv = inv_diag<CR, VEC, CELLS>(c, L);
    float4 o = xc;
    if (wants<CELLS>(0)) o.x = iv.x * (bv.x - acc.x);
    if (wants<CELLS>(1)) o.y = iv.y * (bv.y - acc.y);
    if (wants<CELLS>(2)) o.z = iv.z * (bv.z - acc.z);
    if (wants<CELLS>(3)) o.w = iv.w * (bv.w - acc.w);
    return o;
}

// What a thread keeps for the whole launch.
struct Tile {
    int row, w, gy, z0, zc, NP, r0, plane4, tid, nthr;
    bool i0, i1, i2, i3, word_in, owned_xy;
    long long cell0;      // the word's first cell on plane 0 of the chunk
    long long plane;      // cells a plane
    size_t n;             // cells a grid
};

// Level s (pass s, or the residual at s = S) at step t: plane t - 2s.
template <class OPT, int MODE, bool VEC, int S, bool CR>
__device__ __forceinline__ void level(
    const int s, const int t, const Leg& L, const Tile& T, float4* rings,
    float4* cring, const float* __restrict__ coef,
    const float* __restrict__ inv_d, const float* __restrict__ b,
    float* __restrict__ x_out, float* __restrict__ r_out, int nz)
{
    const int FY = L.FY;
    const int p = t - 2 * s;
    // the block's planes and the warp's row where level s is exact
    if (p < s || p >= T.NP - s || T.row < s || T.row >= FY - s) return;
    const int gz = T.z0 - S + p;
    const bool plane_in = gz >= 0 && gz < nz;
    const bool first = L.zero && s == 1;  // reads the zero start
    const bool resid = L.residual && s == S;
    Ctx c;
    if (!first) {
        const float4* base = rings + (size_t)(s - 1 + T.r0) * 4 * T.plane4;
        c.lo = base + ((p - 1) & 3) * T.plane4;
        c.mid = base + (p & 3) * T.plane4;
        c.hi = base + ((p + 1) & 3) * T.plane4;
    }
    c.row = T.row;
    c.w = T.w;
    c.FY = FY;
    c.n = T.n;
    c.K = OPT::K > 0 ? OPT::K : L.K;
    c.any = plane_in && T.word_in;
    c.in0 = plane_in && T.i0;
    c.in1 = plane_in && T.i1;
    c.in2 = plane_in && T.i2;
    c.in3 = plane_in && T.i3;
    const size_t cell = plane_in ? (size_t)(T.cell0 + p * T.plane) : 0;
    c.coef = coef + cell;
    c.b = b + cell;
    c.inv = inv_d ? inv_d + cell : nullptr;
    if constexpr (CR) {
        c.rc = cring + (size_t)(p % (2 * S)) * (c.K + 2) * T.nthr + T.tid;
        c.rs = T.nthr;
    }
    const int at = T.row * WPR + T.w;
    const float4 xc = first ? make_float4(0.f, 0.f, 0.f, 0.f) : c.mid[at];
    float4 out;
    if (resid || MODE == MODE_JACOBI) {
        const float4 acc = first ? make_float4(0.f, 0.f, 0.f, 0.f)
                                 : sum_taps<OPT, CR, VEC, ALL, false>(c, L);
        const float4 bv = grid<CR, VEC, ALL>(c, c.b, c.K);
        if (resid) {
            out = make_float4(bv.x - acc.x, bv.y - acc.y, bv.z - acc.z,
                              bv.w - acc.w);
        } else {
            const float4 iv = inv_diag<CR, VEC, ALL>(c, L);
            const float om = L.omega;
            out.x = xc.x + om * (iv.x * (bv.x - acc.x));
            out.y = xc.y + om * (iv.y * (bv.y - acc.y));
            out.z = xc.z + om * (iv.z * (bv.z - acc.z));
            out.w = xc.w + om * (iv.w * (bv.w - acc.w));
        }
    } else {
        // the word's first cell is even (tile origins are), so the colour's
        // cells are 0 and 2 or 1 and 3 along the whole row
        const int color = (L.color0 + s - 1) & 1;
        if (((gz + T.gy) & 1) == color)
            out = rb_word<OPT, CR, VEC, EVEN>(c, L, xc, first);
        else
            out = rb_word<OPT, CR, VEC, ODD>(c, L, xc, first);
    }
    // out of the grid: the Dirichlet zero
    if constexpr (VEC) {
        if (!c.any) out = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
        if (!c.in0) out.x = 0.f;
        if (!c.in1) out.y = 0.f;
        if (!c.in2) out.z = 0.f;
        if (!c.in3) out.w = 0.f;
    }
    if (s < S) rings[((size_t)(s + T.r0) * 4 + (p & 3)) * T.plane4 + at] = out;
    const bool to_x = s == L.passes;
    if ((to_x || resid) && T.owned_xy && plane_in && p >= S && p < S + T.zc) {
        float* dst = (resid ? r_out : x_out) + cell;
        if constexpr (VEC) {
            if (c.any) *reinterpret_cast<float4*>(dst) = out;
        } else {
            if (c.in0) dst[0] = out.x;
            if (c.in1) dst[1] = out.y;
            if (c.in2) dst[2] = out.z;
            if (c.in3) dst[3] = out.w;
        }
    }
}

// CR: the K + 2 grids of plane q (the plane level 1 computes at the next
// step) into the thread's slot of the ring, every cell, asynchronously.
template <class OPT, int S>
__device__ __forceinline__ void prefetch(
    const int q, const Leg& L, const Tile& T, float4* cring,
    const float* __restrict__ coef, const float* __restrict__ inv_d,
    const float* __restrict__ b, int nz)
{
    if (q < 1 || q >= T.NP - 1 || T.row < 1 || T.row >= L.FY - 1) return;
    const int K = OPT::K > 0 ? OPT::K : L.K;
    const int gz = T.z0 - S + q;
    const bool in = gz >= 0 && gz < nz && T.word_in;
    const size_t cell = in ? (size_t)(T.cell0 + q * T.plane) : 0;
    float4* slot = cring + (size_t)(q % (2 * S)) * (K + 2) * T.nthr + T.tid;
    if constexpr (OPT::K > 0) {
#pragma unroll
        for (int k = 0; k < OPT::K; ++k)
            cp16(slot + k * T.nthr, coef + (size_t)k * T.n + cell, in);
    } else {
        for (int k = 0; k < K; ++k)
            cp16(slot + k * T.nthr, coef + (size_t)k * T.n + cell, in);
    }
    cp16(slot + K * T.nthr, b + cell, in);
    if (inv_d) cp16(slot + (K + 1) * T.nthr, inv_d + cell, in);
}

template <class OPT, int MODE, bool VEC, int S, bool CR>
__global__ void __launch_bounds__(MAX_ROWS * WPR) vary_leg_kernel(
    const __grid_constant__ Leg L, const float* __restrict__ coef,
    const float* __restrict__ inv_d, const float* __restrict__ b,
    const float* __restrict__ x_in, float* __restrict__ x_out,
    float* __restrict__ r_out, int nz, int ny, int nx, int nmem)
{
    // the iterate's rings [ring][4 slots][FY rows][WPR words], then with CR
    // the coefficient ring [2S slots][K + 2 grids][threads]
    extern __shared__ float4 smem[];
    // member blockIdx.x % nmem of a batch: its own b, x and outputs
    const int member = blockIdx.x % nmem;
    const size_t mo = (size_t)member * nz * ny * nx;
    b += mo;
    if (x_in) x_in += mo;
    if (x_out) x_out += mo;
    if (r_out) r_out += mo;
    Tile T;
    T.row = threadIdx.x / WPR;
    T.w = threadIdx.x % WPR;
    T.tid = threadIdx.x;
    T.nthr = blockDim.x;
    T.plane4 = L.FY * WPR;  // float4s a plane
    const int gx = (blockIdx.x / nmem) * OX - HX + 4 * T.w;  // the word's first cell
    T.gy = blockIdx.y * L.OY - S + T.row;
    T.z0 = blockIdx.z * L.ZC;
    T.zc = min(L.ZC, nz - T.z0);
    T.NP = T.zc + 2 * S;  // planes of level 0
    T.n = (size_t)nz * ny * nx;
    T.plane = (long long)ny * nx;
    T.cell0 = ((long long)(T.z0 - S) * ny + T.gy) * nx + gx;
    const bool row_in = T.gy >= 0 && T.gy < ny;
    T.i0 = row_in && gx >= 0 && gx < nx;
    T.i1 = row_in && gx + 1 >= 0 && gx + 1 < nx;
    T.i2 = row_in && gx + 2 >= 0 && gx + 2 < nx;
    T.i3 = row_in && gx + 3 >= 0 && gx + 3 < nx;
    T.word_in = T.i0 && T.i3;
    T.r0 = L.zero ? -1 : 0;  // ring of level s: s + r0
    T.owned_xy = T.row >= S && T.row < L.FY - S && 4 * T.w >= HX
        && 4 * T.w < PX - HX;
    const int at = T.row * WPR + T.w;
    float4* rings = smem;
    float4* cring = smem + (size_t)(S + T.r0) * 4 * T.plane4;

    for (int t = 0; t < T.NP + S; ++t) {
        // level 0: plane t of the input iterate, loaded before the levels
        // work and stored after them (level 1 reads it at the next step)
        const bool load = !L.zero && t < T.NP;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (load) {
            const int gz = T.z0 - S + t;
            if (gz >= 0 && gz < nz) {
                const float* p = x_in + (T.cell0 + t * T.plane);
                if constexpr (VEC) {
                    if (T.word_in) v = __ldg(reinterpret_cast<const float4*>(p));
                } else {
                    if (T.i0) v.x = __ldg(p);
                    if (T.i1) v.y = __ldg(p + 1);
                    if (T.i2) v.z = __ldg(p + 2);
                    if (T.i3) v.w = __ldg(p + 3);
                }
            }
        }
        if constexpr (CR) {
            // the grids of plane t - 1 on their way; those of plane t - 2,
            // which level 1 computes now, arrived
            prefetch<OPT, S>(t - 1, L, T, cring, coef, inv_d, b, nz);
            asm volatile("cp.async.commit_group;\n" ::);
            asm volatile("cp.async.wait_group 1;\n" ::);
        }
#pragma unroll
        for (int s = 1; s <= S; ++s)
            level<OPT, MODE, VEC, S, CR>(s, t, L, T, rings, cring, coef, inv_d,
                                         b, x_out, r_out, nz);
        if (load) rings[(t & 3) * T.plane4 + at] = v;
        __syncthreads();
    }
}

// 16-byte words of shared memory a tile row takes
size_t row_words(int S, bool zero, bool cr, int K)
{
    const int nrings = S - 1 + (zero ? 0 : 1);
    return (size_t)WPR * (nrings * 4 + (cr ? 2 * S * (K + 2) : 0));
}

template <class OPT, int MODE, bool VEC, int S, bool CR>
int launch(Leg L, const float* coef, const float* inv, const float* b,
           const float* x_in, float* x_out, float* r_out, int nz, int ny,
           int nx, int nmem, cudaStream_t st)
{
    const auto kern = vary_leg_kernel<OPT, MODE, VEC, S, CR>;
    // read once per kernel and process (the port drives one card)
    static int nsm = 0, regs = 0;
    if (nsm == 0) {
        int dev = 0, n = 0;
        cudaFuncAttributes a;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     SMEM_BLOCK);
        if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kern);
        if (e != cudaSuccess) return (int)e;
        regs = a.numRegs;
        nsm = n;
    }
    // the tile: 16 rows, or with the ring as many as its shared memory allows
    const size_t words = row_words(S, L.zero, CR, OPT::K > 0 ? OPT::K : L.K);
    L.FY = (int)(SMEM_BLOCK / (16 * words));
    L.FY = L.FY < MAX_ROWS ? L.FY : MAX_ROWS;
    L.OY = L.FY - 2 * S;
    if (L.OY < 2) return -4;  // no tile fits
    const size_t smem = 16 * words * L.FY;
    // blocks an SM holds: by warps (one a row), registers (a warp's
    // allocation rounded up to 256) and shared memory
    const int by_warps = 64 / L.FY;
    const int by_regs = 65536 / (L.FY * ((regs * 32 + 255) / 256 * 256));
    const int by_smem = (int)(SMEM_SM / (smem + SMEM_RESERVED));
    const int per_sm = min(by_warps, min(by_regs, by_smem));
    if (per_sm < 1) return -4;
    // chunks of z: the count with the fewest steps a block walks, times the
    // waves of blocks over the SMs
    const long tiles = (long)((nx + OX - 1) / OX) * ((ny + L.OY - 1) / L.OY) * nmem;
    const long slots = (long)nsm * per_sm;
    long best = -1;
    for (int zc = 1; zc <= nz; ++zc) {
        const long chunks = (nz + zc - 1) / zc;
        const long cost = (tiles * chunks + slots - 1) / slots * (zc + 3 * S);
        if (best < 0 || cost < best) {
            best = cost;
            L.ZC = zc;
        }
    }
    const dim3 blocks((nx + OX - 1) / OX * nmem, (ny + L.OY - 1) / L.OY,
                      (nz + L.ZC - 1) / L.ZC);
    kern<<<blocks, L.FY * WPR, smem, st>>>(L, coef, inv, b, x_in, x_out, r_out,
                                          nz, ny, nx, nmem);
    return (int)cudaGetLastError();
}

template <class OPT, int MODE, bool VEC>
int launch_depth(const Leg& L, int S, bool ring, const float* coef,
                 const float* inv, const float* b, const float* x_in,
                 float* x_out, float* r_out, int nz, int ny, int nx, int nmem,
                 cudaStream_t st)
{
    if (S == 3)
        return launch<OPT, MODE, VEC, 3, false>(L, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
    if constexpr (OPT::K <= RING_MAXK && VEC) {
        if (ring)
            return launch<OPT, MODE, VEC, 2, true>(L, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
    }
    return launch<OPT, MODE, VEC, 2, false>(L, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
}

template <class OPT>
int launch_mode(const Leg& L, int S, bool ring, bool vec, int mode,
                const float* coef, const float* inv, const float* b,
                const float* x_in, float* x_out, float* r_out, int nz, int ny,
                int nx, int nmem, cudaStream_t st)
{
    if (mode == MODE_RB) {
        if (vec)
            return launch_depth<OPT, MODE_RB, true>(L, S, ring, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
        return launch_depth<OPT, MODE_RB, false>(L, S, ring, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
    }
    if (vec)
        return launch_depth<OPT, MODE_JACOBI, true>(L, S, ring, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
    return launch_depth<OPT, MODE_JACOBI, false>(L, S, ring, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
}

template <class OPT>
bool same_offsets(const Leg& L)
{
    if (L.K != OPT::K) return false;
    for (int k = 0; k < OPT::K; ++k)
        if (L.oz[k] != OPT::oz[k] || L.oy[k] != OPT::oy[k] || L.ox[k] != OPT::ox[k])
            return false;
    return true;
}

}  // namespace

// One leg of depth passes + residual = 2 or 3.  offs: K*3 ints (z, y, x
// per tap, each in -1..1, one of them the centre).  inv: the grid of
// 1 / coef[centre], or null to form it.  x_in: the start, or null for a
// zero start.  x_out: the last pass's iterate (written when passes >= 1);
// r_out: the residual (written when residual != 0).  mode 0 Jacobi, 1
// red/black (colour of the first pass color0, alternating).  ring: read
// the coefficients from the shared-memory ring (depth 2, at most
// RING_MAXK taps; on grids read cell by cell the launch goes without it).
// nmem: members of a batch (b, x_in, x_out and r_out (nmem, nz, ny, nx); 1 for
// one grid).  Returns 0, a negative code of its own (-1:
// stencil not taken, -2: bad depth, mode, ring, grid or batch, -3: an
// output aliases an input, -4: no tile fits) or the CUDA error of the
// launch.
extern "C" int omg_vary_leg(
    const float* coef, const float* inv, const int* offs, int K, const float* b,
    const float* x_in, float* x_out, float* r_out, int nz, int ny, int nx,
    int passes, int mode, float omega, int color0, int residual, int ring,
    int nmem, void* stream)
{
    if (K < 1 || K > MAXK) return -1;
    Leg L;
    L.K = K;
    L.di = -1;
    for (int k = 0; k < MAXK; ++k) L.oz[k] = L.oy[k] = L.ox[k] = 0;
    for (int k = 0; k < K; ++k) {
        const int oz = offs[3 * k], oy = offs[3 * k + 1], ox = offs[3 * k + 2];
        if (oz < -1 || oz > 1 || oy < -1 || oy > 1 || ox < -1 || ox > 1)
            return -1;
        if (oz == 0 && oy == 0 && ox == 0) L.di = k;
        L.oz[k] = oz;
        L.oy[k] = oy;
        L.ox[k] = ox;
    }
    if (L.di < 0) return -1;
    L.passes = passes;
    L.residual = residual ? 1 : 0;
    const int S = passes + L.residual;
    if (passes < 0 || S < 2 || S > MAX_LEG || (mode != MODE_JACOBI && mode != MODE_RB))
        return -2;
    if (ring && (S != 2 || K > RING_MAXK)) return -2;
    if (nz < 1 || ny < 1 || nx < 1 || nz > 65535) return -2;
    if (nmem < 1 || (long long)((nx + OX - 1) / OX) * nmem > 0x7fffffffLL) return -2;
    if ((passes >= 1 && x_out == nullptr) || (residual && r_out == nullptr))
        return -2;
    if (x_out != nullptr && (x_out == x_in || x_out == b)) return -3;
    if (r_out != nullptr && (r_out == x_in || r_out == b || r_out == x_out)) return -3;
    L.zero = x_in == nullptr;
    L.color0 = color0 & 1;
    L.omega = omega;
    const bool vec = (nx % 4 == 0)
        && ((((uintptr_t)coef) | ((uintptr_t)inv) | ((uintptr_t)b) | ((uintptr_t)x_in)
             | ((uintptr_t)x_out) | ((uintptr_t)r_out)) & 15) == 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (same_offsets<Std7>(L))
        return launch_mode<Std7>(L, S, ring, vec, mode, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
    if (same_offsets<Std27>(L))
        return launch_mode<Std27>(L, S, ring, vec, mode, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
    return launch_mode<Generic>(L, S, ring, vec, mode, coef, inv, b, x_in, x_out, r_out, nz, ny, nx, nmem, st);
}
