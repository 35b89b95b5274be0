// Fused V-cycle level visit for constant and cornered radius-1 stencils.
//
// Replaces the TPU kernel openmg_tpu/ops/fused.py::fused_stages_const_3d
// (body _fused_kernel): S smoothing stages (weighted-Jacobi step or
// red/black half-sweep) of a 3D stencil with K <= 27 taps, optionally
// started from zero (reads only b) or from x + P*ec (prolongation formed on
// load), optionally followed by the residual b - A x or by its restriction
// bc = R (b - A x).  The whole visit is ONE launch when its depth
// D = S (+1 with a residual, +1 more with a restriction) is at most
// MAX_DEPTH; the caller splits a deeper visit into consecutive launches.
//
// What bounds it on an H100.  On a level in device memory (256^3: 64 MB an
// array), bytes: a visit reads b and x (and ec) once and writes x (and r or
// bc) once, 8.5 bytes a point on the down-leg (b read, x written, bc an
// eighth) and 12.5 on the up-leg, against at most 2*27 flops a point and
// stage.  On a level that lives in L2 (the cornered 128^3, 64^3 and 32^3
// levels of the 256^3 hierarchy) fusing saves no device-memory bytes; what
// counts there is the launches and the work of each stage.
//
// So a launch takes one of two shapes, chosen per launch by the host code
// below:
//
// THE RESIDENT VISIT, where the level's tiles all fit on the card at once
// (at most 8 planes x 16 rows x 64 columns a block, two blocks an SM): one
// cooperative launch, each block holding one tile for the whole visit.  The
// stages run one after the other across the grid.  A stage copies its tile
// with a one-cell halo from the iterate (cp.async, past L1: other blocks
// write it during the launch) and b into shared memory, computes its cells
// (a thread a 16-byte word of one row, the same body as the marching visit
// below) into a second buffer, waits at a grid-wide barrier until every
// block has read the iterate, writes its cells in place, and waits again
// until every block has written: two barriers a stage, no scratch array.
// The first stage of an up-leg adds P ec from the coarse region it needs,
// staged in shared memory.  The residual follows the last stage the same
// way.  The restriction forms the block's own coarse points: their taps
// reach one fine cell below the tile on each axis, so the block loads its
// tile with two cells below it, computes the fine residual there into
// shared memory (words as above, the column below cell by cell) and
// restricts from it; the fine residual is never stored.  A tile is as few
// planes (1, 2, 4 or 8; at least 2 with a restriction) as let the grid
// fit, so a small level gets the most blocks.  Against one launch a stage, it saves the launches and the
// separate restriction; against the marching visit, the halo that a D-deep
// tile recomputes, which at 128^3 and below is most of the work.
//
// THE MARCHING VISIT, elsewhere (the 256^3 level): no halo exchange between
// blocks at all, each block recomputing a D-deep halo.
//   * Tile y and x, march along z.  A block owns TYO rows by TXO = 64 - 2H
//     columns of a chunk of ZC planes, and holds its tile with a halo of D
//     rows on y and of H >= D columns on x (H is D rounded up to an even
//     number, so a pair of cells is 8-byte aligned in device memory; a row
//     of the tile is 16-byte aligned in shared memory): PY = TYO + 2D rows
//     of PX = 64 columns.  It walks the chunk's planes and D more on either
//     side.  TYO is the tallest of 32, 24 and 16 whose rings fit (a taller
//     tile recomputes less halo); ZC gives the fewest waves over the SMs.
//   * A pipeline of planes.  At step s plane s + 1 is loading and plane s
//     has arrived; level L (stage L, then the residual at L = S + 1)
//     computes plane s - 2L + d0 from the three planes around it of level
//     L - 1, which that level wrote at steps s - 3 .. s - 1 (level 1 reads
//     the x ring: d0 = 1 reads up to the plane that has just arrived, d0 = 0
//     up to the one before, while level 0 adds P ec to the new one).
//     Nothing a level reads is written in the same step, so a step is one
//     barrier, not one a level (a lag of one plane and a barrier a level
//     measured slower).  Level L is exact on the planes and rows at least L
//     from the loaded edge (a warp with neither of its two rows there skips
//     the level), and every stage of the visit reads device memory once.
//   * Each level writes its own ring of four planes in shared memory and
//     never updates in place: a stage reads only pre-stage values, which is
//     what a red/black stage needs on the 27-point levels, where a red point
//     has red neighbours.
//   * A thread owns four consecutive cells of one row of the tile (one
//     16-byte word), the same at every level and step: a row of the stencil
//     is one 16-byte shared load, its x-neighbours come from the next lanes
//     by shuffles, and the four cells are four independent sums.  A
//     red/black stage computes all four and keeps the new value on the
//     cells of its colour.  (One-cell lanes cost about 40 instructions a
//     cell and ran the visit slower than one launch a stage; two words a
//     thread, or two cells, halved the threads and measured slower.)
//   * The 7-point operator and the cornered 27-point levels have their
//     offsets fixed at compile time (recursion on template arguments: a
//     constexpr helper called in a loop was evaluated at run time and made
//     the 27-point levels several times slower); another operator runs the
//     same code with a per-cell body that reads its offsets at run time.
//   * Loads run one plane ahead: plane s + 1 of x (and the coarse plane of
//     ec it needs) is copied with cp.async (8 bytes where the rows allow
//     it) while the levels work on plane s.  Out-of-domain cells are
//     zero-filled by the copy and set to zero by every level: Dirichlet zero
//     at every stage, not only at load.  b is read by each level from
//     device memory (L1 or L2 after the first level; staging it a step
//     ahead in shared memory, loading it a level ahead and prefetching it
//     into L2 a few steps ahead all measured slower).
//   * The prolongation is added as a plane arrives (level 0), from a ring
//     of three coarse ec planes in shared memory.  The restriction consumes
//     the residual ring: once fine residual plane 2c + 1 is done, coarse
//     plane c is formed from planes 2c - 1 .. 2c + 1.  Fine tile origins are
//     even (TYO, TXO and ZC are), so the coarse points a block writes are
//     exactly those over its fine points.
//   * Shared memory (dynamic, opted in above 48 KB) per plane of the tile:
//     PY * 64 * 4 B.  The x ring has five slots with ec (three read by level
//     1, one being formed, one being loaded), four without, one zero slot
//     for a zero start; every level whose output another level reads has
//     four, and so has the residual before a restriction.  V(2,2)'s
//     down-leg (D = 6, zero start) takes 1 + 4*4 + 4 = 21 planes, 189 KB at
//     TYO = 24; six Jacobi stages 4 + 4*5 = 24 planes, 216 KB at TYO = 24;
//     the up-leg (D = 4) 17 planes, 170 KB at TYO = 32, and 9 KB of ec.
//     One block of 16 (TYO + 12) threads an SM.
//   * Why an overlapped halo is safe: a halo point is recomputed by every
//     block that holds it, from the same inputs with the same arithmetic in
//     the same order, so it has the same value in each.
//   * What holds it back: not bytes (13x the bound on the down-leg).  A step
//     takes about 4 us at 256^3 and shrinks little with the work in it
//     (skipping the halo rows a level does not need saved 3-6 % on the
//     up-leg and the Jacobi visits, nothing on the down-leg), and more
//     memory requests made it slower: the latency of each level's loads, in
//     a chain of levels behind one barrier a step, with one block an SM.
//
// THE HALO FORM (a rank's z-slab of a row-partitioned grid; the TPU
// kernel's halos= argument), marching shape only.  The marching visit
// already walks D planes past its chunk's edges and recomputes them; at the
// slab's edges those planes now come from the D-deep slabs of b and x (and
// the coarse slabs of ec) received from the ranks below and above, where
// the flags open_lo / open_hi say there is a neighbour.  Planes of the
// valid range [zmin, zmax) (zmin = -D with a neighbour below, else 0; zmax
// likewise) are loaded and computed like the slab's own; only the owned
// planes are written.  So a slab's output is the whole grid's rows, with no
// epilogue.  A cornered level's axis-0 regions lie on the first rank only:
// the wrapper drops them from the region table of the others.  The
// resident shape declines halos (its tiles hold no halo along z).  On a
// batch (K1hb) every member has its own received slabs, stacked like its
// grids: b's and x's hlo (hhi) planes of (ny, nx) a member, ec's clo (chi)
// coarse planes a member; the kernel moves those pointers to the member's
// slabs with its grids (a member's slab pointer steps by its own depth,
// never by nz).
//
// THE BATCHED FORM (the TPU kernel under jax.vmap, whose grid gains a
// leading batch axis): nb members of one level stacked along a leading axis
// (b, x, x_out and a fine r_out nz*ny*nx floats apart, ec and a coarse
// r_out an eighth of that), one launch for all of them, with one region
// table, transfer weights and stage plan.  The member is the outer part of
// blockIdx.z, above the z-chunks (or tiles), and the kernel moves its
// pointers to the member's grids; nothing else changes.
//   * The resident shape takes the batch where one member's tiles fit on
//     the card at once, in rounds inside the one cooperative launch: as
//     many members a round as fit together (a divisor of nb), every block
//     passing the round's grid-wide barriers.  Elsewhere the batch marches,
//     all members in one grid.  (Marching eight members of the cornered
//     128^3 level, which fit only one at a time, took 1.7-2.0x the time of
//     eight resident launches on an H100; in rounds, 0.80-0.96x.)
//   * A point's value does not depend on the tiling or the shape that
//     computed it (a tile recomputes its halo with the same arithmetic, and
//     the two shapes share their per-word body; the halo form's marching
//     slabs equal the resident whole grid's rows bit for bit), so every
//     member equals a launch on it alone.  With halos (K1hb) the batch
//     marches, as the halo form does.
//
// Cornered levels (both shapes): the tap of point i for offset k is one row
// of an at most 8-row table, chosen by which of i's coordinates are 0.
// Interior cells use the interior taps; the few cells on a low face whose
// row differs are computed again, each with its row.
//
// Rounding: region rows divide by the region's diagonal, interior rows
// multiply by the reciprocal of the interior diagonal, as the TPU kernel
// does.  Sums run in the order of the offsets list; nvcc may contract
// a*b+c into one fused multiply-add, which the plain PyTorch version does
// not, so the two agree to a few ulp (the stated tolerance is
// 2e-6 * max|ref|), not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAXK = 27;
constexpr int MAX_DEPTH = 6;            // the caller splits deeper visits
constexpr int PX = 64;                  // tile columns, halo included
constexpr int C4 = PX / 4;              // 16-byte words a row
constexpr int CPX = PX / 2 + 2;         // coarse tile columns
constexpr int SMEM_LIMIT = 232448;      // bytes a block may opt in to on sm_90
constexpr int X0 = 5;    // slots of the x ring with ec (4 without, 1 for a zero start)
constexpr int NR = 4;    // slots of a level's ring (a power of two)

enum Mode { MODE_JACOBI = 0, MODE_RB = 1, MODE_RESIDUAL = 2 };

struct Plan {
    int K;
    int di;                 // index of the (0,0,0) offset
    int oz[MAXK], oy[MAXK], ox[MAXK];
    int rowmap[8];          // mask of zero coordinates -> table row, -1 = interior
    int n_stages;
    int kind[MAX_DEPTH];
    float par[MAX_DEPTH];   // omega of a Jacobi stage, colour of a red/black one
    int emit;               // 0 none, 1 residual, 2 restricted residual
    int D;                  // halo depth on z and y
    int H;                  // halo columns on x: D rounded up to a multiple of 4
    int PY;                 // tile rows, TYO + 2D (TYO: the kernel's TY)
    int TXO;                // tile columns owned, PX - 2H
    int CPY;                // coarse tile rows
    int ZC;                 // planes a block owns (either shape)
    int nring;              // four-slot rings of the levels 1 .. nring
    int has_x, has_ec;
    int x0;                 // slots of the x ring
    int d0;                 // 1: level 1 reads the plane that arrived this step
                            // (no ec to add to it), 0: the one before
    int vec;                // 8-byte global access: nx even, aligned pointers
    int vec4;               // 16-byte global access: nx % 4 == 0, aligned pointers
    float rw[3], pw[3];     // transfer weights of taps -1, 0, +1
    // the halo form: received slabs (null without), their planes, and the
    // valid planes [zmin, zmax) of the fine grids, [czmin, czmax) of ec
    const float *b_lo, *b_hi, *x_lo, *x_hi, *ec_lo, *ec_hi;
    int hlo, hhi, clo, chi;
    int zmin, zmax, czmin, czmax;
    int halo;
    int nb;                 // members of a batch (1: one grid)
    int group, rounds;      // resident shape: members a round, rounds (nb = group * rounds)
};

// Plane z of a grid of (n, plane) floats: its own, or of the received slab
// below (`below` planes: plane z < 0 is its plane below + z) or above.
__device__ __forceinline__ const float* plane_ptr(
    const float* g, const float* lo, const float* hi, int below, int z, int n,
    size_t plane)
{
    if (z < 0) return lo + (size_t)(below + z) * plane;
    if (z >= n) return hi + (size_t)(z - n) * plane;
    return g + (size_t)z * plane;
}

// Member mb's received slab of a batch: `planes` planes of `plane` floats a
// member (null stays null).
__device__ __forceinline__ const float* member_slab(
    const float* p, int mb, int planes, size_t plane)
{
    return p == nullptr ? nullptr : p + (size_t)mb * planes * plane;
}

// Where member mb's grids of a batch start: fine grids nz*ny*nx floats
// apart, coarse ones (ec, a restricted residual) an eighth of that.
#define OMG_MEMBER_GRIDS(mb)                                                  \
    do {                                                                      \
        const size_t mf_ = (size_t)(mb) * nz * ny * nx;                       \
        const size_t mc_ = (size_t)(mb) * (nz >> 1) * (ny >> 1) * (nx >> 1);  \
        b += mf_;                                                             \
        if (xin != nullptr) xin += mf_;                                       \
        if (ec != nullptr) ec += mc_;                                         \
        if (x_out != nullptr) x_out += mf_;                                   \
        if (r_out != nullptr) r_out += pl.emit == 2 ? mc_ : mf_;              \
    } while (0)

// Floats of dynamic shared memory a launch takes: the rings and the coarse
// ec planes.
__host__ __device__ inline size_t smem_floats(const Plan& pl)
{
    const size_t planes = pl.x0 + NR * (size_t)pl.nring + (pl.emit == 2 ? NR : 0);
    return planes * pl.PY * PX + (pl.has_ec ? 3 * (size_t)pl.CPY * CPX : 0);
}

// Compile-time offsets of the Poisson hierarchy's operators, in the order
// the port builds them: SH 7 is poisson_offsets(3) (centre, then -/+ per
// axis); SH 27 the cornered Galerkin levels (centre, then the others in
// lexicographic order of (z, y, x)).  a = 0 z, 1 y, 2 x.
__host__ __device__ constexpr int star_off(int k, int a)
{
    return k == 0 ? 0 : ((k - 1) / 2 == a ? ((k - 1) % 2 == 0 ? -1 : 1) : 0);
}

__host__ __device__ constexpr int box_lex(int k)
{
    return k == 0 ? 13 : (k <= 13 ? k - 1 : k);
}

__host__ __device__ constexpr int box_off(int k, int a)
{
    return (a == 0 ? box_lex(k) / 9 : a == 1 ? (box_lex(k) / 3) % 3 : box_lex(k) % 3) - 1;
}

template <int SH>
__host__ __device__ constexpr int off(int k, int a)
{
    return SH == 7 ? star_off(k, a) : box_off(k, a);
}

// Does a tap of the operator read row (oz, oy) of the stencil?  One with
// ox != 0?
template <int SH>
__host__ __device__ constexpr bool row_used(int oz, int oy, bool shifted)
{
    bool used = false;
    for (int k = 0; k < SH; ++k)
        used = used || (off<SH>(k, 0) == oz && off<SH>(k, 1) == oy &&
                        (!shifted || off<SH>(k, 2) != 0));
    return used;
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? 8 : 0;    // 0: fill with zeros, read nothing
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

// 16 bytes past L1 (.cg), zero-filled where ok is false
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows (oz, oy) = (A / 3 - 1, A % 3 - 1) of the stencil for the word at
// cell i, from A up: a 16-byte load of each row a tap reads, and the cells
// left and right of the word (from the lanes beside) where a tap needs them.
// Recursion on template arguments keeps every index a constant.
template <int SH, int A>
__device__ __forceinline__ void load_rows(
    float (&R)[3][3][6], const float* pm, const float* p0, const float* pp, int i)
{
    if constexpr (A < 9) {
        constexpr int a = A / 3, e = A % 3;
        if constexpr (row_used<SH>(a - 1, e - 1, false)) {
            const float* P = a == 0 ? pm : (a == 2 ? pp : p0);
            const float4 w4 = *reinterpret_cast<const float4*>(P + i + (e - 1) * PX);
            R[a][e][1] = w4.x;
            R[a][e][2] = w4.y;
            R[a][e][3] = w4.z;
            R[a][e][4] = w4.w;
            if constexpr (row_used<SH>(a - 1, e - 1, true)) {
                R[a][e][0] = __shfl_up_sync(0xffffffffu, w4.w, 1);
                R[a][e][5] = __shfl_down_sync(0xffffffffu, w4.x, 1);
            }
        }
        load_rows<SH, A + 1>(R, pm, p0, pp, i);
    }
}

// acc[j] += tap k * (neighbour of cell j) for the taps from K on, in the
// order of the offsets; a red/black stage skips the diagonal (k = 0).
template <int SH, bool SKIP_DIAG, int K>
__device__ __forceinline__ void sum_taps(
    float (&acc)[4], const float (&R)[3][3][6], const float* treg)
{
    if constexpr (K < SH) {
        if constexpr (!(SKIP_DIAG && K == 0)) {
            constexpr int a = off<SH>(K, 0) + 1, e = off<SH>(K, 1) + 1;
            constexpr int ox = off<SH>(K, 2);
            const float tk = treg[K];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] += tk * R[a][e][j + 1 + ox];
        }
        sum_taps<SH, SKIP_DIAG, K + 1>(acc, R, treg);
    }
}

// acc += tp[k] * (neighbour of cell J) for the taps from K on: one cell's
// sum with its own row of the table (a cell on a low face).
template <int SH, bool SKIP_DIAG, int J, int K>
__device__ __forceinline__ void sum_taps_cell(
    float& acc, const float (&R)[3][3][6], const float* tp)
{
    if constexpr (K < SH) {
        if constexpr (!(SKIP_DIAG && K == 0)) {
            constexpr int a = off<SH>(K, 0) + 1, e = off<SH>(K, 1) + 1;
            acc += tp[K] * R[a][e][J + 1 + off<SH>(K, 2)];
        }
        sum_taps_cell<SH, SKIP_DIAG, J, K + 1>(acc, R, tp);
    }
}

// Cell J of the word again, with the tap row of its zero-coordinate mask
// and its own diagonal, where bit J of fix is set.
template <int MODE, int SH, int J>
__device__ __forceinline__ void fix_cell(
    float (&v)[4], const float (&R)[3][3][6], const float* taps, unsigned fix,
    int mzy, int gx, const float* bv, const float* xc, float omega)
{
    if (!((fix >> J) & 1u)) return;
    const float* tp = taps + (mzy | (gx + J == 0 ? 4 : 0)) * MAXK;
    float acc = 0.0f;
    sum_taps_cell<SH, MODE == MODE_RB, J, 0>(acc, R, tp);
    const float res = bv[J] - acc;
    v[J] = MODE == MODE_RESIDUAL ? res
         : MODE == MODE_JACOBI ? xc[J] + (omega * res) / tp[0]
                               : res / tp[0];
}

struct Tile {
    int gz;         // plane of the level's output
    int gy0, gx0;   // global index of tile cell (0, 0)
    int z0, z1;     // planes the block owns
    int nz, ny, nx;
    int zmin, zmax; // the valid planes (a halo form's reach past the slab)
};

// A thread's word of the tile (the same at every level and step): four
// cells of tile row r from column c.
struct Word {
    int r, c;
    int i;              // index in a plane; rows clamped into the tile
    int gy, gx;
    bool iny;           // its row lies in the domain
    unsigned xin;       // bit j: cell j's column lies in the domain
    unsigned fix1, fix0;  // bit j: cell j is in the domain and its tap row is
                          // not the interior one, off / on the plane z == 0
    unsigned own2;      // bit h: cells 2h, 2h + 1 are in the domain and owned
                        // by the block (written to the global output)
    size_t g;           // gy * nx + gx
};

// The level's value at one cell i (natural layout r * SX + c) with zero-
// coordinate mask m, offsets read from the plan at run time: the generic
// operator's body.
template <int MODE, int SX>
__device__ __forceinline__ float cell_value(
    const Plan& pl, const float* pm, const float* p0, const float* pp,
    const float* taps, unsigned imask, int i, int m, float bval, float inv_d,
    float omega)
{
    const float* tp = taps + m * MAXK;
    float acc = 0.0f;
    for (int k = 0; k < pl.K; ++k) {
        if (MODE == MODE_RB && k == pl.di) continue;
        const float* P = pl.oz[k] < 0 ? pm : (pl.oz[k] > 0 ? pp : p0);
        acc += tp[k] * P[i + pl.oy[k] * SX + pl.ox[k]];
    }
    const float res = bval - acc;
    if (MODE == MODE_RESIDUAL) return res;
    if ((imask >> m) & 1u)
        return MODE == MODE_JACOBI ? p0[i] + omega * (inv_d * res) : inv_d * res;
    const float dg = tp[pl.di];
    return MODE == MODE_JACOBI ? p0[i] + (omega * res) / dg : res / dg;
}

// One level on one plane: the rows [lo, PY - lo) of plane t.gz, from the
// input planes pm / p0 / pp into dst (a ring slot, or null) and, for the
// owned cells, into gout (a global array, or null).  Cells outside the
// domain get zero, and so does a plane outside it.  Every thread of the
// block calls it (the shuffles need whole warps).
template <int MODE, int SH>
__device__ __forceinline__ void level_pass(
    const Plan& pl, const Tile& t, const Word& w, const float* pm,
    const float* p0, const float* pp, const float4 bw, float* dst,
    float* __restrict__ gout, const float* taps, const float* treg,
    unsigned imask, int lo, float inv_d, float par)
{
    const bool act = w.r >= lo && w.r < pl.PY - lo;
    const int i = w.i, gz = t.gz;
    if (gz < t.zmin || gz >= t.zmax) {   // the same for the whole block
        if (act && dst != nullptr)
            *reinterpret_cast<float4*>(dst + i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        return;
    }
    // b at the four cells (zero outside the domain)
    const float bv[4] = {bw.x, bw.y, bw.z, bw.w};
    const float4 c4 = *reinterpret_cast<const float4*>(p0 + i);
    const float xc[4] = {c4.x, c4.y, c4.z, c4.w};
    float v[4];
    if constexpr (SH > 0) {
        // the rows of the stencil: one 16-byte load each; the x-neighbours
        // of a word's first and last cell from the lanes beside (garbage at
        // the row's two ends, which no level reads as exact)
        float R[3][3][6];
        load_rows<SH, 0>(R, pm, p0, pp, i);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        sum_taps<SH, MODE == MODE_RB, 0>(acc, R, treg);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float res = bv[j] - acc[j];
            v[j] = MODE == MODE_RESIDUAL ? res
                 : MODE == MODE_JACOBI ? xc[j] + par * (inv_d * res)
                                       : inv_d * res;
        }
        // the cells on a low face whose tap row is not the interior one
        const unsigned fix = act ? (gz == 0 ? w.fix0 : w.fix1) : 0u;
        if (fix != 0u) {
            const int mzy = (gz == 0 ? 1 : 0) | (w.gy == 0 ? 2 : 0);
            fix_cell<MODE, SH, 0>(v, R, taps, fix, mzy, w.gx, bv, xc, par);
            fix_cell<MODE, SH, 1>(v, R, taps, fix, mzy, w.gx, bv, xc, par);
            fix_cell<MODE, SH, 2>(v, R, taps, fix, mzy, w.gx, bv, xc, par);
            fix_cell<MODE, SH, 3>(v, R, taps, fix, mzy, w.gx, bv, xc, par);
        }
    } else {
        const int mzy = (gz == 0 ? 1 : 0) | (w.gy == 0 ? 2 : 0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = act && w.iny && ((w.xin >> j) & 1u)
                ? cell_value<MODE, PX>(pl, pm, p0, pp, taps, imask, i + j,
                                       mzy | (w.gx + j == 0 ? 4 : 0), bv[j], inv_d, par)
                : 0.0f;
    }
    if (MODE == MODE_RB) {
        // cell j takes the new value where (gz + gy + gx + j) has the colour
        const int t1 = ((int)par + gz + w.gy + w.gx) & 1;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if ((j & 1) != t1) v[j] = xc[j];
    }
    if (!(w.iny && w.xin == 15u)) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (!(w.iny && ((w.xin >> j) & 1u))) v[j] = 0.0f;
    }
    if (act && dst != nullptr)
        *reinterpret_cast<float4*>(dst + i) = make_float4(v[0], v[1], v[2], v[3]);
    if (gout != nullptr && w.own2 != 0u && gz >= t.z0 && gz < t.z1) {
        const size_t g = (size_t)gz * t.ny * t.nx + w.g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            if (!((w.own2 >> h) & 1u)) continue;
            if (pl.vec) {
                *reinterpret_cast<float2*>(gout + g + 2 * h) =
                    make_float2(v[2 * h], v[2 * h + 1]);
            } else {
                if ((w.xin >> (2 * h)) & 1u) gout[g + 2 * h] = v[2 * h];
                if ((w.xin >> (2 * h + 1)) & 1u) gout[g + 2 * h + 1] = v[2 * h + 1];
            }
        }
    }
}

// x + (P ec) on the thread's word (fine cells gx .. gx + 3 of row gy of
// plane gz, gx even), from the coarse ring: weight pw[tap + 1] couples fine
// f = 2c + tap with coarse c.  Each of the three coarse columns the word
// needs is summed over z, then y, once, and the four cells combine them
// over x: the order of the plain version (axis 0 first), and the same
// operations as summing each cell alone.  Coarse cells outside the domain
// hold zero.  out (or null) gets the owned pairs of cells (bit h of own2).
__device__ __forceinline__ void prolong_word(
    const Plan& pl, float* px, const float* cring, int czlo, int cy0, int cx0,
    int gz, int gy, int gx, unsigned xin, float* __restrict__ out, unsigned own2)
{
    int cz[2], cy[2];
    float wz[2], wy[2];
    int nzt, nyt;
#define OMG_AXIS_TAPS(f, c, wt, n)                                      \
    if ((f & 1) == 0) { c[0] = f >> 1; wt[0] = pl.pw[1]; n = 1; }         \
    else {                                                              \
        c[0] = (f + 1) >> 1; wt[0] = pl.pw[0];                          \
        c[1] = (f - 1) >> 1; wt[1] = pl.pw[2]; n = 2;                    \
    }
    OMG_AXIS_TAPS(gz, cz, wz, nzt)
    OMG_AXIS_TAPS(gy, cy, wy, nyt)
#undef OMG_AXIS_TAPS
    const int cpl = pl.CPY * CPX;
    const int cxb = (gx >> 1) - cx0;   // coarse columns cxb, cxb + 1, cxb + 2
    float col[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float sy = 0.0f;
        for (int b = 0; b < nyt; ++b) {
            float sz = 0.0f;
            for (int c = 0; c < nzt; ++c) {
                const float* P = cring + ((cz[c] - czlo) % 3) * cpl;
                sz += wz[c] * P[(cy[b] - cy0) * CPX + cxb + k];
            }
            sy += wy[b] * sz;
        }
        col[k] = sy;
    }
    // even cell 2k: one x tap (coarse column k); odd cell 2k + 1: the taps
    // -1 (column k + 1) and +1 (column k), in that order
    float p[4];
    p[0] = 0.0f + pl.pw[1] * col[0];
    p[1] = (0.0f + pl.pw[0] * col[1]) + pl.pw[2] * col[0];
    p[2] = 0.0f + pl.pw[1] * col[1];
    p[3] = (0.0f + pl.pw[0] * col[2]) + pl.pw[2] * col[1];
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[j] = (pl.has_x ? px[j] : 0.0f) + p[j];
        if ((xin >> j) & 1u) px[j] = v[j];
    }
    if (out != nullptr)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (((own2 >> (j >> 1)) & 1u) && ((xin >> j) & 1u)) out[j] = v[j];
}

template <int SH, int TY>
__global__ void __launch_bounds__(C4 * (TY + 2 * MAX_DEPTH), 1) visit_kernel(
    Plan pl, const float* __restrict__ values, const float* __restrict__ table,
    const float* __restrict__ b, const float* __restrict__ xin,
    const float* __restrict__ ec, float* __restrict__ x_out,
    float* __restrict__ r_out, int nz, int ny, int nx)
{
    extern __shared__ __align__(16) float smem[];
    __shared__ float taps[8 * MAXK];
    __shared__ int kinds[MAX_DEPTH];
    __shared__ float pars[MAX_DEPTH];

    constexpr int THREADS = C4 * (TY + 2 * MAX_DEPTH);   // a thread a word
    constexpr int TYO = TY;
    const int tid = threadIdx.x;
    const int S = pl.n_stages, D = pl.D, H = pl.H, PY = pl.PY;
    const int e1 = pl.emit >= 1, e2 = pl.emit == 2;
    const int PL = PY * PX;

    const int X = pl.x0;
    float* ring0 = smem;                        // X slots: x (+ P ec)
    float* rings = ring0 + X * PL;              // levels 1 .. nring, NR slots each
    float* rring = rings + NR * pl.nring * PL;  // the residual, NR slots (emit 2)
    float* cring = rring + (e2 ? NR * PL : 0);  // ec, 3 coarse planes

    Tile tl;
    tl.nz = nz; tl.ny = ny; tl.nx = nx;
    tl.zmin = pl.zmin; tl.zmax = pl.zmax;
    const int fy0 = blockIdx.y * TYO, fx0 = blockIdx.x * pl.TXO;
    tl.gy0 = fy0 - D;
    tl.gx0 = fx0 - H;
    // the member (batched form) and its z-chunk
    const int nzc = (nz + pl.ZC - 1) / pl.ZC;
    const int mb = blockIdx.z / nzc;
    OMG_MEMBER_GRIDS(mb);
    // the member's received slabs (K1hb): hlo / hhi fine planes and clo /
    // chi coarse planes a member
    const size_t fpl = (size_t)ny * nx, cpl = (size_t)(ny >> 1) * (nx >> 1);
    const float* b_lo = member_slab(pl.b_lo, mb, pl.hlo, fpl);
    const float* b_hi = member_slab(pl.b_hi, mb, pl.hhi, fpl);
    const float* x_lo = member_slab(pl.x_lo, mb, pl.hlo, fpl);
    const float* x_hi = member_slab(pl.x_hi, mb, pl.hhi, fpl);
    const float* ec_lo = member_slab(pl.ec_lo, mb, pl.clo, cpl);
    const float* ec_hi = member_slab(pl.ec_hi, mb, pl.chi, cpl);
    tl.z0 = (blockIdx.z - mb * nzc) * pl.ZC;
    tl.z1 = min(tl.z0 + pl.ZC, nz);
    const int zlo = tl.z0 - D;
    const int T0 = (tl.z1 - tl.z0) + 2 * D;    // planes loaded
    const int top = S + e1;                    // the deepest level
    const int d0 = pl.d0;
    const int T = T0 + top + e2 - d0;          // steps: the pipeline drains
    const int czlo = zlo >> 1, cy0 = tl.gy0 >> 1, cx0 = tl.gx0 >> 1;
    const int ncz = nz >> 1, ncy = ny >> 1, ncx = nx >> 1;

    // every slot starts at zero
    const int total = (int)smem_floats(pl);
    for (int i = tid; i < total; i += THREADS) smem[i] = 0.0f;
    for (int i = tid; i < 8 * pl.K; i += THREADS) {
        const int m = i / pl.K, k = i - m * pl.K;
        const int row = pl.rowmap[m];
        taps[m * MAXK + k] = row < 0 ? values[k] : table[row * pl.K + k];
    }
    if (tid < S) {
        kinds[tid] = pl.kind[tid];
        pars[tid] = pl.par[tid];
    }
    unsigned imask = 0;
    for (int m = 0; m < 8; ++m) imask |= (pl.rowmap[m] < 0 ? 1u : 0u) << m;
    Word wd;
    wd.r = tid / C4;
    wd.c = 4 * (tid % C4);
    wd.i = min(max(wd.r, 1), PY - 2) * PX + wd.c;   // an idle row reads in range
    wd.gy = tl.gy0 + wd.r;
    wd.gx = tl.gx0 + wd.c;
    wd.iny = wd.r < PY && wd.gy >= 0 && wd.gy < ny;
    wd.xin = wd.fix0 = wd.fix1 = 0;
    for (int j = 0; j < 4; ++j) {
        const int x = wd.gx + j;
        if (x < 0 || x >= nx) continue;
        wd.xin |= 1u << j;
        const int m = (wd.gy == 0 ? 2 : 0) | (x == 0 ? 4 : 0);
        if (wd.iny && m != 0 && !((imask >> m) & 1u)) wd.fix1 |= 1u << j;
        if (wd.iny && !((imask >> (m | 1)) & 1u)) wd.fix0 |= 1u << j;
    }
    wd.own2 = 0;
    for (int h = 0; h < 2; ++h)
        if (wd.iny && wd.r >= D && wd.r < D + TYO && wd.c + 2 * h >= H &&
            wd.c + 2 * h < H + pl.TXO && ((wd.xin >> (2 * h)) & 3u))
            wd.own2 |= 1u << h;
    wd.g = (size_t)(wd.iny ? wd.gy : 0) * nx + wd.gx;
    const int wr0 = wd.r & ~1;   // the first of the warp's two rows
    __syncthreads();

    // plane s of the pipeline (global z = zlo + s) into its slot, and the
    // coarse ec plane it is the first to need
    const size_t fplane = (size_t)ny * nx;
    auto load_plane = [&](int s) {
        const int gz = zlo + s;
        const bool inz = gz >= pl.zmin && gz < pl.zmax;
        float* dx = ring0 + (s % X) * PL;   // once a step: not in a level
        // the plane's x: the slab's own, or a received one
        const float* xp = pl.has_x && inz
            ? plane_ptr(xin, x_lo, x_hi, pl.hlo, gz, nz, fplane) : xin;
        if (pl.has_x || (pl.has_ec && !inz)) {
            for (int w4 = tid; w4 < PY * C4; w4 += THREADS) {
                const int r = w4 / C4, c = 4 * (w4 % C4);
                const int gy = tl.gy0 + r, gx = tl.gx0 + c;
                const bool iny = pl.has_x && inz && gy >= 0 && gy < ny;
                const size_t g = iny ? (size_t)gy * nx : 0;
                float* d = dx + r * PX + c;
                if (pl.has_x && pl.vec) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const bool ok = iny && gx + 2 * h >= 0 && gx + 2 * h < nx;
                        cp_async8(d + 2 * h, ok ? xp + g + gx + 2 * h : xin, ok);
                    }
                } else if (pl.has_x) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const bool ok = iny && gx + j >= 0 && gx + j < nx;
                        cp_async4(d + j, ok ? xp + g + gx + j : xin, ok);
                    }
                } else {
                    *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                }
            }
        }
        if (pl.has_ec) {
            // fine plane gz needs coarse planes gz >> 1 and (gz + 1) >> 1
            const int c_first = s == 0 ? gz >> 1 : (gz + 1) >> 1;
            const bool fresh = s == 0 || (gz & 1);
            for (int c = c_first; fresh && c <= (gz + 1) >> 1; ++c) {
                float* dc = cring + ((c - czlo) % 3) * (pl.CPY * CPX);
                const bool incz = c >= pl.czmin && c < pl.czmax;
                const float* ep = incz ? plane_ptr(ec, ec_lo, ec_hi, pl.clo, c, ncz,
                                                   (size_t)ncy * ncx)
                                       : ec;
                for (int i = tid; i < pl.CPY * CPX; i += THREADS) {
                    const int ry = i / CPX, rx = i - ry * CPX;
                    const int cy = cy0 + ry, cx = cx0 + rx;
                    const bool ok = incz && cy >= 0 && cy < ncy && cx >= 0 && cx < ncx;
                    const size_t g = ok ? (size_t)cy * ncx + cx : 0;
                    cp_async4(dc + i, ok ? ep + g : ec, ok);
                }
            }
        }
        cp_async_commit();
    };

    load_plane(0);

    const float inv_d = 1.0f / taps[SH > 0 ? 0 : pl.di];
    constexpr int KN = SH > 0 ? SH : 1;
    float treg[KN];
#pragma unroll
    for (int k = 0; k < KN; ++k) treg[k] = taps[k];

    // The word of b level L reads at step s: the thread's cells of plane
    // s - 2L (zero outside the domain; rows the level does not compute read
    // in range, unused).
    auto load_b = [&](int s, int L) {
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const int pr = s - 2 * L + d0, gz = zlo + pr;
        if (pr < L || pr > T0 - 1 - L || gz < pl.zmin || gz >= pl.zmax || !wd.iny)
            return v;
        const float* p = plane_ptr(b, b_lo, b_hi, pl.hlo, gz, nz, fplane) + wd.g;
        if (pl.vec) {
            if (wd.xin & 1u) {
                const float2 lo = __ldg(reinterpret_cast<const float2*>(p));
                v.x = lo.x;
                v.y = lo.y;
            }
            if (wd.xin & 4u) {
                const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 2));
                v.z = hi.x;
                v.w = hi.y;
            }
            return v;
        }
        if (wd.xin & 1u) v.x = __ldg(p);
        if (wd.xin & 2u) v.y = __ldg(p + 1);
        if (wd.xin & 4u) v.z = __ldg(p + 2);
        if (wd.xin & 8u) v.w = __ldg(p + 3);
        return v;
    };

    // One barrier a step: level L computes plane s - 2L from planes that
    // level L - 1 wrote at steps s - 3 .. s - 1.
    int xs = 0;   // slot of plane s in the x ring: s % X
    for (int s = 0; s < T; ++s, xs = xs + 1 == X ? 0 : xs + 1) {
        cp_async_wait_all();
        __syncthreads();
        if (s + 1 < T0) load_plane(s + 1);

        // level 0: x + P ec on the plane that has just arrived
        if (pl.has_ec && s < T0) {
            const int gz = zlo + s;
            float* px = ring0 + xs * PL;
            const bool write = S == 0 && gz >= tl.z0 && gz < tl.z1;
            if (gz >= pl.zmin && gz < pl.zmax && wd.iny && wd.xin != 0u)
                prolong_word(pl, px + wd.r * PX + wd.c, cring, czlo, cy0, cx0, gz,
                             wd.gy, wd.gx, wd.xin,
                             write && wd.own2 ? x_out + (size_t)gz * ny * nx + wd.g
                                              : nullptr,
                             wd.own2);
        }

        for (int L = 1; L <= top; ++L) {
            // exact on pipeline planes [L, T0 - 1 - L]
            const int pr = s - 2 * L + d0;
            if (pr < L) break;
            if (pr > T0 - 1 - L) continue;
            // and on rows [L, PY - L): a warp (two rows) with neither
            // skips the level
            if (wr0 + 1 < L || wr0 >= PY - L) continue;
            const float4 bw = load_b(s, L);
            const float *pm, *p0, *pp;
            if (L == 1) {
                // planes s - 3 + d0 .. s - 1 + d0, in the slots of the same
                // offsets from xs modulo X
                int a = xs - 3 + d0;
                while (a < 0) a += X;
                const int a1 = a + 1 == X ? 0 : a + 1;
                const int a2 = a1 + 1 == X ? 0 : a1 + 1;
                pm = ring0 + a * PL;
                p0 = ring0 + a1 * PL;
                pp = ring0 + a2 * PL;
            } else {
                const float* base = rings + NR * (L - 2) * PL;
                pm = base + ((s - 3) & (NR - 1)) * PL;
                p0 = base + ((s - 2) & (NR - 1)) * PL;
                pp = base + ((s - 1) & (NR - 1)) * PL;
            }
            tl.gz = zlo + pr;
            if (L <= S) {
                float* dst = L <= pl.nring ? rings + (NR * (L - 1) + (s & (NR - 1))) * PL : nullptr;
                float* gout = L == S ? x_out : nullptr;
                if (kinds[L - 1] == MODE_RB)
                    level_pass<MODE_RB, SH>(pl, tl, wd, pm, p0, pp, bw, dst, gout, taps,
                                            treg, imask, L, inv_d, pars[L - 1]);
                else
                    level_pass<MODE_JACOBI, SH>(pl, tl, wd, pm, p0, pp, bw, dst, gout,
                                                taps, treg, imask, L, inv_d,
                                                pars[L - 1]);
            } else {
                // the residual: into the ring for the restriction, or into
                // r_out on the owned cells
                level_pass<MODE_RESIDUAL, SH>(
                    pl, tl, wd, pm, p0, pp, bw,
                    e2 ? rring + (s & (NR - 1)) * PL : nullptr,
                    e2 ? nullptr : r_out, taps, treg, imask, L, inv_d, 0.0f);
            }
        }

        // the restriction: coarse plane c once fine residual plane 2c + 1
        // was written (step s - 1), from the residual ring's planes 2c - 1,
        // 2c, 2c + 1 (steps s - 3 .. s - 1)
        if (e2) {
            const int sw = s - 1;   // the step that wrote the newest plane
            const int pr = sw - 2 * (S + 1) + d0;
            const int gz = zlo + pr;
            const int cz = (gz - 1) >> 1;
            if (pr >= S + 1 && (gz & 1) && gz >= tl.z0 && gz < tl.z1 && cz < ncz) {
                const float* P[3] = {rring + ((sw - 2) & (NR - 1)) * PL,
                                     rring + ((sw - 1) & (NR - 1)) * PL,
                                     rring + (sw & (NR - 1)) * PL};
                const int CW = pl.TXO / 2;
                for (int i = tid; i < (TYO / 2) * CW; i += THREADS) {
                    const int ly = i / CW, lx = i - ly * CW;
                    const int cy = (fy0 >> 1) + ly, cx = (fx0 >> 1) + lx;
                    if (cy >= ncy || cx >= ncx) continue;
                    const int r0 = 2 * ly + D, c0 = 2 * lx + H;
                    float ax = 0.0f;
#pragma unroll
                    for (int tx = 0; tx < 3; ++tx) {
                        float ay = 0.0f;
#pragma unroll
                        for (int ty = 0; ty < 3; ++ty) {
                            const int cell = (r0 + ty - 1) * PX + c0 + tx - 1;
                            float az = 0.0f;
#pragma unroll
                            for (int tz = 0; tz < 3; ++tz)
                                az += pl.rw[tz] * P[tz][cell];
                            ay += pl.rw[ty] * az;
                        }
                        ax += pl.rw[tx] * ay;
                    }
                    r_out[((size_t)cz * ncy + cy) * ncx + cx] = ax;
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// The resident visit (see the head of the file).
// ---------------------------------------------------------------------------

constexpr int RT = 256;              // threads of a block: 16 rows of 16 words
constexpr int RW = 16;               // words of a row: 64 columns
constexpr int RY = RT / RW;          // rows of a tile
constexpr int RZC = 8;               // planes of a tile, at most
// The tile in shared memory: planes z0 - 2 .. z0 + tz, rows y0 - 2 ..
// y0 + 16, columns x0 - 2 .. x0 + 64 (cell (gz, gy, gx) at
// S[((gz - z0 + 2) * RSY + gy - y0 + 2) * RSX + gx - x0 + 4]).  A stage
// reads the one-cell halo; the second cell below the tile on each axis is
// loaded for the restriction's residual only.
constexpr int RSX = 72;
constexpr int RSY = RY + 3;
constexpr int RRY = RY + 1;          // rows of the restriction's fine residual

// The coarse region of ec a tile's prolongation reads: planes, rows and
// columns (fine planes z0 - 1 .. z0 + tz need coarse (z0 - 1) >> 1 ..
// (z0 + tz + 1) >> 1, and so on).
constexpr int ECY = RY / 2 + 2, ECX = 64 / 2 + 2;
__host__ __device__ inline int ec_planes(int tz) { return tz / 2 + 3; }

// Floats of dynamic shared memory a resident launch of tz planes takes: the
// tile; b and then the new cells (or, for a restriction, the fine residual
// on the tile and one cell below it on each axis); the coarse ec region.
__host__ __device__ inline size_t resident_floats(int tz, int emit, bool has_ec)
{
    const size_t cells = (size_t)tz * RY * 64;
    const size_t resid = emit == 2 ? (size_t)(tz + 1) * RRY * RSX : 0;
    return (size_t)(tz + 3) * RSY * RSX + (cells > resid ? cells : resid) +
           (has_ec ? (size_t)ec_planes(tz) * ECY * ECX : 0);
}

// Bits j of cells gx + j of row gy in the domain whose tap row is not the
// interior one: f1 off the plane z == 0, f0 on it.
__device__ __forceinline__ void word_fix(int gy, int gx, int ny, int nx,
                                         unsigned imask, unsigned& f0, unsigned& f1)
{
    f0 = f1 = 0;
    for (int j = 0; j < 4; ++j) {
        const int x = gx + j;
        if (x < 0 || x >= nx || gy < 0 || gy >= ny) continue;
        const int m = (gy == 0 ? 2 : 0) | (x == 0 ? 4 : 0);
        if (m != 0 && !((imask >> m) & 1u)) f1 |= 1u << j;
        if (!((imask >> (m | 1)) & 1u)) f0 |= 1u << j;
    }
}

// (P ec) on fine cells of row fy of plane fz from the coarse region E
// (coarse cell (cz, cy, cx) at E[((cz - c0.z) * ECY + cy - c0.y) * ECX +
// cx - c0.x], zero outside the domain): weight pw[t + 1] couples fine
// f = 2c + t with coarse c.  Each coarse column is summed over z, then y;
// the cells then combine them over x: the order of the plain version (axis
// 0 first).  n = 4: the word of cells fx .. fx + 3 (fx even); n = 1: cell
// fx alone.
template <int N>
__device__ __forceinline__ void prolong_cells(
    const Plan& pl, const float* E, int3 c0, int fz, int fy, int fx, float* p)
{
    int cz[2], cy[2];
    float wz[2], wy[2];
    int nzt, nyt;
#define OMG_AXIS_TAPS(f, c, wt, n)                                      \
    if ((f & 1) == 0) { c[0] = f >> 1; wt[0] = pl.pw[1]; n = 1; }         \
    else {                                                              \
        c[0] = (f + 1) >> 1; wt[0] = pl.pw[0];                          \
        c[1] = (f - 1) >> 1; wt[1] = pl.pw[2]; n = 2;                    \
    }
    OMG_AXIS_TAPS(fz, cz, wz, nzt)
    OMG_AXIS_TAPS(fy, cy, wy, nyt)
#undef OMG_AXIS_TAPS
    // coarse columns (fx >> 1) + k, k < 3 (N = 1: the one or two fx needs)
    const int cx = (fx >> 1) - c0.x;
    const int ncol = N == 4 ? 3 : 1 + (fx & 1);
    float col[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (k >= ncol) break;
        float sy = 0.0f;
        for (int b = 0; b < nyt; ++b) {
            float sz = 0.0f;
            for (int c = 0; c < nzt; ++c)
                sz += wz[c] * E[((cz[c] - c0.z) * ECY + cy[b] - c0.y) * ECX + cx + k];
            sy += wy[b] * sz;
        }
        col[k] = sy;
    }
    if (N == 1) {
        // fx even: column 0; odd: the taps -1 (column 1) and +1 (column 0)
        p[0] = (fx & 1) == 0 ? 0.0f + pl.pw[1] * col[0]
                             : (0.0f + pl.pw[0] * col[1]) + pl.pw[2] * col[0];
        return;
    }
    p[0] = 0.0f + pl.pw[1] * col[0];
    p[1] = (0.0f + pl.pw[0] * col[1]) + pl.pw[2] * col[0];
    p[2] = 0.0f + pl.pw[1] * col[1];
    p[3] = (0.0f + pl.pw[0] * col[2]) + pl.pw[2] * col[1];
}

// What a stage reads, into shared memory: the tile from src (null: zero)
// plus P ec where ec is given, into S, from plane and row z0 - 2 + lo,
// y0 - 2 + lo (lo = 1: the one-cell halo a stage reads; 0: the two cells
// below the tile that the restriction's residual reads too); and b on the
// tile's cells into T (where b is given; the thread's own words, which it
// then overwrites with its new values).  src may be written by other blocks
// during the launch, so it is read past L1.  The 16-byte words are copied
// with cp.async, all in flight together.
__device__ void stage_in(const Plan& pl, float* S, float* T, float* E,
                         const float* src, const float* ec, const float* b,
                         int tz, int z0, int y0, int x0, int nz, int ny, int nx,
                         int lo)
{
    const int tid = threadIdx.x;
    const int np = tz + 3 - lo, nr = RSY - lo;
    const int ncz = nz >> 1, ncy = ny >> 1, ncx = nx >> 1;
    const int3 c0 = make_int3((x0 - 1) >> 1, (y0 - 1) >> 1, (z0 - 1) >> 1);
    if (ec != nullptr) {
        // the coarse region (read-only input: any cache level)
        const int n = ec_planes(tz) * ECY * ECX;
        for (int i = tid; i < n; i += RT) {
            const int pz = i / (ECY * ECX), rem = i - pz * (ECY * ECX);
            const int ry = rem / ECX, rx = rem - ry * ECX;
            const int cz = c0.z + pz, cy = c0.y + ry, cx = c0.x + rx;
            const bool in = cz >= 0 && cz < ncz && cy >= 0 && cy < ncy && cx >= 0 && cx < ncx;
            cp_async4(E + i, in ? ec + ((size_t)cz * ncy + cy) * ncx + cx : ec, in);
        }
    }
    const bool async_x = pl.vec4 && src != nullptr;
    for (int i = tid; i < np * nr * RW; i += RT) {
        const int row = i / RW, w = i - row * RW;
        const int pz = lo + row / nr, ry = lo + row % nr;
        const int gz = z0 - 2 + pz, gy = y0 - 2 + ry, gx = x0 + 4 * w;
        const bool in = gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx < nx;
        const size_t g = in ? ((size_t)gz * ny + gy) * nx + gx : 0;
        float* d = S + (pz * RSY + ry) * RSX + 4 + 4 * w;
        if (async_x) {
            cp_async16(d, src + g, in);
            continue;
        }
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (in && src != nullptr)
            for (int j = 0; j < 4; ++j)
                if (gx + j < nx) v[j] = __ldcg(src + g + j);
        *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (b != nullptr) {
        // word i of plane p is thread i's (RT = RY * RW)
        for (int p = 0; p < tz; ++p) {
            const int r = tid / RW, w = tid % RW;
            const int gz = z0 + p, gy = y0 + r, gx = x0 + 4 * w;
            const bool in = gz < nz && gy < ny && gx < nx;
            const size_t g = in ? ((size_t)gz * ny + gy) * nx + gx : 0;
            float* d = T + (p * RY + r) * 64 + 4 * w;
            if (pl.vec4) {
                cp_async16(d, b + g, in);
            } else {
                float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                for (int j = 0; j < 4 && in; ++j)
                    if (gx + j < nx) v[j] = __ldg(b + g + j);
                *reinterpret_cast<float4*>(d) = make_float4(v[0], v[1], v[2], v[3]);
            }
        }
    }
    cp_async_commit();
    // the columns left and right of the tile (x0 - 1, x0 + 64, and x0 - 2
    // with lo = 0), while the copies are in flight
    const int ncol = 3 - lo;
    for (int i = tid; i < np * nr * ncol; i += RT) {
        const int row = i / ncol, k = i - row * ncol;
        const int pz = lo + row / nr, ry = lo + row % nr;
        const int gz = z0 - 2 + pz, gy = y0 - 2 + ry;
        const int col = k == 0 ? 3 : k == 1 ? 68 : 2;
        const int gx = x0 - 4 + col;
        float v = 0.0f;
        if (src != nullptr && gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx >= 0 && gx < nx)
            v = __ldcg(src + ((size_t)gz * ny + gy) * nx + gx);
        S[(pz * RSY + ry) * RSX + col] = v;
    }
    cp_async_wait_all();
    if (ec == nullptr) return;
    // x + P ec on the cells of the domain, from the coarse region
    __syncthreads();
    for (int i = tid; i < np * nr * (RW + 2); i += RT) {
        const int row = i / (RW + 2), w = i - row * (RW + 2);
        const int pz = lo + row / nr, ry = lo + row % nr;
        const int gz = z0 - 2 + pz, gy = y0 - 2 + ry;
        if (gz < 0 || gz >= nz || gy < 0 || gy >= ny) continue;
        float* d = S + (pz * RSY + ry) * RSX;
        if (w < RW) {
            const int gx = x0 + 4 * w;
            if (gx >= nx) continue;
            float p[4];
            prolong_cells<4>(pl, E, c0, gz, gy, gx, p);
            for (int j = 0; j < 4; ++j)
                if (gx + j < nx) d[4 + 4 * w + j] += p[j];
        } else {
            const int gx = w == RW ? x0 - 1 : x0 + 64;
            if (gx < 0 || gx >= nx) continue;
            float p[1];
            prolong_cells<1>(pl, E, c0, gz, gy, gx, p);
            d[w == RW ? 3 : 68] += p[0];
        }
    }
}

// Rows (oz, oy) = (A / 3 - 1, A % 3 - 1) of the stencil for the word whose
// first cell is at c in the tile: a 16-byte load of each row a tap reads,
// and the cells left and right of the word from the lanes beside, or from
// the halo columns for the first and last word of a row (16 lanes a row).
template <int SH, int A>
__device__ __forceinline__ void tile_rows(float (&R)[3][3][6], const float* c, int w)
{
    if constexpr (A < 9) {
        constexpr int a = A / 3, e = A % 3;
        if constexpr (row_used<SH>(a - 1, e - 1, false)) {
            const float* P = c + ((a - 1) * RSY + (e - 1)) * RSX;
            const float4 w4 = *reinterpret_cast<const float4*>(P);
            R[a][e][1] = w4.x;
            R[a][e][2] = w4.y;
            R[a][e][3] = w4.z;
            R[a][e][4] = w4.w;
            if constexpr (row_used<SH>(a - 1, e - 1, true)) {
                // the halo cells are read by the two lanes that need them
                // only (a load on every lane would be a 4-way bank conflict)
                float lft = __shfl_up_sync(0xffffffffu, w4.w, 1);
                float rgt = __shfl_down_sync(0xffffffffu, w4.x, 1);
                if (w == 0) lft = P[-1];
                if (w == RW - 1) rgt = P[4];
                R[a][e][0] = lft;
                R[a][e][5] = rgt;
            }
        }
        tile_rows<SH, A + 1>(R, c, w);
    }
}

// One stage kind (or the residual) on word w of row r of local plane p
// (from -1): the four new values of cells gx .. gx + 3 of row gy of plane
// gz.
template <int MODE, int SH>
__device__ __forceinline__ void tile_word(
    const Plan& pl, const float* S, int p, int r, int w, int gz, int gy,
    int gx, unsigned fix0, unsigned fix1, const float (&bv)[4],
    const float* taps, const float* treg, unsigned imask, float inv_d,
    float par, float (&v)[4])
{
    const float* c = S + ((p + 2) * RSY + (r + 2)) * RSX + 4 + 4 * w;
    const float4 c4 = *reinterpret_cast<const float4*>(c);
    const float xc[4] = {c4.x, c4.y, c4.z, c4.w};
    if constexpr (SH > 0) {
        float R[3][3][6];
        tile_rows<SH, 0>(R, c, w);
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        sum_taps<SH, MODE == MODE_RB, 0>(acc, R, treg);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float res = bv[j] - acc[j];
            v[j] = MODE == MODE_RESIDUAL ? res
                 : MODE == MODE_JACOBI ? xc[j] + par * (inv_d * res)
                                       : inv_d * res;
        }
        const unsigned fix = gz == 0 ? fix0 : fix1;
        if (fix != 0u) {
            const int mzy = (gz == 0 ? 1 : 0) | (gy == 0 ? 2 : 0);
            fix_cell<MODE, SH, 0>(v, R, taps, fix, mzy, gx, bv, xc, par);
            fix_cell<MODE, SH, 1>(v, R, taps, fix, mzy, gx, bv, xc, par);
            fix_cell<MODE, SH, 2>(v, R, taps, fix, mzy, gx, bv, xc, par);
            fix_cell<MODE, SH, 3>(v, R, taps, fix, mzy, gx, bv, xc, par);
        }
    } else {
        const int mzy = (gz == 0 ? 1 : 0) | (gy == 0 ? 2 : 0);
        const int i = (r + 2) * RSX + 4 + 4 * w;
        const float* p0 = S + (p + 2) * RSY * RSX;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = cell_value<MODE, RSX>(pl, p0 - RSY * RSX, p0, p0 + RSY * RSX,
                                         taps, imask, i + j,
                                         mzy | (gx + j == 0 ? 4 : 0), bv[j], inv_d, par);
    }
    if (MODE == MODE_RB) {
        // cell j takes the new value where (gz + gy + gx + j) has the colour
        const int t1 = ((int)par + gz + gy + gx) & 1;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if ((j & 1) != t1) v[j] = xc[j];
    }
}


template <int SH>
__global__ void __launch_bounds__(RT, 2) resident_visit_kernel(
    Plan pl, const float* __restrict__ values, const float* __restrict__ table,
    const float* __restrict__ b, const float* __restrict__ xin,
    const float* __restrict__ ec, float* __restrict__ x_out,
    float* __restrict__ r_out, int nz, int ny, int nx)
{
    extern __shared__ __align__(16) float smem[];
    __shared__ float taps[8 * MAXK];
    cg::grid_group grid = cg::this_grid();

    const int tid = threadIdx.x, tz = pl.ZC;
    const int w = tid % RW, r = tid / RW;
    const int nzc = (nz + tz - 1) / tz;
    const int mb = blockIdx.z / nzc;   // the block's member within a round's group
    const int z0 = (blockIdx.z - mb * nzc) * tz, y0 = blockIdx.y * RY, x0 = blockIdx.x * 64;
    const int gy = y0 + r, gx = x0 + 4 * w;
    const int S_ = pl.n_stages;
    float* S = smem;                              // the tile
    float* T = S + (tz + 3) * RSY * RSX;          // b, then the new cells
    float* E = T + resident_floats(tz, pl.emit, false) - (tz + 3) * RSY * RSX;

    for (int i = tid; i < 8 * pl.K; i += RT) {
        const int m = i / pl.K, k = i - m * pl.K;
        const int row = pl.rowmap[m];
        taps[m * MAXK + k] = row < 0 ? values[k] : table[row * pl.K + k];
    }
    unsigned imask = 0;
    for (int m = 0; m < 8; ++m) imask |= (pl.rowmap[m] < 0 ? 1u : 0u) << m;
    unsigned xin4 = 0, fix0, fix1;   // bit j: cell j lies in the domain
    for (int j = 0; j < 4; ++j)
        if (gx + j < nx && gy < ny) xin4 |= 1u << j;
    word_fix(gy, gx, ny, nx, imask, fix0, fix1);
    __syncthreads();
    const float inv_d = 1.0f / taps[SH > 0 ? 0 : pl.di];
    constexpr int KN = SH > 0 ? SH : 1;
    float treg[KN];
#pragma unroll
    for (int k = 0; k < KN; ++k) treg[k] = taps[k];

    // b at the thread's word of plane p (stage_in put it in T)
    auto b_of = [&](int p, float (&bv)[4]) {
        const float4 t = *reinterpret_cast<const float4*>(T + (p * RY + r) * 64 + 4 * w);
        bv[0] = t.x; bv[1] = t.y; bv[2] = t.z; bv[3] = t.w;
    };
    // the thread's words of T (tz planes) into dst, cells in the domain
    auto store_words = [&](float* dst) {
        for (int p = 0; p < tz; ++p) {
            const int gz = z0 + p;
            if (gz >= nz || xin4 == 0u) break;
            const float4 t = *reinterpret_cast<const float4*>(T + (p * RY + r) * 64 + 4 * w);
            float* q = dst + ((size_t)gz * ny + gy) * nx + gx;
            if (pl.vec4) {
                *reinterpret_cast<float4*>(q) = t;
            } else {
                const float v[4] = {t.x, t.y, t.z, t.w};
                for (int j = 0; j < 4; ++j)
                    if ((xin4 >> j) & 1u) q[j] = v[j];
            }
        }
    };

    // The batch in rounds: round r takes members r * group + mb, one visit
    // of every member of the round's group (one round where the whole
    // batch's tiles fit).  Every block passes the same grid-wide barriers in
    // a round, and the members of two rounds share no grid, so a round needs
    // no barrier of its own.
    const float* const b_in = b;
    const float* const x_in = xin;
    const float* const ec_in = ec;
    float* const xo_in = x_out;
    float* const ro_in = r_out;
    for (int round = 0; round < pl.rounds; ++round) {
        b = b_in;
        xin = x_in;
        ec = ec_in;
        x_out = xo_in;
        r_out = ro_in;
        OMG_MEMBER_GRIDS(round * pl.group + mb);
        if (round > 0) __syncthreads();   // the last round's tile buffers are read
        const float* cur = xin;   // the iterate as it stands
        for (int s = 0; s < S_; ++s) {
            stage_in(pl, S, T, E, cur, s == 0 ? ec : nullptr, b, tz, z0, y0, x0, nz, ny, nx, 1);
            __syncthreads();
            const bool rb = pl.kind[s] == MODE_RB;
            const float par = pl.par[s];
            for (int p = 0; p < tz; ++p) {
                const int gz = z0 + p;
                float bv[4], v[4];
                b_of(p, bv);
                if (rb)
                    tile_word<MODE_RB, SH>(pl, S, p, r, w, gz, gy, gx, fix0, fix1, bv,
                                           taps, treg, imask, inv_d, par, v);
                else
                    tile_word<MODE_JACOBI, SH>(pl, S, p, r, w, gz, gy, gx, fix0, fix1,
                                               bv, taps, treg, imask, inv_d, par, v);
                *reinterpret_cast<float4*>(T + (p * RY + r) * 64 + 4 * w) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
            // x_out is the iterate from the second stage on: every block must
            // have read it before any block writes
            if (s > 0) grid.sync();
            store_words(x_out);
            cur = x_out;
            if (s + 1 < S_ || pl.emit != 0) grid.sync();
        }
        if (S_ == 0 && pl.has_ec) {
            // the stage-free x + P ec
            stage_in(pl, S, T, E, cur, ec, nullptr, tz, z0, y0, x0, nz, ny, nx, 1);
            __syncthreads();
            for (int p = 0; p < tz; ++p) {
                const float4 t = *reinterpret_cast<const float4*>(
                    S + ((p + 2) * RSY + (r + 2)) * RSX + 4 + 4 * w);
                *reinterpret_cast<float4*>(T + (p * RY + r) * 64 + 4 * w) = t;
            }
            store_words(x_out);
            cur = x_out;
            if (pl.emit != 0) grid.sync();
        }
        if (pl.emit == 1) {
            stage_in(pl, S, T, E, cur, nullptr, b, tz, z0, y0, x0, nz, ny, nx, 1);
            __syncthreads();
            for (int p = 0; p < tz; ++p) {
                const int gz = z0 + p;
                float bv[4], v[4];
                b_of(p, bv);
                tile_word<MODE_RESIDUAL, SH>(pl, S, p, r, w, gz, gy, gx, fix0, fix1, bv,
                                             taps, treg, imask, inv_d, 0.0f, v);
                *reinterpret_cast<float4*>(T + (p * RY + r) * 64 + 4 * w) =
                    make_float4(v[0], v[1], v[2], v[3]);
            }
            store_words(r_out);
        } else if (pl.emit == 2) {
            // the fine residual on planes z0 - 1 .. z0 + tz - 1, rows y0 - 1 ..
            // y0 + 15, columns x0 - 1 .. x0 + 63 (zero outside the domain) into
            // R: (gz, gy, gx) at R[((gz - z0 + 1) * RRY + gy - y0 + 1) * RSX +
            // gx - x0 + 4].  Words a lane, 16 lanes a row; a half-warp past the
            // end computes a word of the other half again and keeps nothing.
            stage_in(pl, S, T, E, cur, nullptr, nullptr, tz, z0, y0, x0, nz, ny, nx, 0);
            __syncthreads();
            float* R = T;
            const int units = (tz + 1) * RRY * RW;
            for (int u0 = tid; u0 < ((units + 31) & ~31); u0 += RT) {
                const int u = u0 < units ? u0 : u0 - 16;
                const int row = u / RW, uw = u - row * RW;
                const int p = row / RRY - 1, ur = row % RRY - 1;
                const int gz = z0 + p, uy = y0 + ur, ux = x0 + 4 * uw;
                const bool rowin = gz >= 0 && gz < nz && uy >= 0 && uy < ny;
                float bv[4] = {0.0f, 0.0f, 0.0f, 0.0f}, v[4];
                const float* q = b + ((size_t)(rowin ? gz : 0) * ny + (rowin ? uy : 0)) * nx + ux;
                if (rowin && pl.vec4 && ux < nx) {
                    const float4 t = __ldg(reinterpret_cast<const float4*>(q));
                    bv[0] = t.x; bv[1] = t.y; bv[2] = t.z; bv[3] = t.w;
                } else if (rowin) {
                    for (int j = 0; j < 4; ++j)
                        if (ux + j < nx) bv[j] = __ldg(q + j);
                }
                unsigned f0, f1;
                word_fix(uy, ux, ny, nx, imask, f0, f1);
                tile_word<MODE_RESIDUAL, SH>(pl, S, p, ur, uw, gz, uy, ux, f0, f1, bv,
                                             taps, treg, imask, inv_d, 0.0f, v);
                if (u0 < units) {
                    float* d = R + ((p + 1) * RRY + ur + 1) * RSX + 4 + 4 * uw;
                    for (int j = 0; j < 4; ++j) d[j] = rowin && ux + j < nx ? v[j] : 0.0f;
                }
            }
            // the column x0 - 1, cell by cell
            for (int i = tid; i < (tz + 1) * RRY; i += RT) {
                const int p = i / RRY - 1, ur = i % RRY - 1;
                const int gz = z0 + p, uy = y0 + ur, ux = x0 - 1;
                float v = 0.0f;
                if (gz >= 0 && gz < nz && uy >= 0 && uy < ny && ux >= 0) {
                    const float* p0 = S + (p + 2) * RSY * RSX;
                    const int m = (gz == 0 ? 1 : 0) | (uy == 0 ? 2 : 0) | (ux == 0 ? 4 : 0);
                    v = cell_value<MODE_RESIDUAL, RSX>(
                        pl, p0 - RSY * RSX, p0, p0 + RSY * RSX, taps, imask,
                        (ur + 2) * RSX + 3, m, __ldg(b + ((size_t)gz * ny + uy) * nx + ux),
                        inv_d, 0.0f);
                }
                R[((p + 1) * RRY + ur + 1) * RSX + 3] = v;
            }
            __syncthreads();
            // the block's coarse points: fine index 2c + t sits at R index
            // 2 lc + t + 1 on each axis
            const int ncz = nz >> 1, ncy = ny >> 1, ncx = nx >> 1;
            for (int i = tid; i < (tz / 2) * (RY / 2) * 32; i += RT) {
                const int lz = i / ((RY / 2) * 32), ly = (i / 32) % (RY / 2), lx = i % 32;
                const int cz = z0 / 2 + lz, cy = y0 / 2 + ly, cx = x0 / 2 + lx;
                if (cz >= ncz || cy >= ncy || cx >= ncx) continue;
                float ax = 0.0f;
    #pragma unroll
                for (int tx = 0; tx < 3; ++tx) {
                    float ay = 0.0f;
    #pragma unroll
                    for (int ty = 0; ty < 3; ++ty) {
                        float az = 0.0f;
    #pragma unroll
                        for (int tq = 0; tq < 3; ++tq)
                            az += pl.rw[tq] * R[((2 * lz + tq) * RRY + 2 * ly + ty) * RSX +
                                                3 + 2 * lx + tx];
                        ay += pl.rw[ty] * az;
                    }
                    ax += pl.rw[tx] * ay;
                }
                r_out[((size_t)cz * ncy + cy) * ncx + cx] = ax;
            }
        }
    }
}

// The resident launch, where one member's tiles fit on the card at once:
// with the fewest planes a tile (1, 2, 4 or 8) that takes the batch in the
// fewest rounds (a round: as many members as fit at once, a divisor of nb,
// so every block has a member in every round), the most blocks.  One
// grid's visit is one round at the fewest planes that fit, as before
// batches.  Returns NO_FIT where one member's tiles do not fit (no CUDA
// error has its value), else what the launch returned.
constexpr int NO_FIT = -2;

template <int SH>
int launch_resident(Plan pl, cudaStream_t stream, const float* values,
                    const float* table, const float* b, const float* x,
                    const float* ec, float* x_out, float* r_out, int nz,
                    int ny, int nx, int nsm)
{
    const long tiles_yx = (long)((nx + 63) / 64) * ((ny + RY - 1) / RY);
    int best_tz = 0, best_group = 0, best_rounds = 0;
    size_t best_smem = 0;
    // a restriction forms the coarse points over a block's own planes:
    // an even number of them
    for (int tz = pl.emit == 2 ? 2 : 1; tz <= RZC; tz *= 2) {
        const long blocks = tiles_yx * ((nz + tz - 1) / tz);   // a member's
        if (blocks > 8L * nsm) continue;   // at most 2048 / RT blocks an SM
        const size_t smem = resident_floats(tz, pl.emit, pl.has_ec) * sizeof(float);
        cudaError_t e = cudaFuncSetAttribute(
            resident_visit_kernel<SH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_LIMIT - 2048);
        int per_sm = 0;
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, resident_visit_kernel<SH>, RT, smem);
        if (e != cudaSuccess) return (int)e;
        const long slots = (long)(per_sm < 8 ? per_sm : 8) * nsm;
        if (blocks > slots) continue;
        int group = 1;
        for (int g = pl.nb; g > 1; --g)
            if (pl.nb % g == 0 && g * blocks <= slots) {
                group = g;
                break;
            }
        const int rounds = pl.nb / group;
        if (best_tz == 0 || rounds < best_rounds) {
            best_tz = tz;
            best_group = group;
            best_rounds = rounds;
            best_smem = smem;
        }
    }
    if (best_tz == 0) return NO_FIT;
    pl.ZC = best_tz;
    pl.group = best_group;
    pl.rounds = best_rounds;
    dim3 grid((nx + 63) / 64, (ny + RY - 1) / RY, ((nz + best_tz - 1) / best_tz) * best_group);
    void* args[] = {&pl, &values, &table, &b, &x, &ec, &x_out, &r_out, &nz, &ny, &nx};
    return (int)cudaLaunchCooperativeKernel((const void*)resident_visit_kernel<SH>,
                                            grid, dim3(RT), args, best_smem, stream);
}

// The marching launch with a tile of TY rows: ZC, the planes a block owns,
// gives the fewest waves of blocks over the SMs times the steps a block
// walks (its chunk, 2D of halo, the pipeline's drain).
template <int SH, int TY>
int launch_march(Plan pl, cudaStream_t stream, const float* values,
                 const float* table, const float* b, const float* x,
                 const float* ec, float* x_out, float* r_out, int nz, int ny,
                 int nx, int nsm)
{
    constexpr int THREADS = C4 * (TY + 2 * MAX_DEPTH);
    pl.PY = TY + 2 * pl.D;
    pl.CPY = pl.PY / 2 + 2;
    const size_t smem = smem_floats(pl) * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        visit_kernel<SH, TY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT - 2048);
    int per_sm = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, visit_kernel<SH, TY>,
                                                          THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return -1;
    const long tiles = (long)((nx + pl.TXO - 1) / pl.TXO) * ((ny + TY - 1) / TY);
    const long slots = (long)nsm * per_sm;
    long best = -1;
    for (int zc = 2; zc < nz + 2; zc += 2) {
        const long blocks = tiles * ((nz + zc - 1) / zc) * pl.nb;
        const long cost = ((blocks + slots - 1) / slots) * (zc + 4 * pl.D);
        if (best < 0 || cost < best) {
            best = cost;
            pl.ZC = zc;
        }
    }
    const long zblocks = (long)((nz + pl.ZC - 1) / pl.ZC) * pl.nb;
    if (zblocks > 65535) return -1;
    dim3 grid((nx + pl.TXO - 1) / pl.TXO, (ny + TY - 1) / TY, (unsigned)zblocks);
    visit_kernel<SH, TY><<<grid, THREADS, smem, stream>>>(
        pl, values, table, b, x, ec, x_out, r_out, nz, ny, nx);
    return (int)cudaGetLastError();
}

// The shape the last launch took: 1 resident, 0 marching, -1 none yet.
int g_last_shape = -1;

// The resident launch where it fits; else the marching one with the
// tallest tile (32, 24 or 16 rows owned) whose rings fit in shared memory.
template <int SH>
int launch(Plan& pl, cudaStream_t stream, const float* values,
           const float* table, const float* b, const float* x, const float* ec,
           float* x_out, float* r_out, int nz, int ny, int nx)
{
    int dev = 0, nsm = 1;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (!pl.halo) {
        const int rc = launch_resident<SH>(pl, stream, values, table, b, x, ec, x_out,
                                           r_out, nz, ny, nx, nsm);
        g_last_shape = 1;
        if (rc != NO_FIT) return rc;
    }
    g_last_shape = 0;
    const int tys[3] = {32, 24, 16};
    for (int ty : tys) {
        Plan t = pl;
        t.PY = ty + 2 * pl.D;
        t.CPY = t.PY / 2 + 2;
        if (smem_floats(t) * sizeof(float) + 2048 > (size_t)SMEM_LIMIT) continue;
        if (ty == 32)
            return launch_march<SH, 32>(pl, stream, values, table, b, x, ec, x_out, r_out, nz, ny, nx, nsm);
        if (ty == 24)
            return launch_march<SH, 24>(pl, stream, values, table, b, x, ec, x_out, r_out, nz, ny, nx, nsm);
        return launch_march<SH, 16>(pl, stream, values, table, b, x, ec, x_out, r_out, nz, ny, nx, nsm);
    }
    return -1;
}

// Which compile-time offset table the operator's offsets are, or 0.
int shape_of(const int* offs, int K)
{
    const int shapes[2] = {7, 27};
    for (int sh : shapes) {
        if (K != sh) continue;
        bool same = true;
        for (int k = 0; k < K && same; ++k)
            for (int a = 0; a < 3; ++a)
                same &= offs[3 * k + a] ==
                        (sh == 7 ? star_off(k, a) : box_off(k, a));
        if (same) return sh;
    }
    return 0;
}

}  // namespace

// The deepest visit one launch takes: stages, +1 with a residual, +1 more
// with a restriction.  The wrapper splits deeper visits.
extern "C" int omg_fused_max_depth() { return MAX_DEPTH; }

// The shape of the last launch on this process: 1 resident, 0 marching.
extern "C" int omg_fused_last_shape() { return g_last_shape; }

// Runs the whole level visit on `stream` in one launch.  Returns 0, a CUDA
// error code, or -1 for arguments the kernel does not take.
//
//   values (K,) and table (n_regions, K): device pointers (table may be
//     null when every rowmap entry is -1).
//   offs (K*3 ints), rowmap (8 ints), kinds / pars (n_stages), rw / pw
//     (3 floats: weights of taps -1, 0, +1): host pointers.
//   x: start iterate or null (zero).  ec: coarse correction or null.
//   emit_residual: 0 none; 1 r_out = b - A x (fine size);
//     2 r_out = R (b - A x) (coarse size; all dims must be even).
//   x_out is written when there are stages or an ec; with neither, the
//     residual is taken of x itself.  Outputs must not alias inputs.
//   n_stages + (emit >= 1) + (emit == 2) <= omg_fused_max_depth().
//   The halo form: b_lo / b_hi (hlo / hhi planes of (ny, nx)), x_lo / x_hi
//     (as deep; null for a zero start), ec_lo / ec_hi (clo / chi coarse
//     planes; null without ec), with open_lo / open_hi: is there a rank
//     below / above.  hlo, hhi >= D; clo >= (D + 1) / 2, chi >= D / 2 + 1.
//     All null and 0 for a whole grid.
//   nb: members of a batch stacked along a leading axis (every grid
//     pointer then holds nb grids, one after another, and every halo
//     pointer nb slabs of its depth: K1hb); 1 for one grid.
extern "C" int omg_fused_stages(
    const float* values, const float* table, const int* offs, int K,
    const int* rowmap, const float* b, const float* x, const float* ec,
    float* x_out, float* r_out, int nz, int ny, int nx, int n_stages,
    const int* kinds, const float* pars, int emit_residual, const float* rw,
    const float* pw, const float* b_lo, const float* b_hi, const float* x_lo,
    const float* x_hi, const float* ec_lo, const float* ec_hi, int open_lo,
    int open_hi, int hlo, int hhi, int clo, int chi, int nb, void* stream_ptr)
{
    if (K < 1 || K > MAXK || nz < 1 || ny < 1 || nx < 1 || nb < 1) return -1;
    if (emit_residual < 0 || emit_residual > 2) return -1;
    if (emit_residual != 0 && r_out == nullptr) return -1;
    if ((ec != nullptr || emit_residual == 2) && ((nz | ny | nx) & 1)) return -1;
    if ((ec != nullptr || n_stages > 0) && x_out == nullptr) return -1;
    if (n_stages == 0 && ec == nullptr && emit_residual == 0) return -1;
    const int e1 = emit_residual >= 1, e2 = emit_residual == 2;
    const int D = n_stages + e1 + e2;
    if (n_stages < 0 || D > MAX_DEPTH) return -1;

    Plan pl;
    pl.K = K;
    pl.di = -1;
    for (int k = 0; k < MAXK; ++k) pl.oz[k] = pl.oy[k] = pl.ox[k] = 0;
    for (int k = 0; k < K; ++k) {
        const int oz = offs[3 * k], oy = offs[3 * k + 1], ox = offs[3 * k + 2];
        if (oz < -1 || oz > 1 || oy < -1 || oy > 1 || ox < -1 || ox > 1)
            return -1;
        if (oz == 0 && oy == 0 && ox == 0) pl.di = k;
        pl.oz[k] = oz;
        pl.oy[k] = oy;
        pl.ox[k] = ox;
    }
    if (pl.di < 0) return -1;
    for (int m = 0; m < 8; ++m) {
        pl.rowmap[m] = rowmap[m];
        if (rowmap[m] >= 0 && table == nullptr) return -1;
    }
    pl.n_stages = n_stages;
    for (int s = 0; s < MAX_DEPTH; ++s) {
        pl.kind[s] = s < n_stages ? kinds[s] : 0;
        pl.par[s] = s < n_stages ? pars[s] : 0.0f;
        if (s < n_stages && kinds[s] != MODE_JACOBI && kinds[s] != MODE_RB)
            return -1;
    }
    pl.emit = emit_residual;
    pl.D = D;
    pl.H = (D + 1) / 2 * 2;
    pl.TXO = PX - 2 * pl.H;
    pl.ZC = 2;
    // the levels whose output the next level reads: stages 1 .. S - 1, and
    // stage S when a residual follows
    pl.nring = n_stages > 0 ? n_stages - 1 + e1 : 0;
    pl.has_x = x != nullptr;
    pl.has_ec = ec != nullptr;
    // the x ring: with ec, level 0 forms plane s while level 1 reads s - 3 ..
    // s - 1 and s + 1 loads; without, level 1 reads s - 2 .. s as it arrived;
    // a zero start reads one zero plane
    pl.x0 = pl.has_ec ? X0 : pl.has_x ? X0 - 1 : 1;
    pl.d0 = pl.has_ec ? 0 : 1;
    uintptr_t ptrs = (uintptr_t)b | (uintptr_t)x | (uintptr_t)x_out;
    if (emit_residual == 1) ptrs |= (uintptr_t)r_out;
    pl.vec = (nx % 2 == 0) && (ptrs % 8 == 0);
    pl.vec4 = (nx % 4 == 0) && (ptrs % 16 == 0);
    for (int t = 0; t < 3; ++t) {
        pl.rw[t] = rw[t];
        pl.pw[t] = pw[t];
    }
    pl.halo = open_lo || open_hi || b_lo != nullptr;
    pl.nb = nb;
    pl.group = nb;
    pl.rounds = 1;
    pl.b_lo = b_lo; pl.b_hi = b_hi; pl.x_lo = x_lo; pl.x_hi = x_hi;
    pl.ec_lo = ec_lo; pl.ec_hi = ec_hi;
    pl.hlo = hlo; pl.hhi = hhi; pl.clo = clo; pl.chi = chi;
    open_lo = open_lo && pl.halo;
    open_hi = open_hi && pl.halo;
    if (open_lo && (b_lo == nullptr || hlo < D || (x != nullptr && x_lo == nullptr) ||
                    (ec != nullptr && (ec_lo == nullptr || clo < (D + 1) / 2))))
        return -1;
    if (open_hi && (b_hi == nullptr || hhi < D || (x != nullptr && x_hi == nullptr) ||
                    (ec != nullptr && (ec_hi == nullptr || chi < D / 2 + 1))))
        return -1;
    pl.zmin = open_lo ? -D : 0;
    pl.zmax = open_hi ? nz + D : nz;
    pl.czmin = open_lo ? -clo : 0;
    pl.czmax = open_hi ? (nz >> 1) + chi : nz >> 1;
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    switch (shape_of(offs, K)) {
    case 7:
        return launch<7>(pl, stream, values, table, b, x, ec, x_out, r_out, nz, ny, nx);
    case 27:
        return launch<27>(pl, stream, values, table, b, x, ec, x_out, r_out, nz, ny, nx);
    default:
        return launch<0>(pl, stream, values, table, b, x, ec, x_out, r_out, nz, ny, nx);
    }
}
