// One pass of a radius-1 3D stencil over the whole grid: a weighted-Jacobi
// step, one red/black colour, or the residual, for constant, cornered and
// varying coefficients.
//
// Replaces two TPU kernels of openmg_tpu/ops/kernels.py that share one body:
// _half_sweep (body _smoother_kernel; a (K,) vector of taps) and
// _half_sweep_vary (body _vary_kernel; K per-point coefficient grids).
//
//   jacobi    out = x + omega * (inv_d * (b - sum_k a_k x[i + o_k]))
//   residual  out = b - sum_k a_k x[i + o_k]
//   rb        out = inv_d * (b - sum_{k != diag} a_k x[i + o_k])  where the
//             point's global parity (z + y + x) & 1 equals the colour, else x
//
// What bounds it on an H100: bytes.  A pass does at most 2*27 flops a point
// against 12 bytes (constant taps: b and x read, out written) or 12 + 4K
// bytes (varying: the K coefficient grids are streamed too), far below the
// card's flop:byte ratio.
//
// One launch is one pass, always out of place: on 27-point levels points of
// one colour are coupled, so an in-place colour update would race between
// blocks.  Two half-sweeps ping-pong between buffers.  Two kernel bodies:
//
// const_pass_kernel (constant and cornered taps, K3): a 2.5D march.
//   * A block of 8 warps owns a tile of 8 rows x 128 columns (a warp a row,
//     4 columns a lane) and marches a chunk of zc planes (the wrapper's
//     plan, ops/kernels.py::sweep_plan, sized to fill the card).
//   * The planes of x, with a one-cell halo, pass through a ring of RING
//     slots in shared memory, filled by cp.async PF planes ahead (16 bytes a
//     lane where the rows allow; zero fill outside the plane, the Dirichlet
//     zero; a plane outside the grid is not loaded but read as zero), one
//     barrier a plane.  b is read a plane ahead into registers,
//     out written 16 bytes a lane.  Every x value comes from device memory
//     once a chunk (twice at the chunk's two halo planes).
//   * The offsets are compile-time for the 7-point Poisson order, the
//     27-point Galerkin order and the lifts of the 2D 5- and 9-point orders
//     (`Pat`): a lane reads the rows (dz, dy) the stencil uses as one
//     16-byte word (+ one word each side where a tap has dx != 0) and sums
//     the taps from registers, through template recursion.  Any other
//     offsets take a generic instance with per-tap shared-memory offsets.
//   * A red/black pass computes two of a lane's four points: the colour of
//     column x0 + j is (z + y + j) & 1 (x0 a multiple of 4), the same in
//     every lane.
//   * Cornered operators need no fix-up pass: the points on the low faces
//     (z, y or x == 0) are computed again with their row of an at most
//     8-row table in shared memory, chosen by which coordinates are 0 (as
//     in fused_stages.cu).  Region rows divide by their own diagonal,
//     interior rows multiply by the reciprocal of the interior diagonal.
//
// vary_pass_kernel (per-point coefficient grids, K4's one-level launches):
//   * A thread owns a pair of x-neighbours of one row; b, the centre of x
//     and the output move 8 bytes a lane where the rows are aligned for it.
//     A neighbour is read straight from device memory through the read-only
//     cache with a bounds check per tap; a neighbour outside the domain
//     contributes nothing (the Dirichlet zero).
//   * A red/black pass sums taps only for the point of the pair that has the
//     pass's colour, and reads the coefficient grids only there.  It still
//     touches every 32-byte sector of every coefficient grid: half of each
//     sector is fetched and not used.
//   * The tap count is a compile-time constant for 7 and 27 taps; any other
//     count up to 27 takes a generic instantiation.
//
// The batched form (K3b, K4b's single pass: the TPU kernels under jax.vmap,
// whose grids gain a leading batch axis): nb members of one grid stacked
// along a leading axis, (nb, nz, ny, nx) for b, x and out, one launch for
// all of them; the operator (taps, region table, coefficient grids) is
// shared.  const_pass_kernel takes the member from blockIdx.y (the outer
// part of the grid, as in fused_stages.cu), each member tiled by the scalar
// launch's plan; vary_pass_kernel takes it as the fastest part of
// blockIdx.x, so the nb blocks of one tile run together and read that
// tile's coefficients through L2 once.  A member's arithmetic is the scalar
// launch's on it, bit for bit.  With halos (K3hb, K4hb) each member has
// its own received planes, (nb, ny, nx) below and above, moved to the
// member's with its grids.
//
// The halo form (a rank's z-slab of a row-partitioned grid, replacing the
// TPU kernels halo_half_sweep_const_3d / halo_half_sweep_vary_3d of
// openmg_tpu/ops/kernels.py): two more pointers, the (ny, nx) planes
// received from the ranks below and above, stand for planes -1 and nz.  Both
// bodies read a plane through plane_of(), which returns them there (null,
// the Dirichlet zero, where a pointer is null), so the received planes are
// consumed where the pass reads its neighbours: no boundary epilogue and no
// concatenated slab.  Everything else, bytes and tiling included, is the
// whole-grid pass's; the two planes add 2 / nz to the bytes read.
//
// Rounding: the sum runs in the order of the offsets list (the diagonal is
// skipped in a red/black pass) and the update multiplies by 1/diag, as the
// TPU kernels do; nvcc may contract a*b+c into a fused multiply-add, which
// the plain PyTorch version does not, so they agree to a few ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 27;
constexpr int BX = 32, BY = 8;  // vary_pass_kernel: 64 x-points by 8 rows

enum Mode { MODE_JACOBI = 0, MODE_RB = 1, MODE_RESIDUAL = 2 };

struct Sweep {
    int K;
    int di;             // index of the (0,0,0) offset
    int oz[MAXK], oy[MAXK], ox[MAXK];
    int pos[MAXK];      // (oz + 1) * 9 + (oy + 1) * 3 + (ox + 1)
    int rowmap[8];      // mask of zero coordinates -> region-table row, -1 = interior
    int corner;         // some rowmap entry is a table row
};

// The value written for one point.  `interior` rows multiply by inv_d,
// region rows of a cornered operator divide by their own diagonal.
template <int MODE>
__device__ __forceinline__ float finish(
    bool update, float acc, float bv, float xv, bool interior, float inv_d,
    float diag, float omega)
{
    const float res = bv - acc;
    if (MODE == MODE_RESIDUAL) return res;
    if (MODE == MODE_JACOBI)
        return interior ? xv + omega * (inv_d * res)
                        : xv + (omega * res) / diag;
    if (!update) return xv;
    return interior ? inv_d * res : res / diag;
}

// ---------------------------------------------------------------------------
// const_pass_kernel
// ---------------------------------------------------------------------------

constexpr int CX = 128;             // tile columns, 4 a lane
constexpr int CY = 8;               // tile rows, a warp each
constexpr int CTHREADS = 32 * CY;
constexpr int RS = CX + 8;          // slot row: pad, halo at 3, tile at 4.., halo at 4 + CX
constexpr int PLANE = (CY + 2) * RS;
constexpr int PF = 2;               // planes in flight ahead of the one needed
constexpr int RING = PF + 4;        // a slot is refilled two planes after its last read

// Tap positions (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1) in the order of the
// offsets.  PAT 1: the 7-point Poisson order (centre, -z, +z, -y, +y, -x,
// +x); 2: the 27-point Galerkin order (centre, then the others in
// lexicographic order); 3, 4: the 2D 5- and 9-point orders lifted to
// (1, ny, nx).  PAT 0: any other offsets, read from the Sweep at run time.
template <int PAT> struct Pat;
template <> struct Pat<1> {
    static constexpr int K = 7;
    static constexpr int pos[7] = {13, 4, 22, 10, 16, 12, 14};
};
template <> struct Pat<2> {
    static constexpr int K = 27;
    static constexpr int pos[27] = {13, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                                    14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26};
};
template <> struct Pat<3> {
    static constexpr int K = 5;
    static constexpr int pos[5] = {13, 10, 16, 12, 14};
};
template <> struct Pat<4> {
    static constexpr int K = 9;
    static constexpr int pos[9] = {13, 9, 10, 11, 12, 14, 15, 16, 17};
};

// does a tap of PAT lie in row A = (dz + 1) * 3 + (dy + 1); with dx != 0?
template <int PAT>
__host__ __device__ constexpr bool uses_row(int A, bool shifted)
{
    for (int k = 0; k < Pat<PAT>::K; ++k)
        if (Pat<PAT>::pos[k] / 3 == A && (!shifted || Pat<PAT>::pos[k] % 3 != 1))
            return true;
    return false;
}

// seg[A][0..5]: row A of the lane's neighbourhood, columns x0 - 1 .. x0 + 4
template <int PAT, int A>
struct Rows {
    static __device__ __forceinline__ void load(
        float (&seg)[9][6], const float* pm, const float* pc, const float* pp,
        int off)
    {
        if constexpr (A < 9) {
            constexpr int dz = A / 3 - 1, dy = A % 3 - 1;
            if constexpr (uses_row<PAT>(A, false)) {
                const float* p = dz < 0 ? pm : dz > 0 ? pp : pc;
                if (p == nullptr) {   // a plane outside the grid
#pragma unroll
                    for (int e = 0; e < 6; ++e) seg[A][e] = 0.0f;
                } else {
                    p += off + dy * RS;
                    const float4 c = *reinterpret_cast<const float4*>(p);
                    seg[A][1] = c.x;
                    seg[A][2] = c.y;
                    seg[A][3] = c.z;
                    seg[A][4] = c.w;
                    if constexpr (uses_row<PAT>(A, true)) {
                        seg[A][0] = p[-1];
                        seg[A][5] = p[4];
                    }
                }
            }
            Rows<PAT, A + 1>::load(seg, pm, pc, pp, off);
        }
    }
};

// acc += tp[k] * x(point J + offset k) for the offsets of PAT, in order
template <int PAT, int J, int k, bool SKIPD>
struct Taps {
    template <typename T>
    static __device__ __forceinline__ void run(float& acc, const float (&seg)[9][6],
                                               const T& tp)
    {
        if constexpr (k < Pat<PAT>::K) {
            constexpr int p = Pat<PAT>::pos[k];
            if constexpr (!(SKIPD && p == 13))
                acc += tp[k] * seg[p / 3][J + p % 3];
            Taps<PAT, J, k + 1, SKIPD>::run(acc, seg, tp);
        }
    }
};

// the sum of point J (0..3 of the lane) of a generic stencil, from shared
// memory: plane of tap k by its dz (null: outside the grid, zero), then the
// offset in the slot
template <bool SKIPD, typename T>
__device__ __forceinline__ float taps_generic(
    const Sweep& st, const T& tp, const float* pm, const float* pc,
    const float* pp, int off)
{
    float acc = 0.0f;
    for (int k = 0; k < st.K; ++k) {
        if (SKIPD && k == st.di) continue;
        const float* p = st.oz[k] < 0 ? pm : st.oz[k] > 0 ? pp : pc;
        acc += tp[k] * (p == nullptr ? 0.0f : p[off + st.oy[k] * RS + st.ox[k]]);
    }
    return acc;
}

template <int PAT, int J, bool SKIPD, typename T>
__device__ __forceinline__ float tap_sum(
    const Sweep& st, const float (&seg)[9][6], const T& tp, const float* pm,
    const float* pc, const float* pp, int off)
{
    if constexpr (PAT == 0) {
        return taps_generic<SKIPD>(st, tp, pm, pc, pp, off + J);
    } else {
        float acc = 0.0f;
        Taps<PAT, J, 0, SKIPD>::run(acc, seg, tp);
        return acc;
    }
}

// point J of the lane: its new value (interior taps, then the region row
// where one of its coordinates is 0)
template <int PAT, int MODE, int J>
__device__ __forceinline__ float lane_point(
    const Sweep& st, const float (&seg)[9][6], const float (&treg)[MAXK],
    const float (*taps)[MAXK], const int* rowmap, const float* pm,
    const float* pc, const float* pp, int off, float bv, float inv_d,
    float omega, int upd, int z, int y, int x)
{
    const float xv = PAT == 0 ? pc[off + J] : seg[4][J + 1];
    const bool on = MODE != MODE_RB || (J & 1) == upd;
    if (!on) return xv;
    float v = finish<MODE>(true, tap_sum<PAT, J, MODE == MODE_RB>(st, seg, treg, pm,
                                                                  pc, pp, off),
                           bv, xv, true, inv_d, 1.0f, omega);
    if (st.corner && (z == 0 || y == 0 || x + J == 0)) {
        const int m = (z == 0 ? 1 : 0) | (y == 0 ? 2 : 0) | (x + J == 0 ? 4 : 0);
        if (rowmap[m] >= 0)
            v = finish<MODE>(true,
                             tap_sum<PAT, J, MODE == MODE_RB>(st, seg, taps[m], pm,
                                                              pc, pp, off),
                             bv, xv, false, inv_d, taps[m][st.di], omega);
    }
    return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? 16 : 0;    // 0: fill with zeros, read nothing
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    const int n = ok ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const float* p)
{
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// Plane z of x: the grid's own plane, the received plane below (z == -1)
// or above (z == nz) of a halo form, or null (outside the grid: zero).
__device__ __forceinline__ const float* plane_of(
    const float* x, const float* lower, const float* upper, int z, int nz,
    int ny, int nx)
{
    if (z >= 0 && z < nz) return x + (size_t)z * ny * nx;
    return z == -1 ? lower : z == nz ? upper : nullptr;
}

// Plane xp (plane_of) with a one-cell halo into a slot: tile rows gy0 - 1
// .. gy0 + CY, columns gx0 - 1 .. gx0 + CX, zero outside the plane.  A
// plane outside the grid (null) is not loaded: the pass reads it as zero.
__device__ __forceinline__ void load_plane(
    float* dst, const float* xp, int gy0, int gx0, int ny, int nx, bool vec,
    int tid)
{
    if (xp == nullptr) return;
    const float* x = xp;   // a valid address for the copies that read nothing
    if (vec) {
        for (int i = tid; i < (CY + 2) * (CX / 4); i += CTHREADS) {
            const int r = i / (CX / 4), c = 4 * (i % (CX / 4));
            const int gy = gy0 - 1 + r, gx = gx0 + c;
            const bool ok = gy >= 0 && gy < ny && gx < nx;
            cp_async16(dst + r * RS + 4 + c, ok ? xp + (size_t)gy * nx + gx : x, ok);
        }
        for (int i = tid; i < 2 * (CY + 2); i += CTHREADS) {
            const int r = i >> 1, hi = i & 1;
            const int gy = gy0 - 1 + r, gx = hi ? gx0 + CX : gx0 - 1;
            const bool ok = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
            cp_async4(dst + r * RS + (hi ? 4 + CX : 3),
                      ok ? xp + (size_t)gy * nx + gx : x, ok);
        }
    } else {
        for (int i = tid; i < (CY + 2) * (CX + 2); i += CTHREADS) {
            const int r = i / (CX + 2), c = i % (CX + 2);
            const int gy = gy0 - 1 + r, gx = gx0 - 1 + c;
            const bool ok = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
            cp_async4(dst + r * RS + 3 + c, ok ? xp + (size_t)gy * nx + gx : x, ok);
        }
    }
}

// the lane's 4 points of row (z, y) of a grid, from column x0; zero outside
__device__ __forceinline__ void load4(float (&v)[4], const float* g, int z, int y,
                                      int x0, int ny, int nx, bool vec)
{
    const float* p = g + ((size_t)z * ny + y) * nx + x0;
    if (vec) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = t.x;
        v[1] = t.y;
        v[2] = t.z;
        v[3] = t.w;
    } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = x0 + j < nx ? __ldg(p + j) : 0.0f;
    }
}

// grid: one block a (tile, chunk), tiles_x * tiles_y tiles, the chunk's
// planes [chunk * zc, min(nz, (chunk + 1) * zc)).
template <int PAT, int MODE>
__global__ void __launch_bounds__(CTHREADS, 2) const_pass_kernel(
    const Sweep st, const float* __restrict__ values,
    const float* __restrict__ table, const float* __restrict__ b,
    const float* __restrict__ x, const float* __restrict__ lower,
    const float* __restrict__ upper, float* __restrict__ out, int nz, int ny,
    int nx, float omega, int color, int zc, int tiles_x, int tiles_y, int vec)
{
    // member blockIdx.y of a batch: its own b, x and out, and received
    // planes
    const size_t mo = (size_t)blockIdx.y * nz * ny * nx;
    b += mo;
    x += mo;
    out += mo;
    if (lower != nullptr) lower += (size_t)blockIdx.y * ny * nx;
    if (upper != nullptr) upper += (size_t)blockIdx.y * ny * nx;
    __shared__ __align__(16) float ring[RING * PLANE];
    // taps[m][k]: tap of offset k for a point whose zero-coordinate mask is
    // m (bit 0: z == 0, bit 1: y == 0, bit 2: x == 0)
    __shared__ float taps[8][MAXK];
    __shared__ int rowmap[8];
    const int tid = threadIdx.x;
    for (int i = tid; i < 8 * MAXK; i += CTHREADS) {
        const int m = i / MAXK, k = i - m * MAXK;
        const int row = st.rowmap[m];
        taps[m][k] = k >= st.K ? 0.0f : row < 0 ? values[k] : table[row * st.K + k];
    }
    if (tid < 8) rowmap[tid] = st.rowmap[tid];
    __syncthreads();

    const int tiles = tiles_x * tiles_y;
    const int tile = blockIdx.x % tiles, chunk = blockIdx.x / tiles;
    const int gx0 = (tile % tiles_x) * CX, gy0 = (tile / tiles_x) * CY;
    const int z0 = chunk * zc, z1 = min(z0 + zc, nz);
    const int lane = tid & 31;
    const int y = gy0 + (tid >> 5), x0 = gx0 + 4 * lane;
    const bool live = y < ny && x0 < nx;
    const int off = (1 + (tid >> 5)) * RS + 4 + 4 * lane;   // the lane's point 0 in a slot

    float treg[MAXK];
#pragma unroll
    for (int k = 0; k < MAXK; ++k) treg[k] = taps[0][k];
    const float inv_d = 1.0f / taps[0][st.di];

    // slot q % RING holds plane z0 - 1 + q; planes past z1 are never read
    for (int q = 0; q < PF + 2; ++q) {
        if (z0 - 1 + q <= z1)
            load_plane(ring + q * PLANE,
                       plane_of(x, lower, upper, z0 - 1 + q, nz, ny, nx), gy0, gx0,
                       ny, nx, vec, tid);
        cp_async_commit();
    }
    float bn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (live) load4(bn, b, z0, y, x0, ny, nx, vec);

    for (int z = z0; z < z1; ++z) {
        const int q = z - z0 + 1;
        if (z + PF + 1 <= z1)
            load_plane(ring + ((q + PF + 1) % RING) * PLANE,
                       plane_of(x, lower, upper, z + PF + 1, nz, ny, nx), gy0, gx0,
                       ny, nx, vec, tid);
        cp_async_commit();   // an empty group past z1 keeps the count
        cp_async_wait<PF>();      // planes up to z + 1 have landed
        __syncthreads();
        float bv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bn[j];
        if (!live) continue;
        if (z + 1 < z1) load4(bn, b, z + 1, y, x0, ny, nx, vec);
        if (z + PF + 1 < z1) prefetch_l2(b + ((size_t)(z + PF + 1) * ny + y) * nx + x0);

        const float* pm = z > 0 || lower != nullptr ? ring + ((q - 1) % RING) * PLANE
                                                   : nullptr;
        const float* pc = ring + (q % RING) * PLANE;
        const float* pp = z + 1 < nz || upper != nullptr
                              ? ring + ((q + 1) % RING) * PLANE : nullptr;
        float seg[9][6];
        if constexpr (PAT != 0) Rows<PAT, 0>::load(seg, pm, pc, pp, off);
        const int upd = MODE == MODE_RB ? ((color - z - y) & 1) : 0;
        float o[4];
        o[0] = lane_point<PAT, MODE, 0>(st, seg, treg, taps, rowmap, pm, pc, pp, off,
                                        bv[0], inv_d, omega, upd, z, y, x0);
        o[1] = lane_point<PAT, MODE, 1>(st, seg, treg, taps, rowmap, pm, pc, pp, off,
                                        bv[1], inv_d, omega, upd, z, y, x0);
        o[2] = lane_point<PAT, MODE, 2>(st, seg, treg, taps, rowmap, pm, pc, pp, off,
                                        bv[2], inv_d, omega, upd, z, y, x0);
        o[3] = lane_point<PAT, MODE, 3>(st, seg, treg, taps, rowmap, pm, pc, pp, off,
                                        bv[3], inv_d, omega, upd, z, y, x0);
        float* po = out + ((size_t)z * ny + y) * nx + x0;
        if (vec) {
            *reinterpret_cast<float4*>(po) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (x0 + j < nx) po[j] = o[j];
        }
    }
    cp_async_wait<0>();
}

template <int PAT>
int launch_const(int mode, const Sweep& st, const float* values,
                 const float* table, const float* b, const float* x,
                 const float* lower, const float* upper, float* out,
                 int nz, int ny, int nx, float omega, int color, int zc, int vec,
                 int nb, cudaStream_t s)
{
    const int tiles_x = (nx + CX - 1) / CX, tiles_y = (ny + CY - 1) / CY;
    const long long blocks = (long long)tiles_x * tiles_y * ((nz + zc - 1) / zc);
    if (blocks > 0x7fffffffLL || nb > 65535) return -2;
    const dim3 grid((unsigned)blocks, (unsigned)nb);
    switch (mode) {
    case MODE_JACOBI:
        const_pass_kernel<PAT, MODE_JACOBI><<<grid, CTHREADS, 0, s>>>(
            st, values, table, b, x, lower, upper, out, nz, ny, nx, omega, color,
            zc, tiles_x, tiles_y, vec);
        return 0;
    case MODE_RB:
        const_pass_kernel<PAT, MODE_RB><<<grid, CTHREADS, 0, s>>>(
            st, values, table, b, x, lower, upper, out, nz, ny, nx, omega, color,
            zc, tiles_x, tiles_y, vec);
        return 0;
    case MODE_RESIDUAL:
        const_pass_kernel<PAT, MODE_RESIDUAL><<<grid, CTHREADS, 0, s>>>(
            st, values, table, b, x, lower, upper, out, nz, ny, nx, omega, color,
            zc, tiles_x, tiles_y, vec);
        return 0;
    }
    return -2;
}

template <int PAT>
bool is_pat(const Sweep& st)
{
    if (st.K != Pat<PAT>::K) return false;
    for (int k = 0; k < st.K; ++k)
        if (st.pos[k] != Pat<PAT>::pos[k]) return false;
    return true;
}

// ---------------------------------------------------------------------------
// vary_pass_kernel
// ---------------------------------------------------------------------------

// coef: (K, nz, ny, nx) coefficient grids
template <int MODE, int KT>
__global__ void __launch_bounds__(BX * BY) vary_pass_kernel(
    const Sweep st, const float* __restrict__ coef,
    const float* __restrict__ b, const float* __restrict__ x,
    const float* __restrict__ lower, const float* __restrict__ upper,
    float* __restrict__ out, int nz, int ny, int nx, float omega, int color,
    int vec, int nb)
{
    constexpr int KN = KT > 0 ? KT : MAXK;
    // the member is the fastest part of blockIdx.x: the nb blocks of a tile
    // are neighbours in the launch order and share its coefficients in L2
    const int member = blockIdx.x % nb;
    const int gx = ((blockIdx.x / nb) * BX + threadIdx.x) * 2;
    const int gy = blockIdx.y * BY + threadIdx.y;
    const int gz = blockIdx.z;
    if (gx >= nx || gy >= ny) return;

    const size_t n = (size_t)nz * ny * nx;
    b += member * n;
    x += member * n;
    out += member * n;
    if (lower != nullptr) lower += (size_t)member * ny * nx;
    if (upper != nullptr) upper += (size_t)member * ny * nx;
    const size_t c = ((size_t)gz * ny + gy) * nx + gx;
    const bool two = gx + 1 < nx;
    // which points of the pair get a sum: in a red/black pass only the one
    // whose parity is the pass's colour
    bool do0 = true, do1 = two;
    if (MODE == MODE_RB) {
        do0 = ((gz + gy + gx) & 1) == color;
        do1 = two && !do0;
    }
    const bool pair_coef = MODE != MODE_RB && vec;

    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
        if (KT == 0 && k >= st.K) break;
        if (MODE == MODE_RB && k == st.di) continue;
        const int zz = gz + st.oz[k], yy = gy + st.oy[k];
        const float* pz = plane_of(x, lower, upper, zz, nz, ny, nx);
        if (pz == nullptr || yy < 0 || yy >= ny) continue;
        const float* row = pz + (size_t)yy * nx;
        const int x0 = gx + st.ox[k], x1 = x0 + 1;
        float a0 = 0.0f, a1 = 0.0f;
        const float* ck = coef + (size_t)k * n + c;
        if (pair_coef) {
            const float2 t = __ldg(reinterpret_cast<const float2*>(ck));
            a0 = t.x;
            a1 = t.y;
        } else {
            if (do0) a0 = __ldg(ck);
            if (do1) a1 = __ldg(ck + 1);
        }
        if (do0 && x0 >= 0 && x0 < nx) acc0 += a0 * __ldg(row + x0);
        if (do1 && x1 < nx) acc1 += a1 * __ldg(row + x1);
    }

    float b0, b1 = 0.0f, xc0, xc1 = 0.0f;
    if (vec) {
        const float2 tb = *reinterpret_cast<const float2*>(b + c);
        const float2 tx = *reinterpret_cast<const float2*>(x + c);
        b0 = tb.x; b1 = tb.y; xc0 = tx.x; xc1 = tx.y;
    } else {
        b0 = b[c];
        xc0 = x[c];
        if (two) { b1 = b[c + 1]; xc1 = x[c + 1]; }
    }

    float inv0 = 0.0f, inv1 = 0.0f;
    if (MODE != MODE_RESIDUAL) {
        const float* cd = coef + (size_t)st.di * n + c;
        if (do0) inv0 = 1.0f / __ldg(cd);
        if (do1) inv1 = 1.0f / __ldg(cd + 1);
    }
    const float o0 = finish<MODE>(do0, acc0, b0, xc0, true, inv0, 1.0f, omega);
    const float o1 = finish<MODE>(do1, acc1, b1, xc1, true, inv1, 1.0f, omega);
    if (vec) {
        *reinterpret_cast<float2*>(out + c) = make_float2(o0, o1);
    } else {
        out[c] = o0;
        if (two) out[c + 1] = o1;
    }
}

template <int MODE>
void launch_vary_by_taps(
    const Sweep& st, const float* coef, const float* b, const float* x,
    const float* lower, const float* upper, float* out, int nz, int ny, int nx,
    float omega, int color, int vec, int nb, cudaStream_t s)
{
    const dim3 block(BX, BY, 1);
    const dim3 grid((nx + 2 * BX - 1) / (2 * BX) * nb, (ny + BY - 1) / BY, nz);
    if (st.K == 7)
        vary_pass_kernel<MODE, 7><<<grid, block, 0, s>>>(
            st, coef, b, x, lower, upper, out, nz, ny, nx, omega, color, vec, nb);
    else if (st.K == 27)
        vary_pass_kernel<MODE, 27><<<grid, block, 0, s>>>(
            st, coef, b, x, lower, upper, out, nz, ny, nx, omega, color, vec, nb);
    else
        vary_pass_kernel<MODE, 0><<<grid, block, 0, s>>>(
            st, coef, b, x, lower, upper, out, nz, ny, nx, omega, color, vec, nb);
}

int launch_vary(int mode, const Sweep& st, const float* coef, const float* b,
                const float* x, const float* lower, const float* upper, float* out,
                int nz, int ny, int nx, float omega, int color, int vec, int nb,
                cudaStream_t s)
{
    if (nz > 65535 || (ny + BY - 1) / BY > 65535) return -2;
    if ((long long)((nx + 2 * BX - 1) / (2 * BX)) * nb > 0x7fffffffLL) return -2;
    switch (mode) {
    case MODE_JACOBI:
        launch_vary_by_taps<MODE_JACOBI>(st, coef, b, x, lower, upper, out, nz, ny, nx, omega,
                                         color, vec, nb, s);
        return 0;
    case MODE_RB:
        launch_vary_by_taps<MODE_RB>(st, coef, b, x, lower, upper, out, nz, ny, nx, omega,
                                     color, vec, nb, s);
        return 0;
    case MODE_RESIDUAL:
        launch_vary_by_taps<MODE_RESIDUAL>(st, coef, b, x, lower, upper, out, nz, ny, nx, omega,
                                           color, vec, nb, s);
        return 0;
    }
    return -2;
}

}  // namespace

// Columns and rows of a tile of the constant pass (the wrapper's plan is
// made for them).
extern "C" int omg_half_sweep_tile(int axis) { return axis == 0 ? CX : CY; }

// One pass.  offs: K*3 ints; rowmap: 8 ints (all -1 without a region table).
// lower / upper: the (ny, nx) planes below plane 0 and above plane nz - 1
// (the halo form), or null (the Dirichlet zero).
// vary != 0: coef is (K, nz, ny, nx) and table/rowmap/zc are not read;
// otherwise a block marches zc planes of a tile (ops/kernels.py::sweep_plan).
// nb: members of a batch (b, x and out (nb, nz, ny, nx), lower and upper
// (nb, ny, nx); 1 for one grid).
// Returns 0, a negative code of its own (-1: stencil not taken, -2: bad mode,
// grid or batch, -3: out aliases an input) or the CUDA error of the launch.
extern "C" int omg_half_sweep(
    const float* coef, const float* table, const int* offs, int K,
    const int* rowmap, int vary, int mode, float omega, int color,
    const float* b, const float* x, const float* lower, const float* upper,
    float* out, int nz, int ny, int nx, int zc, int nb, void* stream)
{
    if (K < 1 || K > MAXK) return -1;
    Sweep st;
    st.K = K;
    st.di = -1;
    for (int k = 0; k < MAXK; ++k) {
        st.oz[k] = st.oy[k] = st.ox[k] = 0;
        st.pos[k] = 13;
    }
    for (int k = 0; k < K; ++k) {
        const int oz = offs[3 * k], oy = offs[3 * k + 1], ox = offs[3 * k + 2];
        if (oz < -1 || oz > 1 || oy < -1 || oy > 1 || ox < -1 || ox > 1)
            return -1;
        if (oz == 0 && oy == 0 && ox == 0) st.di = k;
        st.oz[k] = oz;
        st.oy[k] = oy;
        st.ox[k] = ox;
        st.pos[k] = (oz + 1) * 9 + (oy + 1) * 3 + (ox + 1);
    }
    if (st.di < 0) return -1;
    st.corner = 0;
    for (int m = 0; m < 8; ++m) {
        st.rowmap[m] = vary ? -1 : rowmap[m];
        if (st.rowmap[m] >= 0 && table == nullptr) return -1;
        st.corner |= st.rowmap[m] >= 0;
    }
    if (nz < 1 || ny < 1 || nx < 1 || mode < 0 || mode > 2) return -2;
    if (nb < 1) return -2;
    if (out == x || out == b || out == lower || out == upper) return -3;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int rc;
    if (vary) {
        const int vec = (nx % 2 == 0)
            && ((((uintptr_t)b) | ((uintptr_t)x) | ((uintptr_t)out)
                 | ((uintptr_t)coef)) & 7) == 0;
        rc = launch_vary(mode, st, coef, b, x, lower, upper, out, nz, ny, nx, omega,
                         color, vec, nb, s);
    } else {
        if (zc < 1) return -2;
        const int vec = (nx % 4 == 0)
            && ((((uintptr_t)b) | ((uintptr_t)x) | ((uintptr_t)out)
                 | ((uintptr_t)lower) | ((uintptr_t)upper)) & 15) == 0;
        const float* table_ = table;
        rc = is_pat<1>(st) ? launch_const<1>(mode, st, coef, table_, b, x, lower, upper, out, nz, ny, nx, omega, color, zc, vec, nb, s)
           : is_pat<2>(st) ? launch_const<2>(mode, st, coef, table_, b, x, lower, upper, out, nz, ny, nx, omega, color, zc, vec, nb, s)
           : is_pat<3>(st) ? launch_const<3>(mode, st, coef, table_, b, x, lower, upper, out, nz, ny, nx, omega, color, zc, vec, nb, s)
           : is_pat<4>(st) ? launch_const<4>(mode, st, coef, table_, b, x, lower, upper, out, nz, ny, nx, omega, color, zc, vec, nb, s)
           : launch_const<0>(mode, st, coef, table_, b, x, lower, upper, out, nz, ny, nx, omega, color, zc, vec, nb, s);
    }
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}
