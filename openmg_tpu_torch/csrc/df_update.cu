// Double-float outer step: x <- x + e and r = hi(b - A x') in one pass.
//
// Replaces the TPU kernel
// openmg_tpu/ops/kernels.py::df_update_residual_const_3d (body
// _fused_kernel): per point, (x_hi, x_lo) <- df_add_f32((x_hi, x_lo), e);
// then the residual of the constant radius-1 stencil in two-float
// arithmetic, acc <- acc - p * x'[i + off] over the power-of-two terms p of
// every tap (products exact, compensated adds only), in the order of the
// offsets and of each tap's terms; optionally the sum of r_hi^2.
//
// What bounds it on an H100: bytes.  Five arrays are read and three
// written, 32 bytes a point, against roughly 20 float operations per term;
// the least time is 32 * n^3 bytes over the memory rate.
//
// What the design does about it:
//   * A block owns a 16 x 32 tile of (y, x) and marches along a chunk of z.
//     It keeps the UPDATED pair x' = x + e, hi and lo, of three planes
//     (z - 1, z, z + 1) of its tile and a one-point (y, x) halo in shared
//     memory, a rolling window: each step forms one new plane.  So x_hi,
//     x_lo and e are read and df-updated 18 * 34 / (16 * 32) = 1.2 times a
//     point (plus two planes a chunk), not K times, and the neighbour's
//     update is not recomputed per tap.  A 2D grid lifted to (1, ny, nx) is
//     one plane with no z-halo.  Out-of-domain points hold (0, 0):
//     Dirichlet truncation.
//   * The next two planes' x_hi, x_lo, e (16-byte loads where the row is
//     aligned) and b are loaded into registers while the current plane's
//     residual is computed: one plane of compute is shorter than the
//     memory's latency.
//   * The 7-point Poisson operator (and its 5-point 2D lift) have their
//     offsets and term counts fixed at compile time; any other operator of
//     at most 27 taps runs the generic body.
//   * The compensated sequences are written with __fadd_rn / __fsub_rn /
//     __fmul_rn, which nvcc neither reassociates nor contracts into fused
//     multiply-adds, so x_hi', x_lo' and r_hi equal the plain PyTorch
//     version bit for bit.
//   * With emit_norm each block reduces r_hi^2 over its points in a fixed
//     order (per thread along z, warp shuffles, then one thread over the
//     warps) and writes one partial; the caller sums the partials.  No
//     float atomics, so two runs give the same bits.  The contract is that
//     the partials sum to ||r_hi||^2; their number (omg_df_num_partials,
//     a function of the grid's shape alone) and layout are this kernel's
//     own.
//
// The batched form (the TPU kernel under jax.vmap, whose grid gains a
// leading batch axis): nb members of one shape stacked along a leading
// axis, one launch for all of them.  The member is the outer part of
// blockIdx.z, above the z-chunks; each member is tiled and chunked as a
// launch on it alone would be, so its outputs and its partials (a block of
// omg_df_num_partials entries at member * pstride) are that launch's, bit
// for bit.  With halos (K2hb) each member has its own received planes,
// stacked like its grids: (nb, ny, nx) for each of the six.
//
// The halo form (a rank's z-slab of a row-partitioned grid; the TPU
// kernel's halos= argument): the (ny, nx) planes of x_hi, x_lo and e
// received from the ranks below and above stand for planes -1 and nz.  The
// window loads them as it loads its own planes and df-updates them the same
// way, so the neighbours' x' is formed in the kernel and no edge repair
// follows.  Null planes are the Dirichlet zero, as without halos.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 27;
constexpr int MAXT = 3;  // power-of-two terms per tap
constexpr int TX = 32, TY = 16;
constexpr int SX = TX + 2, SY = TY + 2;
constexpr int SP = SX * SY;              // cells of one plane of the window
constexpr int THREADS = TX * TY;         // a thread per owned (y, x)
constexpr int NVEC = SY * (TX / 4);      // 16-byte loads of a plane's rows
constexpr int NLOAD = NVEC + 2 * SY;     // ... and the two halo columns
// blocks a launch aims at: about eight waves of one block an SM on an H100
// (a plain constant, so the partial count depends on the shape alone)
constexpr long TARGET_BLOCKS = 1024;

// The received planes of a halo form: x_hi, x_lo, e below plane 0 (lh, ll,
// le) and above plane nz - 1 (uh, ul, ue); all null without halos.
struct DfHalo {
    const float *lh, *ll, *le, *uh, *ul, *ue;
};

struct DfStencil {
    int K;
    int oz[MAXK], oy[MAXK], ox[MAXK];
    int nterms[MAXK];
    float terms[MAXK * MAXT];
};

// Offsets of the 7-point Poisson operator (SH 7: poisson_offsets(3),
// centre then -/+ per axis) and of its 2D lift (SH 5: (0, oy, ox) of
// poisson_offsets(2)); a = 0 z, 1 y, 2 x.
__host__ __device__ constexpr int star_off(int k, int a, int ndim)
{
    return k == 0 ? 0 : ((k - 1) / 2 == a - (3 - ndim) ? ((k - 1) % 2 == 0 ? -1 : 1) : 0);
}

template <int SH>
__host__ __device__ constexpr int off(int k, int a)
{
    return star_off(k, a, SH == 7 ? 3 : 2);
}

// their term counts: pow2_terms(6) = (4, 2), pow2_terms(4) = (4,), and one
// term for each -1
template <int SH>
__host__ __device__ constexpr int nterm(int k)
{
    return SH == 7 && k == 0 ? 2 : 1;
}

__device__ __forceinline__ void df_update(
    float xh, float xl, float e, float& oh, float& ol)
{
    // two_sum(xh, e)
    float s = __fadd_rn(xh, e);
    float bb = __fsub_rn(s, xh);
    float err = __fadd_rn(__fsub_rn(xh, __fsub_rn(s, bb)), __fsub_rn(e, bb));
    float e2 = __fadd_rn(err, xl);
    // quick_two_sum(s, e2)
    float s2 = __fadd_rn(s, e2);
    oh = s2;
    ol = __fsub_rn(e2, __fsub_rn(s2, s));
}

// acc <- acc - p * (vh, vl): exact products, compensated sum
__device__ __forceinline__ void df_sub_term(
    float& acch, float& accl, float p, float vh, float vl)
{
    const float np = -p;
    const float th = __fmul_rn(np, vh);
    const float tl = __fmul_rn(np, vl);
    float s = __fadd_rn(acch, th);
    float bb = __fsub_rn(s, acch);
    float err = __fadd_rn(__fsub_rn(acch, __fsub_rn(s, bb)), __fsub_rn(th, bb));
    err = __fadd_rn(err, __fadd_rn(accl, tl));
    acch = __fadd_rn(s, err);
    accl = __fsub_rn(err, __fsub_rn(acch, s));
}

// acc <- acc - p * x'[c + off] over the terms p of the taps from K on, the
// offsets and term counts of the compile-time operator SH (recursion on
// template arguments keeps them constants).
template <int SH, int K>
__device__ __forceinline__ void sum_terms(
    float& acch, float& accl, const float* terms, const float* hm,
    const float* h0, const float* hp, const float* lm, const float* l0,
    const float* lp, int c)
{
    if constexpr (K < SH) {
        constexpr int oz = off<SH>(K, 0);
        constexpr int d = off<SH>(K, 1) * SX + off<SH>(K, 2);
        const float* ph = oz < 0 ? hm : (oz > 0 ? hp : h0);
        const float* pl = oz < 0 ? lm : (oz > 0 ? lp : l0);
        const float vh = ph[c + d], vl = pl[c + d];
#pragma unroll
        for (int j = 0; j < nterm<SH>(K); ++j)
            df_sub_term(acch, accl, terms[K * MAXT + j], vh, vl);
        sum_terms<SH, K + 1>(acch, accl, terms, hm, h0, hp, lm, l0, lp, c);
    }
}

// What one thread loads of a plane: a 16-byte piece of a row, or one halo
// cell.  Out-of-domain values are zero.
struct PlaneLoad {
    float4 h, l, e;
};

__device__ __forceinline__ void load_piece(
    PlaneLoad& v, const float* __restrict__ xh, const float* __restrict__ xl,
    const float* __restrict__ e, const DfHalo& hl, int gz, int y0, int x0,
    int nz, int ny, int nx, bool vec_ok)
{
    const int tid = threadIdx.x;
    v.h = v.l = v.e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (tid >= NLOAD) return;
    // plane gz of the three grids: the slab's own, a received one, or none
    if (gz < 0 || gz >= nz) {
        if (gz != -1 && gz != nz) return;
        const bool lo = gz == -1;
        xh = lo ? hl.lh : hl.uh;
        xl = lo ? hl.ll : hl.ul;
        e = lo ? hl.le : hl.ue;
        if (xh == nullptr) return;
        gz = 0;
    }
    int ly, gx, width;
    if (tid < NVEC) {
        ly = tid / (TX / 4);
        gx = x0 + 4 * (tid - ly * (TX / 4));
        width = 4;
    } else {
        const int i = tid - NVEC;
        ly = i >> 1;
        gx = (i & 1) ? x0 + TX : x0 - 1;
        width = 1;
    }
    const int gy = y0 + ly - 1;
    if (gy < 0 || gy >= ny) return;
    const size_t row = ((size_t)gz * ny + gy) * nx;
    if (width == 4 && vec_ok && gx + 3 < nx) {
        v.h = *reinterpret_cast<const float4*>(xh + row + gx);
        v.l = *reinterpret_cast<const float4*>(xl + row + gx);
        v.e = *reinterpret_cast<const float4*>(e + row + gx);
        return;
    }
    float* ph = &v.h.x;
    float* pl = &v.l.x;
    float* pe = &v.e.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (j >= width) break;
        const int x = gx + j;
        if (x >= 0 && x < nx) {
            ph[j] = xh[row + x];
            pl[j] = xl[row + x];
            pe[j] = e[row + x];
        }
    }
}

// The loaded piece, df-updated, into the window plane (sh, sl).
__device__ __forceinline__ void store_piece(
    const PlaneLoad& v, float* sh, float* sl)
{
    const int tid = threadIdx.x;
    if (tid >= NLOAD) return;
    int c, width;
    if (tid < NVEC) {
        const int ly = tid / (TX / 4);
        c = ly * SX + 1 + 4 * (tid - ly * (TX / 4));
        width = 4;
    } else {
        const int i = tid - NVEC;
        c = (i >> 1) * SX + ((i & 1) ? SX - 1 : 0);
        width = 1;
    }
    const float* ph = &v.h.x;
    const float* pl = &v.l.x;
    const float* pe = &v.e.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (j >= width) break;
        float h, l;
        df_update(ph[j], pl[j], pe[j], h, l);
        sh[c + j] = h;
        sl[c + j] = l;
    }
}

template <int SH>
__global__ void __launch_bounds__(THREADS) df_update_residual_kernel(
    DfStencil st, const float* __restrict__ xh, const float* __restrict__ xl,
    const float* __restrict__ e, const float* __restrict__ bh,
    const float* __restrict__ bl, float* __restrict__ oxh,
    float* __restrict__ oxl, float* __restrict__ orh,
    float* __restrict__ partials, const DfHalo hb, int nz, int ny, int nx,
    int zc, int pstride)
{
    __shared__ float wh[3 * SP];
    __shared__ float wl[3 * SP];
    __shared__ float wsum[THREADS / 32];

    const int tid = threadIdx.x;
    const int lx = tid % TX, ly = tid / TX;
    // the member (batched form) and its z-chunk
    const int nzc = (nz + zc - 1) / zc;
    const int mb = blockIdx.z / nzc, zb = blockIdx.z - mb * nzc;
    {
        const size_t mo = (size_t)mb * nz * ny * nx;
        xh += mo; xl += mo; e += mo; bh += mo; bl += mo;
        oxh += mo; oxl += mo; orh += mo;
    }
    // the member's received planes (K2hb: a plane of (ny, nx) a member)
    DfHalo hl = hb;
    {
        const size_t po = (size_t)mb * ny * nx;
        if (hl.lh != nullptr) { hl.lh += po; hl.ll += po; hl.le += po; }
        if (hl.uh != nullptr) { hl.uh += po; hl.ul += po; hl.ue += po; }
    }
    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
    const int z0 = zb * zc, z1 = min(z0 + zc, nz);
    const int gx = x0 + lx, gy = y0 + ly;
    const bool own = gx < nx && gy < ny;
    const bool vec_ok = (nx & 3) == 0 &&
        ((((uintptr_t)xh) | ((uintptr_t)xl) | ((uintptr_t)e) | ((uintptr_t)hl.lh) |
          ((uintptr_t)hl.ll) | ((uintptr_t)hl.le) | ((uintptr_t)hl.uh) |
          ((uintptr_t)hl.ul) | ((uintptr_t)hl.ue)) & 15) == 0;
    // window slot of plane z: (z - z0 + 1) % 3
    auto slot = [&](int z) { return ((z - z0 + 1) % 3) * SP; };

    const int c = (ly + 1) * SX + (lx + 1);
    float sq = 0.0f;
    if constexpr (SH == 5) {
        // a 2D operator lifted to (1, ny, nx): no tap leaves the plane, so
        // each plane is loaded, updated and used alone (no z-halo)
        PlaneLoad v;
        load_piece(v, xh, xl, e, hl, z0, y0, x0, nz, ny, nx, vec_ok);
        for (int z = z0; z < z1; ++z) {
            store_piece(v, wh, wl);
            if (z + 1 < z1) load_piece(v, xh, xl, e, hl, z + 1, y0, x0, nz, ny, nx, vec_ok);
            __syncthreads();
            if (own) {
                const size_t g = ((size_t)z * ny + gy) * nx + gx;
                float acch = bh[g], accl = bl[g];
                sum_terms<SH, 0>(acch, accl, st.terms, wh, wh, wh, wl, wl, wl, c);
                oxh[g] = wh[c];
                oxl[g] = wl[c];
                orh[g] = acch;
                sq += acch * acch;
            }
            __syncthreads();
        }
    } else {
        // x_hi, x_lo, e of the planes z + 1 and z + 2, and b of z and z + 1, in
        // registers: two planes of loads in flight while plane z is computed
        PlaneLoad v, v2;
        load_piece(v, xh, xl, e, hl, z0 - 1, y0, x0, nz, ny, nx, vec_ok);
        store_piece(v, wh + slot(z0 - 1), wl + slot(z0 - 1));
        load_piece(v, xh, xl, e, hl, z0, y0, x0, nz, ny, nx, vec_ok);
        store_piece(v, wh + slot(z0), wl + slot(z0));
        load_piece(v, xh, xl, e, hl, z0 + 1, y0, x0, nz, ny, nx, vec_ok);
        load_piece(v2, xh, xl, e, hl, z0 + 2, y0, x0, nz, ny, nx, vec_ok);
        float nbh = 0.0f, nbl = 0.0f, nbh2 = 0.0f, nbl2 = 0.0f;
        if (own) {
            const size_t g = ((size_t)z0 * ny + gy) * nx + gx;
            nbh = bh[g];
            nbl = bl[g];
            if (z0 + 1 < z1) {
                nbh2 = bh[g + (size_t)ny * nx];
                nbl2 = bl[g + (size_t)ny * nx];
            }
        }

        for (int z = z0; z < z1; ++z) {
            // plane z + 1 into the window; plane z + 2 and b of plane z + 1 on
            // their way while plane z is computed
            store_piece(v, wh + slot(z + 1), wl + slot(z + 1));
            v = v2;
            if (z + 3 <= z1) load_piece(v2, xh, xl, e, hl, z + 3, y0, x0, nz, ny, nx, vec_ok);
            float acch = nbh, accl = nbl;
            nbh = nbh2;
            nbl = nbl2;
            if (own && z + 2 < z1) {
                const size_t g = ((size_t)(z + 2) * ny + gy) * nx + gx;
                nbh2 = bh[g];
                nbl2 = bl[g];
            }
            __syncthreads();
            if (own) {
                const float* hm = wh + slot(z - 1);
                const float* h0 = wh + slot(z);
                const float* hp = wh + slot(z + 1);
                const float* lm = wl + slot(z - 1);
                const float* l0 = wl + slot(z);
                const float* lp = wl + slot(z + 1);
                if constexpr (SH > 0) {
                    sum_terms<SH, 0>(acch, accl, st.terms, hm, h0, hp, lm, l0, lp, c);
                } else {
                    for (int k = 0; k < st.K; ++k) {
                        const int oz = st.oz[k];
                        const int d = st.oy[k] * SX + st.ox[k];
                        const float* ph = oz < 0 ? hm : (oz > 0 ? hp : h0);
                        const float* pl = oz < 0 ? lm : (oz > 0 ? lp : l0);
                        const float vh = ph[c + d], vl = pl[c + d];
                        for (int j = 0; j < st.nterms[k]; ++j)
                            df_sub_term(acch, accl, st.terms[k * MAXT + j], vh, vl);
                    }
                }
                const size_t g = ((size_t)z * ny + gy) * nx + gx;
                oxh[g] = h0[c];
                oxl[g] = l0[c];
                orh[g] = acch;
                sq += acch * acch;
            }
            __syncthreads();
        }
    }

    if (partials != nullptr) {
        for (int o = 16; o > 0; o >>= 1)
            sq += __shfl_xor_sync(0xffffffffu, sq, o);
        if ((tid & 31) == 0) wsum[tid >> 5] = sq;
        __syncthreads();
        if (tid == 0) {
            float t = 0.0f;
            for (int w = 0; w < THREADS / 32; ++w) t += wsum[w];
            partials[(size_t)mb * pstride +
                     ((size_t)zb * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = t;
        }
    }
}

// Planes a block owns: enough z-chunks that the launch has about
// TARGET_BLOCKS blocks.
int z_chunk(int nz, int ny, int nx)
{
    const long tiles = (long)((nx + TX - 1) / TX) * ((ny + TY - 1) / TY);
    long want = (TARGET_BLOCKS + tiles - 1) / tiles;
    if (want > nz) want = nz;
    if (want < 1) want = 1;
    return (int)((nz + want - 1) / want);
}

// Which compile-time body the stencil takes: 7 (3D Poisson), 5 (its 2D
// lift), or 0 (generic).
int shape_of(const DfStencil& st)
{
    const int shapes[2] = {7, 5};
    for (int sh : shapes) {
        if (st.K != sh) continue;
        bool same = true;
        for (int k = 0; k < st.K && same; ++k) {
            const int nd = sh == 7 ? 3 : 2;
            same = st.oz[k] == star_off(k, 0, nd) && st.oy[k] == star_off(k, 1, nd) &&
                   st.ox[k] == star_off(k, 2, nd) &&
                   st.nterms[k] == (sh == 7 && k == 0 ? 2 : 1);
        }
        if (same) return sh;
    }
    return 0;
}

template <int SH>
void launch(dim3 grid, cudaStream_t stream, const DfStencil& st,
            const float* xh, const float* xl, const float* e, const float* bh,
            const float* bl, float* oxh, float* oxl, float* orh,
            float* partials, const DfHalo& hl, int nz, int ny, int nx, int zc,
            int pstride)
{
    df_update_residual_kernel<SH><<<grid, THREADS, 0, stream>>>(
        st, xh, xl, e, bh, bl, oxh, oxl, orh, partials, hl, nz, ny, nx, zc, pstride);
}

}  // namespace

// Number of partial sums df_update_residual writes for a grid of this size.
extern "C" int omg_df_num_partials(int nz, int ny, int nx)
{
    if (nz < 1 || ny < 1 || nx < 1) return 0;
    const int zc = z_chunk(nz, ny, nx);
    return ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY) * ((nz + zc - 1) / zc);
}

// Launches the outer step on `stream`.  offs (K*3 ints), nterms (K ints)
// and terms (K*3 floats, tap k's terms at [3k, 3k + nterms[k])) are host
// pointers; everything else is a device pointer to (nb, nz, ny, nx)
// float32, except partials: nb blocks of omg_df_num_partials floats,
// pstride apart (>= omg_df_num_partials), or null for no norm.
// Outputs must not alias inputs (neighbours read the old x).  lh, ll, le /
// uh, ul, ue: the halo form's received (ny, nx) planes of x_hi, x_lo, e below
// and above the slab, (nb, ny, nx) each on a batch, or all null.  Returns 0, a CUDA
// error code, or -1 for arguments the kernel does not take.
extern "C" int omg_df_update_residual(
    const int* offs, const int* nterms, const float* terms, int K,
    const float* xh, const float* xl, const float* e, const float* bh,
    const float* bl, float* oxh, float* oxl, float* orh, float* partials,
    const float* lh, const float* ll, const float* le, const float* uh,
    const float* ul, const float* ue, int nz, int ny, int nx, int nb,
    int pstride, void* stream_ptr)
{
    if (K < 1 || K > MAXK || nz < 1 || ny < 1 || nx < 1 || nb < 1) return -1;
    const DfHalo hl = {lh, ll, le, uh, ul, ue};
    if ((lh == nullptr) != (ll == nullptr) || (lh == nullptr) != (le == nullptr) ||
        (uh == nullptr) != (ul == nullptr) || (uh == nullptr) != (ue == nullptr))
        return -1;
    if (partials != nullptr && pstride < omg_df_num_partials(nz, ny, nx)) return -1;
    DfStencil st;
    st.K = K;
    for (int k = 0; k < MAXK; ++k) {
        st.oz[k] = st.oy[k] = st.ox[k] = 0;
        st.nterms[k] = 0;
        for (int j = 0; j < MAXT; ++j) st.terms[k * MAXT + j] = 0.0f;
    }
    for (int k = 0; k < K; ++k) {
        st.oz[k] = offs[3 * k];
        st.oy[k] = offs[3 * k + 1];
        st.ox[k] = offs[3 * k + 2];
        if (st.oz[k] < -1 || st.oz[k] > 1 || st.oy[k] < -1 || st.oy[k] > 1 ||
            st.ox[k] < -1 || st.ox[k] > 1)
            return -1;
        if (nterms[k] < 0 || nterms[k] > MAXT) return -1;
        st.nterms[k] = nterms[k];
        for (int j = 0; j < nterms[k]; ++j)
            st.terms[k * MAXT + j] = terms[k * MAXT + j];
    }
    const int zc = z_chunk(nz, ny, nx);
    const long zblocks = (long)((nz + zc - 1) / zc) * nb;
    if (zblocks > 65535) return -1;
    dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (unsigned)zblocks);
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    switch (shape_of(st)) {
    case 7: launch<7>(grid, stream, st, xh, xl, e, bh, bl, oxh, oxl, orh, partials, hl, nz, ny, nx, zc, pstride); break;
    case 5: launch<5>(grid, stream, st, xh, xl, e, bh, bl, oxh, oxl, orh, partials, hl, nz, ny, nx, zc, pstride); break;
    default: launch<0>(grid, stream, st, xh, xl, e, bh, bl, oxh, oxl, orh, partials, hl, nz, ny, nx, zc, pstride); break;
    }
    return (int)cudaGetLastError();
}
