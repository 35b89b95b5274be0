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
// What the design does (the simple, right version):
//   * One launch is one pass, always out of place: on 27-point levels points
//     of one colour are coupled, so an in-place colour update would race
//     between blocks.  Two half-sweeps ping-pong between buffers.
//   * A thread owns a pair of x-neighbours of one row; b, the centre of x
//     and the output move 8 bytes a lane where the rows are aligned for it.
//     A neighbour is read straight from device memory through the read-only
//     cache with a bounds check per tap; a neighbour outside the domain
//     contributes nothing (the Dirichlet zero).  No shared-memory tile: the
//     27 reads of a point's neighbourhood hit L1/L2.
//   * A red/black pass sums taps only for the point of the pair that has the
//     pass's colour, and reads the coefficient grids only there.  It still
//     touches every 32-byte sector of every coefficient grid: half of each
//     sector is fetched and not used.
//   * Cornered operators need no fix-up pass: the tap of point i for offset
//     k is one row of an at most 8-row table chosen by which coordinates of
//     i are 0 (as in fused_stages.cu).  The table sits in shared memory.
//     Region rows divide by their own diagonal, interior rows multiply by
//     the reciprocal of the interior diagonal.
//   * The tap count is a compile-time constant for 7 and 27 taps; any other
//     count up to 27 takes a generic instantiation.
//
// Rounding: the sum runs in the order of the offsets list (the diagonal is
// skipped in a red/black pass) and the update multiplies by 1/diag, as the
// TPU kernels do; nvcc may contract a*b+c into a fused multiply-add, which
// the plain PyTorch version does not, so they agree to a few ulp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 27;
constexpr int BX = 32, BY = 8;  // threads of a block: 64 x-points by 8 rows

enum Mode { MODE_JACOBI = 0, MODE_RB = 1, MODE_RESIDUAL = 2 };

struct Sweep {
    int K;
    int di;             // index of the (0,0,0) offset
    int oz[MAXK], oy[MAXK], ox[MAXK];
    int rowmap[8];      // mask of zero coordinates -> region-table row, -1 = interior
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

// coef: VARY ? (K, nz, ny, nx) coefficient grids : (K,) interior taps.
// table: region rows (n_regions, K) of a cornered operator, or nullptr.
template <bool VARY, int MODE, int KT>
__global__ void __launch_bounds__(BX * BY) half_sweep_kernel(
    const Sweep st, const float* __restrict__ coef,
    const float* __restrict__ table, const float* __restrict__ b,
    const float* __restrict__ x, float* __restrict__ out,
    int nz, int ny, int nx, float omega, int color, int vec)
{
    constexpr int KN = KT > 0 ? KT : MAXK;
    // taps[m * MAXK + k]: tap of offset k for a point whose zero-coordinate
    // mask is m (bit 0: z == 0, bit 1: y == 0, bit 2: x == 0)
    __shared__ float taps[VARY ? 1 : 8 * MAXK];
    if (!VARY) {
        const int tid = threadIdx.y * BX + threadIdx.x;
        for (int i = tid; i < 8 * st.K; i += BX * BY) {
            const int m = i / st.K, k = i - m * st.K;
            const int row = st.rowmap[m];
            taps[m * MAXK + k] = row < 0 ? coef[k] : table[row * st.K + k];
        }
        __syncthreads();
    }

    const int gx = (blockIdx.x * BX + threadIdx.x) * 2;
    const int gy = blockIdx.y * BY + threadIdx.y;
    const int gz = blockIdx.z;
    if (gx >= nx || gy >= ny) return;

    const size_t n = (size_t)nz * ny * nx;
    const size_t c = ((size_t)gz * ny + gy) * nx + gx;
    const bool two = gx + 1 < nx;
    // which points of the pair get a sum: in a red/black pass only the one
    // whose parity is the pass's colour
    bool do0 = true, do1 = two;
    if (MODE == MODE_RB) {
        do0 = ((gz + gy + gx) & 1) == color;
        do1 = two && !do0;
    }
    int m0 = 0, m1 = 0;
    if (!VARY) {
        m1 = (gz == 0 ? 1 : 0) | (gy == 0 ? 2 : 0);
        m0 = m1 | (gx == 0 ? 4 : 0);
    }
    const bool pair_coef = VARY && MODE != MODE_RB && vec;

    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
        if (KT == 0 && k >= st.K) break;
        if (MODE == MODE_RB && k == st.di) continue;
        const int zz = gz + st.oz[k], yy = gy + st.oy[k];
        if (zz < 0 || zz >= nz || yy < 0 || yy >= ny) continue;
        const float* row = x + ((size_t)zz * ny + yy) * nx;
        const int x0 = gx + st.ox[k], x1 = x0 + 1;
        float a0 = 0.0f, a1 = 0.0f;
        if (VARY) {
            const float* ck = coef + (size_t)k * n + c;
            if (pair_coef) {
                const float2 t = __ldg(reinterpret_cast<const float2*>(ck));
                a0 = t.x;
                a1 = t.y;
            } else {
                if (do0) a0 = __ldg(ck);
                if (do1) a1 = __ldg(ck + 1);
            }
        } else {
            a0 = taps[m0 * MAXK + k];
            a1 = taps[m1 * MAXK + k];
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

    bool int0 = true, int1 = true;
    float inv0 = 0.0f, inv1 = 0.0f, diag0 = 1.0f, diag1 = 1.0f;
    if (MODE != MODE_RESIDUAL) {
        if (VARY) {
            const float* cd = coef + (size_t)st.di * n + c;
            if (do0) inv0 = 1.0f / __ldg(cd);
            if (do1) inv1 = 1.0f / __ldg(cd + 1);
        } else {
            int0 = st.rowmap[m0] < 0;
            int1 = st.rowmap[m1] < 0;
            inv0 = inv1 = 1.0f / taps[st.di];
            diag0 = taps[m0 * MAXK + st.di];
            diag1 = taps[m1 * MAXK + st.di];
        }
    }
    const float o0 = finish<MODE>(do0, acc0, b0, xc0, int0, inv0, diag0, omega);
    const float o1 = finish<MODE>(do1, acc1, b1, xc1, int1, inv1, diag1, omega);
    if (vec) {
        *reinterpret_cast<float2*>(out + c) = make_float2(o0, o1);
    } else {
        out[c] = o0;
        if (two) out[c + 1] = o1;
    }
}

template <bool VARY, int MODE>
void launch_by_taps(
    const Sweep& st, const float* coef, const float* table, const float* b,
    const float* x, float* out, int nz, int ny, int nx, float omega,
    int color, int vec, cudaStream_t s)
{
    const dim3 block(BX, BY, 1);
    const dim3 grid((nx + 2 * BX - 1) / (2 * BX), (ny + BY - 1) / BY, nz);
    if (st.K == 7)
        half_sweep_kernel<VARY, MODE, 7><<<grid, block, 0, s>>>(
            st, coef, table, b, x, out, nz, ny, nx, omega, color, vec);
    else if (st.K == 27)
        half_sweep_kernel<VARY, MODE, 27><<<grid, block, 0, s>>>(
            st, coef, table, b, x, out, nz, ny, nx, omega, color, vec);
    else
        half_sweep_kernel<VARY, MODE, 0><<<grid, block, 0, s>>>(
            st, coef, table, b, x, out, nz, ny, nx, omega, color, vec);
}

template <bool VARY>
int launch_by_mode(
    int mode, const Sweep& st, const float* coef, const float* table,
    const float* b, const float* x, float* out, int nz, int ny, int nx,
    float omega, int color, int vec, cudaStream_t s)
{
    switch (mode) {
    case MODE_JACOBI:
        launch_by_taps<VARY, MODE_JACOBI>(
            st, coef, table, b, x, out, nz, ny, nx, omega, color, vec, s);
        return 0;
    case MODE_RB:
        launch_by_taps<VARY, MODE_RB>(
            st, coef, table, b, x, out, nz, ny, nx, omega, color, vec, s);
        return 0;
    case MODE_RESIDUAL:
        launch_by_taps<VARY, MODE_RESIDUAL>(
            st, coef, table, b, x, out, nz, ny, nx, omega, color, vec, s);
        return 0;
    }
    return -2;
}

}  // namespace

// One pass.  offs: K*3 ints; rowmap: 8 ints (all -1 without a region table).
// vary != 0: coef is (K, nz, ny, nx) and table/rowmap are not read.
// Returns 0, a negative code of its own (-1: stencil not taken, -2: bad mode
// or grid, -3: out aliases an input) or the CUDA error of the launch.
extern "C" int omg_half_sweep(
    const float* coef, const float* table, const int* offs, int K,
    const int* rowmap, int vary, int mode, float omega, int color,
    const float* b, const float* x, float* out, int nz, int ny, int nx,
    void* stream)
{
    if (K < 1 || K > MAXK) return -1;
    Sweep st;
    st.K = K;
    st.di = -1;
    for (int k = 0; k < MAXK; ++k) st.oz[k] = st.oy[k] = st.ox[k] = 0;
    for (int k = 0; k < K; ++k) {
        const int oz = offs[3 * k], oy = offs[3 * k + 1], ox = offs[3 * k + 2];
        if (oz < -1 || oz > 1 || oy < -1 || oy > 1 || ox < -1 || ox > 1)
            return -1;
        if (oz == 0 && oy == 0 && ox == 0) st.di = k;
        st.oz[k] = oz;
        st.oy[k] = oy;
        st.ox[k] = ox;
    }
    if (st.di < 0) return -1;
    for (int m = 0; m < 8; ++m) {
        st.rowmap[m] = vary ? -1 : rowmap[m];
        if (st.rowmap[m] >= 0 && table == nullptr) return -1;
    }
    if (nz < 1 || ny < 1 || nx < 1 || nz > 65535 || (ny + BY - 1) / BY > 65535)
        return -2;
    if (out == x || out == b) return -3;
    const int vec = (nx % 2 == 0)
        && ((((uintptr_t)b) | ((uintptr_t)x) | ((uintptr_t)out)
             | ((uintptr_t)coef)) & 7) == 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int rc = vary
        ? launch_by_mode<true>(mode, st, coef, table, b, x, out, nz, ny, nx,
                               omega, color, vec, s)
        : launch_by_mode<false>(mode, st, coef, table, b, x, out, nz, ny, nx,
                                omega, color, vec, s);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
}
