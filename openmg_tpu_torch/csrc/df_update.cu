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
//   * A block owns a 4x8x32 tile and forms the UPDATED pair x' for the tile
//     and its one-point halo in shared memory, so x_hi, x_lo and e are
//     fetched about 1.9 times per point instead of K times, and the
//     neighbour's update is not recomputed per tap.  Out-of-domain points
//     hold (0, 0): Dirichlet truncation.
//   * The compensated sequences are written with __fadd_rn / __fsub_rn /
//     __fmul_rn, which nvcc neither reassociates nor contracts into fused
//     multiply-adds, so x_hi', x_lo' and r_hi equal the plain PyTorch
//     version bit for bit.
//   * With emit_norm each block reduces r_hi^2 in a fixed order (warp
//     shuffles, then one thread over the warps) and writes one partial;
//     the caller sums the partials.  No float atomics, so two runs give the
//     same bits.  The contract is that the partials sum to ||r_hi||^2; their
//     number and layout are this kernel's own.

#include <cuda_runtime.h>

namespace {

constexpr int MAXK = 27;
constexpr int MAXT = 3;  // power-of-two terms per tap
constexpr int TX = 32, TY = 8, TZ = 4;
constexpr int SX = TX + 2, SY = TY + 2, SZ = TZ + 2;
constexpr int THREADS = TX * TY;

struct DfStencil {
    int K;
    int oz[MAXK], oy[MAXK], ox[MAXK];
    int nterms[MAXK];
    float terms[MAXK * MAXT];
};

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

__global__ void __launch_bounds__(THREADS) df_update_residual_kernel(
    DfStencil st, const float* __restrict__ xh, const float* __restrict__ xl,
    const float* __restrict__ e, const float* __restrict__ bh,
    const float* __restrict__ bl, float* __restrict__ oxh,
    float* __restrict__ oxl, float* __restrict__ orh,
    float* __restrict__ partials, int nz, int ny, int nx)
{
    __shared__ float sh[SZ * SY * SX];
    __shared__ float sl[SZ * SY * SX];
    __shared__ float wsum[THREADS / 32];

    const int tid = threadIdx.x;
    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;

    for (int i = tid; i < SZ * SY * SX; i += THREADS) {
        int lz = i / (SY * SX);
        int rem = i - lz * (SY * SX);
        int ly = rem / SX, lx = rem - ly * SX;
        int gz = z0 + lz - 1, gy = y0 + ly - 1, gx = x0 + lx - 1;
        float h = 0.0f, l = 0.0f;
        if (gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
            size_t g = ((size_t)gz * ny + gy) * nx + gx;
            df_update(xh[g], xl[g], e[g], h, l);
        }
        sh[i] = h;
        sl[i] = l;
    }
    __syncthreads();

    const int lx = tid % TX, ly = tid / TX;
    const int gx = x0 + lx, gy = y0 + ly;
    float sq = 0.0f;
    if (gx < nx && gy < ny) {
        for (int lz = 0; lz < TZ; ++lz) {
            const int gz = z0 + lz;
            if (gz >= nz) break;
            const int c = ((lz + 1) * SY + (ly + 1)) * SX + (lx + 1);
            const size_t g = ((size_t)gz * ny + gy) * nx + gx;
            float acch = bh[g], accl = bl[g];
            for (int k = 0; k < st.K; ++k) {
                const int d = (st.oz[k] * SY + st.oy[k]) * SX + st.ox[k];
                const float vh = sh[c + d], vl = sl[c + d];
                for (int j = 0; j < st.nterms[k]; ++j) {
                    const float np = -st.terms[k * MAXT + j];
                    // acc <- acc - p * x': exact products, compensated sum
                    const float th = __fmul_rn(np, vh);
                    const float tl = __fmul_rn(np, vl);
                    float s = __fadd_rn(acch, th);
                    float bb = __fsub_rn(s, acch);
                    float err = __fadd_rn(
                        __fsub_rn(acch, __fsub_rn(s, bb)), __fsub_rn(th, bb));
                    err = __fadd_rn(err, __fadd_rn(accl, tl));
                    acch = __fadd_rn(s, err);
                    accl = __fsub_rn(err, __fsub_rn(acch, s));
                }
            }
            oxh[g] = sh[c];
            oxl[g] = sl[c];
            orh[g] = acch;
            sq += acch * acch;
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
            partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                     blockIdx.x] = t;
        }
    }
}

}  // namespace

// Number of partial sums df_update_residual writes for a grid of this size.
extern "C" int omg_df_num_partials(int nz, int ny, int nx)
{
    return ((nx + TX - 1) / TX) * ((ny + TY - 1) / TY) * ((nz + TZ - 1) / TZ);
}

// Launches the outer step on `stream`.  offs (K*3 ints), nterms (K ints)
// and terms (K*3 floats, tap k's terms at [3k, 3k + nterms[k])) are host
// pointers; everything else is a device pointer to (nz, ny, nx) float32,
// except partials: (omg_df_num_partials,) float32, or null for no norm.
// Outputs must not alias inputs (neighbours read the old x).  Returns 0, a
// CUDA error code, or -1 for arguments the kernel does not take.
extern "C" int omg_df_update_residual(
    const int* offs, const int* nterms, const float* terms, int K,
    const float* xh, const float* xl, const float* e, const float* bh,
    const float* bl, float* oxh, float* oxl, float* orh, float* partials,
    int nz, int ny, int nx, void* stream_ptr)
{
    if (K < 1 || K > MAXK || nz < 1 || ny < 1 || nx < 1) return -1;
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
    dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + TZ - 1) / TZ);
    df_update_residual_kernel<<<grid, THREADS, 0, (cudaStream_t)stream_ptr>>>(
        st, xh, xl, e, bh, bl, oxh, oxl, orh, partials, nz, ny, nx);
    return (int)cudaGetLastError();
}
