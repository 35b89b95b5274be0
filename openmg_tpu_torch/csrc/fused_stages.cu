// Fused V-cycle level visit for constant and cornered radius-1 stencils.
//
// Replaces the TPU kernel openmg_tpu/ops/fused.py::fused_stages_const_3d
// (body _fused_kernel): S smoothing stages (weighted-Jacobi step or
// red/black half-sweep) of a 3D stencil with K <= 27 taps, optionally
// started from zero (reads only b) or from x + P*ec (prolongation formed on
// load), optionally followed by the residual b - A x or by its restriction
// bc = R (b - A x).
//
// What bounds it on an H100: bytes.  A stage does at most 2*27 flops per
// point against 12 bytes of device-memory traffic (b and x read, x written),
// far below the card's flop:byte ratio, so the least time is the traffic
// divided by the memory rate.
//
// What the design does about it (this is the simple, right version):
//   * A block owns a tile of 8 x 8 x 64 points; it stages the tile of x with
//     a one-point halo in shared memory, so each x value is fetched from
//     device memory (or L2) about 1.6 times per stage, not K times, and the
//     K-tap sum reads shared memory only.  A thread owns a pair of
//     x-neighbours: rows are loaded and stored 8 bytes a lane, and a
//     red/black stage sums taps only for the point of the pair that has the
//     stage's colour.  The tap count is a compile-time constant for the two
//     stencils of the Poisson hierarchy (7 and 27 taps), and interior points
//     keep their taps in registers.
//   * Blocks run in no order, so every stage is its own launch on the
//     caller's stream and stages ping-pong between two buffers: a stage
//     reads only the pre-stage iterate.  That matters on the 27-point
//     levels, where a red point has red neighbours (offsets with an even
//     coordinate sum such as (1,1,0)) and an in-place colour update would
//     race.  Fusing the S stages into one launch with an S-deep halo is a
//     later step.
//   * Cornered levels need no fix-up passes: by the operator's definition
//     the tap of point i for offset k is one row of an at most 8-row table,
//     chosen by which of i's coordinates are 0.  The table (<= 8x27 floats)
//     is copied to shared memory and a thread picks its row from three
//     comparisons.  The taps are read from device memory by the kernel, so
//     the host never waits for them.
//   * The restriction never writes the fine residual: the last kernel
//     computes b - A x for the fine points under its coarse tile (plus the
//     one-point halo the linear taps need) in shared memory and writes only
//     the (n/2)^3 coarse array.  The prolongation never writes P*ec: the
//     first stage adds it while it loads its tile.
//   * Dirichlet truncation: a neighbour outside the domain contributes
//     zero on all three axes (the halo is zero-filled there).
//
// Rounding: region rows divide by the region's diagonal, interior rows
// multiply by the reciprocal of the interior diagonal, as the TPU kernel
// does.  Sums run in the order of the offsets list; nvcc may contract
// a*b+c into one fused multiply-add, which the plain PyTorch version does
// not, so the two agree to a few ulp (the stated tolerance is
// 2e-6 * max|ref|), not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXK = 27;

// stage tile: 8 x 8 x 64 points; a thread owns a pair of x-neighbours in
// one row and walks the 8 planes
constexpr int TX = 64, TY = 8, TZ = 8;
constexpr int SX = TX + 2, SY = TY + 2, SZ = TZ + 2;
constexpr int STAGE_THREADS = 32 * TY;

constexpr int CX = 16, CY = 4, CZ = 4;           // coarse tile of the restriction
constexpr int XE = 2 * CX + 3, YE = 2 * CY + 3, ZE = 2 * CZ + 3;   // x region
constexpr int XR = 2 * CX + 1, YR = 2 * CY + 1, ZR = 2 * CZ + 1;   // r region
constexpr int RESTRICT_THREADS = CX * CY * CZ;

enum Mode { MODE_JACOBI = 0, MODE_RB = 1, MODE_RESIDUAL = 2, MODE_ADD = 3 };

struct Stencil {
    int K;
    int di;             // index of the (0,0,0) offset
    int ds[MAXK];       // offset k as an index step in the stage tile
    int dr[MAXK];       // ... and in the restriction's x region
    int rowmap[8];      // mask of zero coordinates -> region-table row, -1 = interior
};

// taps[m * MAXK + k]: tap of offset k for a point whose zero-coordinate mask
// is m (bit 0: z == 0, bit 1: y == 0, bit 2: x == 0).
__device__ __forceinline__ void load_taps(
    float* taps, const Stencil& st, const float* __restrict__ values,
    const float* __restrict__ table, int tid, int nthreads)
{
    for (int i = tid; i < 8 * st.K; i += nthreads) {
        int m = i / st.K, k = i - m * st.K;
        int row = st.rowmap[m];
        taps[m * MAXK + k] = row < 0 ? values[k] : table[row * st.K + k];
    }
}

// (P ec)(fz, fy, fx) for separable radius-1 taps: weight pw[t + 1] couples
// fine index f = 2c + t with coarse index c.  Nested z inside y inside x,
// the order of the plain version (axis 0 first).
__device__ __forceinline__ float prolong_at(
    const float* __restrict__ ec, int fz, int fy, int fx,
    int ncz, int ncy, int ncx, float wm, float w0, float wp)
{
    int cz[2], cy[2], cx[2];
    float wz[2], wy[2], wx[2];
    int nzt, nyt, nxt;
#define OMG_AXIS_TAPS(f, c, w, n)                                       \
    if ((f & 1) == 0) { c[0] = f >> 1; w[0] = w0; n = 1; }              \
    else {                                                              \
        c[0] = (f + 1) >> 1; w[0] = wm; c[1] = (f - 1) >> 1; w[1] = wp; \
        n = 2;                                                          \
    }
    OMG_AXIS_TAPS(fz, cz, wz, nzt)
    OMG_AXIS_TAPS(fy, cy, wy, nyt)
    OMG_AXIS_TAPS(fx, cx, wx, nxt)
#undef OMG_AXIS_TAPS
    float sx = 0.0f;
    for (int a = 0; a < nxt; ++a) {
        if (cx[a] >= ncx || wx[a] == 0.0f) continue;
        float sy = 0.0f;
        for (int b = 0; b < nyt; ++b) {
            if (cy[b] >= ncy || wy[b] == 0.0f) continue;
            float sz = 0.0f;
            for (int c = 0; c < nzt; ++c) {
                if (cz[c] >= ncz || wz[c] == 0.0f) continue;
                sz += wz[c] * ec[((size_t)cz[c] * ncy + cy[b]) * ncx + cx[a]];
            }
            sy += wy[b] * sz;
        }
        sx += wx[a] * sy;
    }
    return sx;
}

// New value of the point at tile index c whose zero-coordinate mask is m.
// KT > 0 fixes the number of taps at compile time (7 and 27 are the
// Poisson hierarchy's); KT == 0 loops to st.K.  Interior points (m == 0)
// take their taps from registers, boundary points from the shared table.
template <int MODE, int KT>
__device__ __forceinline__ float update_point(
    const Stencil& st, const float* sx, const float* taps, const float* treg,
    int c, int m, float bval, float inv_d, float omega)
{
    constexpr int KN = KT > 0 ? KT : MAXK;
    // no stage: the loaded iterate (x + P*ec) is the result
    if (MODE == MODE_ADD) return sx[c];
    float acc = 0.0f;
    if (m == 0) {
        // for a red/black stage treg holds 0 at the diagonal: adding
        // 0 * x leaves the sum as it is
#pragma unroll
        for (int k = 0; k < KN; ++k) {
            if (KT == 0 && k >= st.K) break;
            acc += treg[k] * sx[c + st.ds[k]];
        }
    } else {
        const float* tp = taps + m * MAXK;
#pragma unroll
        for (int k = 0; k < KN; ++k) {
            if (KT == 0 && k >= st.K) break;
            if (MODE == MODE_RB && k == st.di) continue;
            acc += tp[k] * sx[c + st.ds[k]];
        }
    }
    const float res = bval - acc;
    if (MODE == MODE_RESIDUAL) return res;
    const bool interior = st.rowmap[m] < 0;
    const float xc = sx[c];
    if (MODE == MODE_JACOBI)
        return interior ? xc + omega * (inv_d * res)
                        : xc + (omega * res) / taps[m * MAXK + st.di];
    return interior ? inv_d * res : res / taps[m * MAXK + st.di];
}

// One stage (or the plain residual, or the stage-free x + P*ec) on one
// tile.  xin == nullptr is the zero iterate; ec != nullptr adds P*ec to the
// loaded iterate.
template <int MODE, int KT>
__global__ void __launch_bounds__(STAGE_THREADS) stage_kernel(
    Stencil st, const float* __restrict__ values, const float* __restrict__ table,
    const float* __restrict__ b, const float* __restrict__ xin,
    const float* __restrict__ ec, float* __restrict__ out,
    int nz, int ny, int nx, float omega, int color,
    float pwm, float pw0, float pwp)
{
    __shared__ float sx[SZ * SY * SX];
    __shared__ float taps[8 * MAXK];

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;
    const int ncz = nz >> 1, ncy = ny >> 1, ncx = nx >> 1;

    load_taps(taps, st, values, table, tid, STAGE_THREADS);

    // The tile's own 64 columns: a warp takes a row, a lane its pair, as
    // one 8-byte load where the row is aligned for it.
    const bool vec_in = (nx & 1) == 0 && (((uintptr_t)xin) & 7) == 0;
#pragma unroll 4
    for (int r = warp; r < SZ * SY; r += TY) {
        const int lz = r / SY, ly = r - lz * SY;
        const int gz = z0 + lz - 1, gy = y0 + ly - 1;
        const int gx = x0 + 2 * lane;
        float v0 = 0.0f, v1 = 0.0f;
        if (gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx < nx) {
            const size_t g = ((size_t)gz * ny + gy) * nx + gx;
            if (xin != nullptr) {
                if (vec_in) {
                    const float2 t = *reinterpret_cast<const float2*>(xin + g);
                    v0 = t.x;
                    v1 = t.y;
                } else {
                    v0 = xin[g];
                    if (gx + 1 < nx) v1 = xin[g + 1];
                }
            }
            if (ec != nullptr) {
                v0 += prolong_at(ec, gz, gy, gx, ncz, ncy, ncx, pwm, pw0, pwp);
                if (gx + 1 < nx)
                    v1 += prolong_at(ec, gz, gy, gx + 1, ncz, ncy, ncx, pwm, pw0, pwp);
            }
        }
        sx[r * SX + 1 + 2 * lane] = v0;
        sx[r * SX + 2 + 2 * lane] = v1;
    }
    // the two halo columns, x0 - 1 and x0 + 64
    for (int i = tid; i < 2 * SZ * SY; i += STAGE_THREADS) {
        const int r = i >> 1, side = i & 1;
        const int lz = r / SY, ly = r - lz * SY;
        const int gz = z0 + lz - 1, gy = y0 + ly - 1;
        const int gx = side ? x0 + TX : x0 - 1;
        float v = 0.0f;
        if (gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
            if (xin != nullptr) v = xin[((size_t)gz * ny + gy) * nx + gx];
            if (ec != nullptr)
                v += prolong_at(ec, gz, gy, gx, ncz, ncy, ncx, pwm, pw0, pwp);
        }
        sx[r * SX + (side ? SX - 1 : 0)] = v;
    }
    __syncthreads();

    const int ly = warp;
    const int gy = y0 + ly, gx = x0 + 2 * lane;
    if (gy >= ny || gx >= nx) return;
    const bool second = gx + 1 < nx;
    const bool vec_io = (nx & 1) == 0 && (((uintptr_t)b) & 7) == 0 &&
                        (((uintptr_t)out) & 7) == 0;

    constexpr int KN = KT > 0 ? KT : MAXK;
    float treg[KN];
#pragma unroll
    for (int k = 0; k < KN; ++k)
        treg[k] = (k < st.K && !(MODE == MODE_RB && k == st.di)) ? taps[k] : 0.0f;
    const float inv_d = 1.0f / taps[st.di];
    const int my = gy == 0 ? 2 : 0;

    for (int lz = 0; lz < TZ; ++lz) {
        const int gz = z0 + lz;
        if (gz >= nz) break;
        const int mzy = my | (gz == 0 ? 1 : 0);
        const int m0 = mzy | (gx == 0 ? 4 : 0);
        const int c = ((lz + 1) * SY + (ly + 1)) * SX + 1 + 2 * lane;
        const size_t g = ((size_t)gz * ny + gy) * nx + gx;
        float b0 = 0.0f, b1 = 0.0f;
        if (MODE == MODE_ADD) {
            // x + P*ec does not depend on b
        } else if (vec_io) {
            const float2 t = *reinterpret_cast<const float2*>(b + g);
            b0 = t.x;
            b1 = t.y;
        } else {
            b0 = b[g];
            if (second) b1 = b[g + 1];
        }
        float o0, o1;
        if (MODE == MODE_RB) {
            // the point of the pair whose coordinate sum has this stage's
            // colour is updated, the other keeps its value
            const int sel = (gz + gy + gx + color) & 1;
            o0 = sx[c];
            o1 = sx[c + 1];
            if (sel == 0)
                o0 = update_point<MODE, KT>(st, sx, taps, treg, c, m0, b0, inv_d, omega);
            else if (second)
                o1 = update_point<MODE, KT>(st, sx, taps, treg, c + 1, mzy, b1, inv_d, omega);
        } else {
            o0 = update_point<MODE, KT>(st, sx, taps, treg, c, m0, b0, inv_d, omega);
            o1 = second
                ? update_point<MODE, KT>(st, sx, taps, treg, c + 1, mzy, b1, inv_d, omega)
                : 0.0f;
        }
        if (vec_io) {
            *reinterpret_cast<float2*>(out + g) = make_float2(o0, o1);
        } else {
            out[g] = o0;
            if (second) out[g + 1] = o1;
        }
    }
}

// bc = R (b - A x): the fine residual lives only in shared memory.
__global__ void __launch_bounds__(RESTRICT_THREADS) residual_restrict_kernel(
    Stencil st, const float* __restrict__ values, const float* __restrict__ table,
    const float* __restrict__ b, const float* __restrict__ xin,
    float* __restrict__ bc, int nz, int ny, int nx,
    float rwm, float rw0, float rwp)
{
    __shared__ float sx[ZE * YE * XE];
    __shared__ float sr[ZR * YR * XR];
    __shared__ float taps[8 * MAXK];

    const int tid = threadIdx.x;
    const int cx0 = blockIdx.x * CX, cy0 = blockIdx.y * CY, cz0 = blockIdx.z * CZ;
    // fine origin of the r region (2c - 1) and of the x region (one more)
    const int rx0 = 2 * cx0 - 1, ry0 = 2 * cy0 - 1, rz0 = 2 * cz0 - 1;

    load_taps(taps, st, values, table, tid, RESTRICT_THREADS);

    for (int i = tid; i < ZE * YE * XE; i += RESTRICT_THREADS) {
        int lz = i / (YE * XE);
        int rem = i - lz * (YE * XE);
        int ly = rem / XE, lx = rem - ly * XE;
        int gz = rz0 - 1 + lz, gy = ry0 - 1 + ly, gx = rx0 - 1 + lx;
        float v = 0.0f;
        if (xin != nullptr && gz >= 0 && gz < nz && gy >= 0 && gy < ny &&
            gx >= 0 && gx < nx)
            v = xin[((size_t)gz * ny + gy) * nx + gx];
        sx[i] = v;
    }
    __syncthreads();

    for (int i = tid; i < ZR * YR * XR; i += RESTRICT_THREADS) {
        int lz = i / (YR * XR);
        int rem = i - lz * (YR * XR);
        int ly = rem / XR, lx = rem - ly * XR;
        int gz = rz0 + lz, gy = ry0 + ly, gx = rx0 + lx;
        float r = 0.0f;
        if (gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
            const int m = (gz == 0 ? 1 : 0) | (gy == 0 ? 2 : 0) | (gx == 0 ? 4 : 0);
            const float* tp = taps + m * MAXK;
            const int c = ((lz + 1) * YE + (ly + 1)) * XE + (lx + 1);
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < MAXK; ++k) {
                if (k >= st.K) break;
                acc += tp[k] * sx[c + st.dr[k]];
            }
            r = b[((size_t)gz * ny + gy) * nx + gx] - acc;
        }
        sr[i] = r;
    }
    __syncthreads();

    const int lcx = tid % CX, lcy = (tid / CX) % CY, lcz = tid / (CX * CY);
    const int gcx = cx0 + lcx, gcy = cy0 + lcy, gcz = cz0 + lcz;
    const int ncz = nz >> 1, ncy = ny >> 1, ncx = nx >> 1;
    if (gcx >= ncx || gcy >= ncy || gcz >= ncz) return;

    // fine index 2c + t sits at r-region index 2*lc + t + 1
    const float w[3] = {rwm, rw0, rwp};
    float ax = 0.0f;
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) {
        float ay = 0.0f;
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) {
            float az = 0.0f;
#pragma unroll
            for (int tz = 0; tz < 3; ++tz)
                az += w[tz] * sr[((2 * lcz + tz) * YR + (2 * lcy + ty)) * XR +
                                 (2 * lcx + tx)];
            ay += w[ty] * az;
        }
        ax += w[tx] * ay;
    }
    bc[((size_t)gcz * ncy + gcy) * ncx + gcx] = ax;
}

int fill_stencil(Stencil& st, const int* offs, int K, const int* rowmap)
{
    if (K < 1 || K > MAXK) return 1;
    st.K = K;
    st.di = -1;
    for (int k = 0; k < MAXK; ++k) st.ds[k] = st.dr[k] = 0;
    for (int k = 0; k < K; ++k) {
        const int oz = offs[3 * k], oy = offs[3 * k + 1], ox = offs[3 * k + 2];
        if (oz < -1 || oz > 1 || oy < -1 || oy > 1 || ox < -1 || ox > 1)
            return 1;
        if (oz == 0 && oy == 0 && ox == 0) st.di = k;
        st.ds[k] = (oz * SY + oy) * SX + ox;
        st.dr[k] = (oz * YE + oy) * XE + ox;
    }
    if (st.di < 0) return 1;
    for (int m = 0; m < 8; ++m) st.rowmap[m] = rowmap[m];
    return 0;
}

template <int MODE>
void launch_stage(
    dim3 grid, cudaStream_t stream, const Stencil& st, const float* values,
    const float* table, const float* b, const float* xin, const float* ec,
    float* out, int nz, int ny, int nx, float omega, int color, const float* pw)
{
#define OMG_LAUNCH(KT)                                                       \
    stage_kernel<MODE, KT><<<grid, STAGE_THREADS, 0, stream>>>(              \
        st, values, table, b, xin, ec, out, nz, ny, nx, omega, color, pw[0], \
        pw[1], pw[2])
    if (st.K == 7) OMG_LAUNCH(7);
    else if (st.K == 27) OMG_LAUNCH(27);
    else OMG_LAUNCH(0);
#undef OMG_LAUNCH
}

}  // namespace

// Runs the whole level visit on `stream`: n_stages stage launches that
// ping-pong between x_out and tmp (the last one lands in x_out), then the
// optional residual.  Returns 0, or a CUDA error code, or -1 for arguments
// the kernels do not take.
//
//   values (K,) and table (n_regions, K): device pointers (table may be
//     null when every rowmap entry is -1).
//   offs (K*3 ints), rowmap (8 ints), kinds / pars (n_stages), rw / pw
//     (3 floats: weights of taps -1, 0, +1): host pointers.
//   x: start iterate or null (zero).  ec: coarse correction or null.
//   emit_residual: 0 none; 1 r_out = b - A x (fine size);
//     2 r_out = R (b - A x) (coarse size; all dims must be even).
//   With n_stages == 0 and no ec the residual is taken of x itself and
//     x_out, tmp are not touched; with ec, x_out = x + P*ec is written by
//     one launch and the residual is taken of that.
extern "C" int omg_fused_stages(
    const float* values, const float* table, const int* offs, int K,
    const int* rowmap, const float* b, const float* x, const float* ec,
    float* x_out, float* tmp, float* r_out, int nz, int ny, int nx,
    int n_stages, const int* kinds, const float* pars, int emit_residual,
    const float* rw, const float* pw, void* stream_ptr)
{
    Stencil st;
    if (fill_stencil(st, offs, K, rowmap)) return -1;
    if (nz < 1 || ny < 1 || nx < 1) return -1;
    if ((ec != nullptr || emit_residual == 2) && ((nz | ny | nx) & 1)) return -1;
    if ((ec != nullptr || n_stages > 0) && x_out == nullptr) return -1;
    if (n_stages > 1 && tmp == nullptr) return -1;
    cudaStream_t stream = (cudaStream_t)stream_ptr;

    dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + TZ - 1) / TZ);
    const float* cur = x;
    const float* cur_ec = ec;
    if (ec != nullptr && n_stages == 0) {
        stage_kernel<MODE_ADD, 0><<<grid, STAGE_THREADS, 0, stream>>>(
            st, values, table, b, x, ec, x_out, nz, ny, nx, 0.0f, 0, pw[0],
            pw[1], pw[2]);
        cur = x_out;
    }
    for (int s = 0; s < n_stages; ++s) {
        float* dst = ((n_stages - 1 - s) % 2 == 0) ? x_out : tmp;
        if (kinds[s] == MODE_JACOBI)
            launch_stage<MODE_JACOBI>(grid, stream, st, values, table, b, cur,
                                      cur_ec, dst, nz, ny, nx, pars[s], 0, pw);
        else if (kinds[s] == MODE_RB)
            launch_stage<MODE_RB>(grid, stream, st, values, table, b, cur,
                                  cur_ec, dst, nz, ny, nx, 0.0f, (int)pars[s], pw);
        else
            return -1;
        cur = dst;
        cur_ec = nullptr;
    }
    if (emit_residual == 1) {
        const float none[3] = {0.0f, 0.0f, 0.0f};
        launch_stage<MODE_RESIDUAL>(grid, stream, st, values, table, b, cur,
                                    nullptr, r_out, nz, ny, nx, 0.0f, 0, none);
    } else if (emit_residual == 2) {
        int ncz = nz / 2, ncy = ny / 2, ncx = nx / 2;
        dim3 cgrid((ncx + CX - 1) / CX, (ncy + CY - 1) / CY, (ncz + CZ - 1) / CZ);
        residual_restrict_kernel<<<cgrid, RESTRICT_THREADS, 0, stream>>>(
            st, values, table, b, cur, r_out, nz, ny, nx, rw[0], rw[1], rw[2]);
    }
    return (int)cudaGetLastError();
}
