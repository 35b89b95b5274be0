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
// What the design does about it (the simple, right version):
//   * Overlapping tiles, one launch a visit.  A block loads b and the start
//     iterate for a tile of 64 columns by 64 + 2D rows into shared memory,
//     where D = S (+1 with a residual, +1 more with a restriction) is the
//     halo depth, and owns the 64 - 2D by 64 points inside the halo.  Stage
//     s recomputes the region that is still exact after s stages, which
//     shrinks by one point a side each stage, so the S stages, the residual
//     and the restriction read device memory once: the halo costs
//     64 (64 + 2D) / ((64 - 2D) 64) of the reads and the arithmetic (1.46x
//     at D = 6, V(2,2) with a restriction).  Three float buffers (b and two
//     iterates) are dynamic shared memory, 57 KB at D = 6; visits deeper than
//     MAX_DEPTH are split by the caller into consecutive launches.
//   * Stages ping-pong between the two iterate buffers with a barrier
//     between them: every point of a stage reads the iterate as it was
//     before the stage.  On the 9-point cornered levels the diagonal taps
//     (+-1, +-1) couple points of one colour, so an in-place update would be
//     Gauss-Seidel within a colour and give other numbers.
//   * A lane owns a pair of x-neighbours and the warp walks the pairs'
//     first points, then their second points.  All lanes of such a step
//     hold points of one colour, so a red/black stage computes one point
//     of each pair and copies the other without divergence.  A tile row is
//     stored split by the parity of x (even columns, then odd), so the
//     lanes of a step read consecutive words: no bank conflicts.
//   * A stage computes only the region that is still exact and never reads
//     the stale ring outside it.  Points outside the domain hold zero in
//     every buffer (the Dirichlet zero) and are never smoothed.
//   * Parity is global, (y + x) & 1 with the tile's origin included.
//   * Interior points keep their taps in registers; points on the low faces
//     pick their row of the region table from shared memory.
//   * The restriction reads the residual of the tile plus a one-point ring
//     from shared memory and writes only the (ny/2, nx/2) coarse points of
//     the tile; the prolongation adds sum_t w_t ec[c] with separable
//     radius-1 taps while the tile is loaded.
//
// Rounding: taps are summed in the order of the offsets (the diagonal
// skipped in a red/black stage); interior points multiply by the reciprocal
// of the interior diagonal, region points divide by their own diagonal, as
// fused_stages.cu does.  nvcc may contract a*b+c into a fused multiply-add,
// which the plain PyTorch version does not, so the two agree to a few ulp.

#include <cuda_runtime.h>

namespace {

constexpr int MAXK = 9;
constexpr int MAX_DEPTH = 16;           // the caller splits deeper visits
constexpr int PX = 64;                  // tile columns, halo included
constexpr int HALF = PX / 2;            // a row: even columns, then odd ones
constexpr int TY = 64;                  // tile rows owned, halo excluded
constexpr int BX = 32, BY = 8;          // a lane per column pair, a warp per row
constexpr int THREADS = BX * BY;

enum Mode { MODE_JACOBI = 0, MODE_RB = 1, MODE_RESIDUAL = 2 };

struct Plan {
    int K;
    int di;                 // index of the (0,0) offset
    int d[2][MAXK];         // offset k as a step in the split row layout, by x parity
    int rowmap[4];          // mask (bit 0: y == 0, bit 1: x == 0) -> table row, -1 = interior
    int n_stages;
    int kind[MAX_DEPTH];
    float par[MAX_DEPTH];   // omega of a Jacobi stage, colour of a red/black one
    int emit;               // 0: none; 1: residual; 2: restricted residual
    int H;                  // halo depth
    int PY;                 // tile rows, TY + 2H
    int TXO;                // tile columns owned, PX - 2H
    float rw[3], pw[3];     // transfer weights of taps -1, 0, +1
};

// Shared-memory index of tile cell (r, c): even columns first, then odd.
__device__ __forceinline__ int cell(int r, int c)
{
    return r * PX + (c & 1) * HALF + (c >> 1);
}

// (P ec)(fy, fx) for separable radius-1 taps: weight w[t + 1] couples fine
// index f = 2c + t with coarse index c.  The y sum inside the x sum, the
// order of the plain version (axis 0 first).
__device__ __forceinline__ float prolong_at(
    const float* __restrict__ ec, int fy, int fx, int ncy, int ncx,
    const float* w)
{
    int cy[2], cx[2];
    float wy[2], wx[2];
    int nyt, nxt;
#define OMG_AXIS_TAPS(f, c, wt, n)                                            \
    if ((f & 1) == 0) { c[0] = f >> 1; wt[0] = w[1]; n = 1; }                 \
    else {                                                                    \
        c[0] = (f + 1) >> 1; wt[0] = w[0]; c[1] = (f - 1) >> 1; wt[1] = w[2]; \
        n = 2;                                                                \
    }
    OMG_AXIS_TAPS(fy, cy, wy, nyt)
    OMG_AXIS_TAPS(fx, cx, wx, nxt)
#undef OMG_AXIS_TAPS
    float sx = 0.0f;
    for (int a = 0; a < nxt; ++a) {
        if (cx[a] >= ncx || wx[a] == 0.0f) continue;
        float sy = 0.0f;
        for (int c = 0; c < nyt; ++c) {
            if (cy[c] >= ncy || wy[c] == 0.0f) continue;
            sy += wy[c] * ec[(size_t)cy[c] * ncx + cx[a]];
        }
        sx += wx[a] * sy;
    }
    return sx;
}

// New value of the point at shared index i (x parity j) whose
// zero-coordinate mask is m.  KT > 0 fixes the tap count at compile time (5
// and 9 are the Poisson hierarchy's); KT == 0 loops to pl.K.  Interior
// points (m == 0) take their taps from registers, boundary points from the
// shared table.
template <int MODE, int KT>
__device__ __forceinline__ float update_point(
    const Plan& pl, const float* src, const float* taps, const float* treg,
    const int* rowmap, int i, int j, int m, float bval, float inv_d,
    float omega)
{
    constexpr int KN = KT > 0 ? KT : MAXK;
    const int* d = pl.d[j];
    float acc = 0.0f;
    if (m == 0) {
#pragma unroll
        for (int k = 0; k < KN; ++k) {
            if (KT == 0 && k >= pl.K) break;
            if (MODE == MODE_RB && k == pl.di) continue;
            acc += treg[k] * src[i + d[k]];
        }
    } else {
        const float* tp = taps + m * MAXK;
#pragma unroll
        for (int k = 0; k < KN; ++k) {
            if (KT == 0 && k >= pl.K) break;
            if (MODE == MODE_RB && k == pl.di) continue;
            acc += tp[k] * src[i + d[k]];
        }
    }
    const float res = bval - acc;
    if (MODE == MODE_RESIDUAL) return res;
    if (rowmap[m] < 0)
        return MODE == MODE_JACOBI ? src[i] + omega * (inv_d * res) : inv_d * res;
    const float dg = taps[m * MAXK + pl.di];
    return MODE == MODE_JACOBI ? src[i] + (omega * res) / dg : res / dg;
}

// One pass over the tile cells [lo, PY - lo) x [lo, PX - lo): a stage
// (MODE_JACOBI, MODE_RB) or the residual, from src into dst.  Lane tx owns
// columns 2 tx and 2 tx + 1; cells outside the domain get zero.
template <int MODE, int KT>
__device__ __forceinline__ void tile_pass(
    const Plan& pl, const float* sb, const float* src, float* dst,
    const float* taps, const float* treg, const int* rowmap, int lo,
    int gy0, int gx0, int ny, int nx, float inv_d, float par)
{
    const int colour = (int)par;
    const int q = threadIdx.x;
    for (int r = lo + threadIdx.y; r < pl.PY - lo; r += BY) {
        const int gy = gy0 + r;
        const bool iny = gy >= 0 && gy < ny;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int c = 2 * q + j;
            if (c < lo || c >= PX - lo) continue;
            const int gx = gx0 + c;
            const int i = r * PX + j * HALF + q;
            float v = 0.0f;
            if (iny && gx >= 0 && gx < nx) {
                // the same colour in every lane of the warp: no divergence
                if (MODE == MODE_RB && ((gy + gx) & 1) != colour) {
                    v = src[i];
                } else {
                    const int m = (gy == 0 ? 1 : 0) | (gx == 0 ? 2 : 0);
                    v = update_point<MODE, KT>(pl, src, taps, treg, rowmap, i,
                                               j, m, sb[i], inv_d, par);
                }
            }
            dst[i] = v;
        }
    }
}

template <int KT>
__global__ void __launch_bounds__(THREADS) fused2d_kernel(
    Plan pl, const float* __restrict__ values, const float* __restrict__ table,
    const float* __restrict__ b, const float* __restrict__ xin,
    const float* __restrict__ ec, float* __restrict__ x_out,
    float* __restrict__ r_out, int ny, int nx)
{
    extern __shared__ float smem[];
    __shared__ float taps[4 * MAXK];
    __shared__ int rowmap[4];
    __shared__ int kinds[MAX_DEPTH];
    __shared__ float pars[MAX_DEPTH];

    const int H = pl.H, PY = pl.PY, TXO = pl.TXO;
    float* sb = smem;
    float* src = smem + PY * PX;
    float* dst = src + PY * PX;

    const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * BX + tx;
    const int fy0 = blockIdx.y * TY, fx0 = blockIdx.x * TXO;
    const int gy0 = fy0 - H, gx0 = fx0 - H;   // global index of tile cell 0
    const int ncy = ny >> 1, ncx = nx >> 1;

    for (int i = tid; i < 4 * pl.K; i += THREADS) {
        const int m = i / pl.K, k = i - m * pl.K;
        const int row = pl.rowmap[m];
        taps[m * MAXK + k] = row < 0 ? values[k] : table[row * pl.K + k];
    }
    if (tid < 4) rowmap[tid] = pl.rowmap[tid];
    if (tid < pl.n_stages) {
        kinds[tid] = pl.kind[tid];
        pars[tid] = pl.par[tid];
    }

    // b and the start iterate (0, x, or x + P*ec) for the tile and its halo;
    // zero outside the domain.  A warp reads 32 consecutive columns.
    for (int r = ty; r < PY; r += BY) {
        const int gy = gy0 + r;
        const bool iny = gy >= 0 && gy < ny;
        for (int c = tx; c < PX; c += BX) {
            const int gx = gx0 + c;
            float vb = 0.0f, vx = 0.0f;
            if (iny && gx >= 0 && gx < nx) {
                const size_t g = (size_t)gy * nx + gx;
                vb = b[g];
                if (xin != nullptr) vx = xin[g];
                if (ec != nullptr) vx += prolong_at(ec, gy, gx, ncy, ncx, pl.pw);
            }
            sb[cell(r, c)] = vb;
            src[cell(r, c)] = vx;
        }
    }
    __syncthreads();
    const float inv_d = 1.0f / taps[pl.di];
    constexpr int KN = KT > 0 ? KT : MAXK;
    float treg[KN];
#pragma unroll
    for (int k = 0; k < KN; ++k) treg[k] = k < pl.K ? taps[k] : 0.0f;

    // stage s recomputes the cells [s + 1, P - s - 1) of both axes, the
    // region its inputs are exact on; the ring outside it is never read
    for (int s = 0; s < pl.n_stages; ++s) {
        if (kinds[s] == MODE_RB)
            tile_pass<MODE_RB, KT>(pl, sb, src, dst, taps, treg, rowmap, s + 1,
                                   gy0, gx0, ny, nx, inv_d, pars[s]);
        else
            tile_pass<MODE_JACOBI, KT>(pl, sb, src, dst, taps, treg, rowmap,
                                       s + 1, gy0, gx0, ny, nx, inv_d, pars[s]);
        __syncthreads();
        float* t = src;
        src = dst;
        dst = t;
    }

    // the residual of the final iterate, into the free buffer: on the owned
    // points (emit 1) or on them and a one-point ring (emit 2); zero outside
    // the domain, so the restriction sees the Dirichlet zero there
    if (pl.emit) {
        tile_pass<MODE_RESIDUAL, KT>(pl, sb, src, dst, taps, treg, rowmap,
                                     pl.n_stages + 1, gy0, gx0, ny, nx, inv_d,
                                     0.0f);
        __syncthreads();
    }

    for (int r = H + ty; r < H + TY; r += BY) {
        const int gy = gy0 + r;
        if (gy >= ny) break;
        for (int c = H + tx; c < H + TXO; c += BX) {
            const int gx = gx0 + c;
            if (gx >= nx) break;
            const size_t g = (size_t)gy * nx + gx;
            x_out[g] = src[cell(r, c)];
            if (pl.emit == 1) r_out[g] = dst[cell(r, c)];
        }
    }
    if (pl.emit == 2) {
        // coarse c sits over fine 2c, at tile cell 2 * lc + H
        const float* w = pl.rw;
        for (int ly = ty; ly < TY / 2; ly += BY) {
            const int cy = (fy0 >> 1) + ly;
            if (cy >= ncy) break;
            for (int lx = tx; lx < TXO / 2; lx += BX) {
                const int cx = (fx0 >> 1) + lx;
                if (cx >= ncx) break;
                const int r0 = 2 * ly + H, c0 = 2 * lx + H;
                float ax = 0.0f;
#pragma unroll
                for (int tx3 = 0; tx3 < 3; ++tx3) {
                    float ay = 0.0f;
#pragma unroll
                    for (int ty3 = 0; ty3 < 3; ++ty3)
                        ay += w[ty3] * dst[cell(r0 + ty3 - 1, c0 + tx3 - 1)];
                    ax += w[tx3] * ay;
                }
                r_out[(size_t)cy * ncx + cx] = ax;
            }
        }
    }
}

template <int KT>
int launch(const Plan& pl, dim3 grid, cudaStream_t stream,
           const float* values, const float* table, const float* b,
           const float* x, const float* ec, float* x_out, float* r_out,
           int ny, int nx)
{
    const size_t smem = 3 * (size_t)pl.PY * PX * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        fused2d_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    fused2d_kernel<KT><<<grid, dim3(BX, BY), smem, stream>>>(
        pl, values, table, b, x, ec, x_out, r_out, ny, nx);
    return (int)cudaGetLastError();
}

}  // namespace

// The deepest visit one launch takes: stages, +1 with a residual, +1 more
// with a restriction.  The wrapper splits deeper visits.
extern "C" int omg_fused2d_max_depth() { return MAX_DEPTH; }

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
extern "C" int omg_fused_stages_2d(
    const float* values, const float* table, const int* offs, int K,
    const int* rowmap, const float* b, const float* x, const float* ec,
    float* x_out, float* r_out, int ny, int nx, int n_stages,
    const int* kinds, const float* pars, int emit, const float* rw,
    const float* pw, void* stream_ptr)
{
    if (K < 1 || K > MAXK || ny < 1 || nx < 1 || x_out == nullptr) return -1;
    if (emit < 0 || emit > 2 || (emit != 0 && r_out == nullptr)) return -1;
    if ((ec != nullptr || emit == 2) && ((ny | nx) & 1)) return -1;
    const int H = n_stages + (emit >= 1 ? 1 : 0) + (emit == 2 ? 1 : 0);
    if (n_stages < 0 || H > MAX_DEPTH) return -1;

    Plan pl;
    pl.K = K;
    pl.di = -1;
    pl.H = H;
    pl.PY = TY + 2 * H;
    pl.TXO = PX - 2 * H;
    pl.n_stages = n_stages;
    pl.emit = emit;
    for (int k = 0; k < MAXK; ++k) pl.d[0][k] = pl.d[1][k] = 0;
    for (int k = 0; k < K; ++k) {
        const int oy = offs[2 * k], ox = offs[2 * k + 1];
        if (oy < -1 || oy > 1 || ox < -1 || ox > 1) return -1;
        if (oy == 0 && ox == 0) pl.di = k;
        // even column 2q: column 2q + ox lies in the odd half, at q - 1 for
        // ox = -1 and at q for ox = +1; odd column 2q + 1: column 2q + 1 + ox
        // lies in the even half, at q for ox = -1 and at q + 1 for ox = +1
        pl.d[0][k] = oy * PX + (ox == 0 ? 0 : HALF + (ox < 0 ? -1 : 0));
        pl.d[1][k] = oy * PX + (ox == 0 ? 0 : -HALF + (ox > 0 ? 1 : 0));
    }
    if (pl.di < 0) return -1;
    for (int m = 0; m < 4; ++m) {
        pl.rowmap[m] = rowmap[m];
        if (rowmap[m] >= 0 && table == nullptr) return -1;
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
    dim3 grid((nx + pl.TXO - 1) / pl.TXO, (ny + TY - 1) / TY);
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    if (K == 5)
        return launch<5>(pl, grid, stream, values, table, b, x, ec, x_out, r_out, ny, nx);
    if (K == 9)
        return launch<9>(pl, grid, stream, values, table, b, x, ec, x_out, r_out, ny, nx);
    return launch<0>(pl, grid, stream, values, table, b, x, ec, x_out, r_out, ny, nx);
}
