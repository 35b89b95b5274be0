// Banded SpMV: the slot-offset ELL SpMV (kernel K6) and the blocked-band
// BSR SpMV (kernel K7), one kernel body for both:
//
//   y[I*B + i] = sum_j sum_s data[s, j, I*B + i] * x[(I + d_s)*B + j]
//
// (x outside the matrix is zero) for a square matrix of B x B blocks whose
// slot s holds only blocks of block column I + d_s, stored slot-major
// (k, B, n): data[s, j, I*B + i] is element (i, j) of the block that
// couples block row I to block column I + d_s.  A slot-offset ELL matrix is
// the case B = 1, whose (k, n) layout is the same array:
//
//   y[i] = sum_s data[s, i] * x[i + d_s]
//
// The halo form K6h (omg_spmv_banded_halo, at the end) runs the same body
// at B = 1 on a rank's slab of rows, reading the H rows received from each
// neighbour where they lie (term()'s source selector); on a batch (K6hb)
// with the batched form's MB members a thread, each member's received rows
// its own.
//
// Replaces openmg_tpu/ops/ell.py::spmv_ell (body _dia_kernel), which streams
// data and a three-tile window of x and forms each shift with sublane slices
// and lane rolls, and openmg_tpu/ops/bsr.py::spmv_bsr (body _bsr_kernel),
// which builds the block replicas z_j[r] = x[r - r%B + j] in registers with
// lane rolls and needed B to divide 128 (block size 3 was refused there).
//
// What bounds it on an H100: bytes where the grid is full (one multiply and
// one add per stored element against its 4 bytes, 8 in float64, plus x read
// and y written once: far below the card's flop:byte ratio).  On a small
// level (16,384 rows: 7 MB at kb 27, B 4) it is latency: a row of kb*B
// terms summed by one thread is a chain of dependent loads unless every
// term's address is known before the first load returns.
//
// What the design does:
//   * Every term's address is known up front.  The slot offsets come by
//     value in the kernel's arguments (a struct of up to MAX_SLOTS; a longer
//     list is read from the device array) and are copied once a block into
//     shared memory; the common slot counts (5, 7, 9 for ELL; 7, 27 for BSR)
//     and block sizes (1, 2, 3, 4, 8) are compile-time constants, so a
//     lane's term loop is unrolled (whole up to 32 terms, else by 8, which
//     keeps a long row from taking a register a term) and its data and x
//     loads are issued together.  Other counts and sizes run the same body
//     with a loop unrolled by 8.
//   * A row's kb*B terms t = j*kb + s (block column j outer, slot s inner)
//     are split over a group of G lanes (G = 1, 2, 4 or 8, a power of two
//     chosen per launch by the caller, ops/bsr.py::lane_group: the smallest
//     that gives the grid enough threads, at most kb*B; a small level gets
//     the parallelism its rows lack, a large one keeps whole rows a lane).
//     Lane g sums the terms t = g, g + G, g + 2G, ... in that order; the
//     group then adds its G partial sums by xor shuffles, a fixed pairwise
//     tree ((p0 + p1) + (p2 + p3)) + ..., the same value in every lane.
//     G = 1 is the plain sum in term order; ELL launches always take G = 1.
//   * For each term the data read data[(s*B + j)*n + r] is coalesced across
//     the rows of a warp; the x read x[(I + d_s)*B + j] is the same address
//     for the B rows of a block row and neighbouring for neighbouring block
//     rows.  The column indices are never read: the offsets are trusted as
//     in the JAX package.  x is read only where 0 <= I + d_s < n/B;
//     elsewhere the term is data * 0, as in the plain versions.
//   * The products and sums use __fmul_rn / __fadd_rn (and their double
//     twins), which nvcc never contracts into a fused multiply-add, in the
//     order of openmg_tpu_torch/ops/bsr.py::spmv_banded_plain (the same
//     lane split and tree) and, for B = 1, the slot order of
//     openmg_tpu_torch/ops/ell.py::spmv_banded_plain, so the kernel equals
//     each bit for bit.
//
// The batched form (K6b at B = 1, K7b at B > 1: the TPU kernels under
// jax.vmap, whose grids gain a leading batch axis): nb vectors x, y (nb, n)
// through one matrix in one launch.  A thread reads each term's data
// element once and applies it to up to MB = 8 members' x (blockIdx.y picks
// the group of members), so the matrix, most of the bytes, crosses device
// memory once a group instead of once a member.  Each member's sum takes
// the scalar order (the same terms, lanes and tree), so it equals the
// scalar launch on that member bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SLOTS = 64;  // slot offsets passed by value

struct Slots {
    int d[MAX_SLOTS];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// The rows a rank's slab receives (K6h): lo holds the H rows below the
// slab, hi the H rows above it (zeros at the domain's edges).
template <typename T>
struct Halo {
    const T* lo;
    const T* hi;
    long long H;
};

// Term t = j*kb + s of row r (block row I) for the first mc of MB
// members: v[m] = data * x_m[(I + d_s)*B + j], the data element read once.
// HALO (B = 1): x is the slab's m = nbr rows and row J of [lo | x | hi] is
// read where it lies, so the caller never concatenates them (member m's lo
// and hi H rows apart); the slot offsets are at most H.
template <typename T, bool HALO, int MB>
__device__ __forceinline__ void term(
    T (&v)[MB], const T* __restrict__ data, const int* offs,
    const T* __restrict__ x, const Halo<T>& halo, int t, int kb, int B,
    long long I, long long r, long long nbr, long long n, int mc)
{
    const int j = t / kb;
    const int s = t - j * kb;
    const long long J = I + offs[s];
    const T d = __ldg(data + ((long long)s * B + j) * n + r);
    if constexpr (HALO) {
#pragma unroll
        for (int m = 0; m < MB; ++m) {
            const long long h = (long long)m * halo.H;
            const T xv = m >= mc ? T(0)
                       : J < 0 ? __ldg(halo.lo + h + halo.H + J)
                       : J < nbr ? __ldg(x + (long long)m * n + J)
                                 : __ldg(halo.hi + h + (J - nbr));
            v[m] = mul_rn(d, xv);
        }
    } else {
        const bool in = J >= 0 && J < nbr;
#pragma unroll
        for (int m = 0; m < MB; ++m) {
            const T xv = (in && m < mc) ? __ldg(x + (long long)m * n + J * B + j)
                                        : T(0);
            v[m] = mul_rn(d, xv);
        }
    }
}

// BC, KC > 0: the block size and slot count at compile time; 0: at run
// time.  G lanes a row.  HALO: a rank's slab with its received rows (K6h,
// K6hb).  MB: members a thread (1: one vector; 8: a batch, members
// blockIdx.y * MB on, nb in all).
template <typename T, int BC, int KC, int G, bool HALO, int MB>
__global__ void __launch_bounds__(THREADS) spmv_banded_kernel(
    const T* __restrict__ data, const __grid_constant__ Slots slots,
    const int* __restrict__ offs_dev, int k_run, int b_run,
    const T* __restrict__ x, const __grid_constant__ Halo<T> halos,
    T* __restrict__ y, long long n, int nb)
{
    extern __shared__ int offs[];
    const int B = BC > 0 ? BC : b_run;
    const int kb = KC > 0 ? KC : k_run;
    for (int i = threadIdx.x; i < kb; i += blockDim.x)
        offs[i] = kb <= MAX_SLOTS ? slots.d[i] : offs_dev[i];
    __syncthreads();

    const int m0 = blockIdx.y * MB;
    const int mc = min(MB, nb - m0);
    x += (long long)m0 * n;
    y += (long long)m0 * n;
    // the group's received rows: H a member
    const Halo<T> halo = HALO && m0 > 0
        ? Halo<T>{halos.lo + (long long)m0 * halos.H, halos.hi + (long long)m0 * halos.H,
                  halos.H}
        : halos;
    const long long nbr = n / B;
    const int nt = B * kb;
    const int g = G > 1 ? (int)(threadIdx.x & (G - 1)) : 0;
    const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long step = (long long)gridDim.x * blockDim.x / G;
    // rw: the warp's first row, so that a warp runs the loop (and its
    // shuffles) as a whole
    for (long long r = gt / G, rw = (gt & ~31LL) / G; rw < n;
         r += step, rw += step) {
        T acc[MB];
#pragma unroll
        for (int m = 0; m < MB; ++m) acc[m] = T(0);
        if (r < n) {
            const long long I = r / B;
            // lane g's terms t = g, g + G, ...: the first exists (G <= kb*B)
            term<T, HALO, MB>(acc, data, offs, x, halo, g, kb, B, I, r, nbr, n, mc);
            // the terms a lane takes at most, where that is known
            constexpr int NT = BC > 0 && KC > 0 ? (BC * KC + G - 1) / G : 0;
            if constexpr (MB == 1 && NT > 0 && NT <= 32) {
#pragma unroll
                for (int i = 1; i < NT; ++i) {
                    const int t = i * G + g;
                    if (t < nt) {
                        T v[1];
                        term<T, HALO, 1>(v, data, offs, x, halo, t, kb, B, I, r,
                                         nbr, n, mc);
                        acc[0] = add_rn(acc[0], v[0]);
                    }
                }
            } else if constexpr (MB == 1) {
                // unrolled by 8: the loads of eight terms go out together
                // without a register for every term of a long row
#pragma unroll 8
                for (int t = g + G; t < nt; t += G) {
                    T v[1];
                    term<T, HALO, 1>(v, data, offs, x, halo, t, kb, B, I, r, nbr,
                                     n, mc);
                    acc[0] = add_rn(acc[0], v[0]);
                }
            } else {
                // MB members a term: unrolled by 2 (16 loads in flight)
#pragma unroll 2
                for (int t = g + G; t < nt; t += G) {
                    T v[MB];
                    term<T, HALO, MB>(v, data, offs, x, halo, t, kb, B, I, r, nbr,
                                      n, mc);
#pragma unroll
                    for (int m = 0; m < MB; ++m) acc[m] = add_rn(acc[m], v[m]);
                }
            }
        }
#pragma unroll
        for (int o = 1; o < G; o <<= 1) {
#pragma unroll
            for (int m = 0; m < MB; ++m)
                acc[m] = add_rn(acc[m], __shfl_xor_sync(0xffffffffu, acc[m], o));
        }
        if (r < n && g == 0) {
#pragma unroll
            for (int m = 0; m < MB; ++m)
                if (m < mc) y[(long long)m * n + r] = acc[m];
        }
    }
}

int blocks_for(long long threads)
{
    long long b = (threads + THREADS - 1) / THREADS;
    const long long cap = 132LL * 16;  // enough blocks to fill every SM
    return (int)(b < cap ? (b < 1 ? 1 : b) : cap);
}

// HALO: the m = n rows of a rank's slab with the rows it received (K6h,
// B = 1, G = 1); else halo is unused.  nb > 1: a batch, MB = 8 members a
// thread, ceil(nb / 8) groups on blockIdx.y (with HALO, K6hb).
template <typename T, int BC, int KC, int G, bool HALO = false>
void go(const T* data, const Slots& sl, const int* offs, int k, int B,
        const T* x, T* y, long long n, int nb, cudaStream_t st,
        const Halo<T>& halo = Halo<T>{nullptr, nullptr, 0})
{
    if (nb > 1) {
        constexpr int MB = 8;
        const dim3 grid(blocks_for(n * G), (nb + MB - 1) / MB);
        spmv_banded_kernel<T, BC, KC, G, HALO, MB>
            <<<grid, THREADS, k * sizeof(int), st>>>(
                data, sl, offs, k, B, x, halo, y, n, nb);
        return;
    }
    spmv_banded_kernel<T, BC, KC, G, HALO, 1>
        <<<blocks_for(n * G), THREADS, k * sizeof(int), st>>>(
            data, sl, offs, k, B, x, halo, y, n, 1);
}

// A slot-offset ELL matrix (B = 1, one lane a row), whole (K6) or a rank's
// slab (K6h): the common float32 slot counts at compile time.
template <typename T, bool HALO>
void ell(const T* data, const Slots& sl, const int* offs, int k, const T* x,
         T* y, long long n, int nb, cudaStream_t st, const Halo<T>& halo)
{
    if constexpr (sizeof(T) == 4) {
        switch (k) {
        case 5: go<T, 1, 5, 1, HALO>(data, sl, offs, k, 1, x, y, n, nb, st, halo); return;
        case 7: go<T, 1, 7, 1, HALO>(data, sl, offs, k, 1, x, y, n, nb, st, halo); return;
        case 9: go<T, 1, 9, 1, HALO>(data, sl, offs, k, 1, x, y, n, nb, st, halo); return;
        default: break;
        }
    }
    go<T, 1, 0, 1, HALO>(data, sl, offs, k, 1, x, y, n, nb, st, halo);
}

template <typename T, int BC, int G>
void by_slots(const T* data, const Slots& sl, const int* offs, int k, int B,
              const T* x, T* y, long long n, int nb, cudaStream_t st)
{
    switch (k) {
    case 7: go<T, BC, 7, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 27: go<T, BC, 27, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    default: go<T, BC, 0, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    }
}

template <int G>
void bsr_f32(const float* data, const Slots& sl, const int* offs, int k,
             int B, const float* x, float* y, long long n, int nb, cudaStream_t st)
{
    switch (B) {
    case 2: by_slots<float, 2, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 3: by_slots<float, 3, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 4: by_slots<float, 4, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 8: by_slots<float, 8, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    default: go<float, 0, 0, G>(data, sl, offs, k, B, x, y, n, nb, st); break;
    }
}

void launch_f32(const float* data, const Slots& sl, const int* offs, int k,
                int B, int G, const float* x, float* y, long long n, int nb,
                cudaStream_t st)
{
    if (B == 1) {  // ELL: one lane a row
        ell<float, false>(data, sl, offs, k, x, y, n, nb, st,
                          Halo<float>{nullptr, nullptr, 0});
        return;
    }
    switch (G) {
    case 1: bsr_f32<1>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 2: bsr_f32<2>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 4: bsr_f32<4>(data, sl, offs, k, B, x, y, n, nb, st); break;
    default: bsr_f32<8>(data, sl, offs, k, B, x, y, n, nb, st); break;
    }
}

void launch_f64(const double* data, const Slots& sl, const int* offs, int k,
                int B, int G, const double* x, double* y, long long n, int nb,
                cudaStream_t st)
{
    switch (G) {
    case 1: go<double, 0, 0, 1>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 2: go<double, 0, 0, 2>(data, sl, offs, k, B, x, y, n, nb, st); break;
    case 4: go<double, 0, 0, 4>(data, sl, offs, k, B, x, y, n, nb, st); break;
    default: go<double, 0, 0, 8>(data, sl, offs, k, B, x, y, n, nb, st); break;
    }
}

}  // namespace

// data (k, B, n) and x, y (n,) of one type (is_double: float64, else
// float32); offs_host (k,) the int32 block offsets on the host (passed by
// value up to MAX_SLOTS), offs_dev the same on the device (read beyond);
// lanes: G, 1, 2, 4 or 8, at most k*B, and 1 for B = 1.  An ELL matrix is
// B = 1.  members: nb vectors (x, y (nb, n)) through the matrix, 1 for one.
// Returns 0, or a negative code for arguments the kernel does not take, or
// the CUDA error of the launch.
extern "C" int omg_spmv_banded(
    const void* data, const int* offs_host, const int* offs_dev, int k,
    int B, int lanes, const void* x, void* y, long long n, int members,
    int is_double, void* stream)
{
    if (k < 1 || B < 1 || n < 1 || n % B) return -1;
    if (members < 1 || (members + 7) / 8 > 65535) return -2;
    if (!(lanes == 1 || lanes == 2 || lanes == 4 || lanes == 8)
        || lanes > k * B || (B == 1 && lanes != 1))
        return -2;
    if (y == x) return -3;
    Slots sl;
    for (int i = 0; i < MAX_SLOTS; ++i) sl.d[i] = i < k ? offs_host[i] : 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_double)
        launch_f64((const double*)data, sl, offs_dev, k, B, lanes,
                   (const double*)x, (double*)y, n, members, st);
    else
        launch_f32((const float*)data, sl, offs_dev, k, B, lanes,
                   (const float*)x, (float*)y, n, members, st);
    return (int)cudaGetLastError();
}

// K6h, the halo form of the slot-offset ELL SpMV on a rank's slab of m
// rows (B = 1):
//
//   y[i] = sum_s data[s, i] * xe[i + d_s + H],   xe = [lo | x | hi]
//
// data (k, m), x (m,), lo and hi (H,) of one type; the received rows are
// read where they lie.  members: nb vectors (K6hb: x (nb, m), lo and hi
// (nb, H)), 1 for one.  The same slot order and round-to-nearest products
// and sums as the whole-vector kernel, so a slab's rows equal that
// kernel's rows of the whole vector bit for bit.  Replaces no TPU kernel:
// the JAX package forms these shifted slices with jnp outside any Pallas
// kernel (openmg_tpu/parallel/sparse_dist.py::_spmv_banded_local).
// Returns 0, a negative code for arguments the kernel does not take (an
// offset beyond H among them), or the CUDA error of the launch.
extern "C" int omg_spmv_banded_halo(
    const void* data, const int* offs_host, const int* offs_dev, int k,
    const void* x, const void* lo, const void* hi, long long H, void* y,
    long long m, int members, int is_double, void* stream)
{
    if (k < 1 || m < 1 || H < 0) return -1;
    if (members < 1 || (members + 7) / 8 > 65535) return -2;
    if (y == x || (H > 0 && (y == lo || y == hi))) return -3;
    for (int i = 0; i < k; ++i)
        if (offs_host[i] > H || -offs_host[i] > H) return -4;
    Slots sl;
    for (int i = 0; i < MAX_SLOTS; ++i) sl.d[i] = i < k ? offs_host[i] : 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_double)
        ell<double, true>(
            (const double*)data, sl, offs_dev, k, (const double*)x, (double*)y,
            m, members, st, Halo<double>{(const double*)lo, (const double*)hi, H});
    else
        ell<float, true>(
            (const float*)data, sl, offs_dev, k, (const float*)x, (float*)y,
            m, members, st, Halo<float>{(const float*)lo, (const float*)hi, H});
    return (int)cudaGetLastError();
}
