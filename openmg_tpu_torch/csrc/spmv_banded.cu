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
// Replaces openmg_tpu/ops/ell.py::spmv_ell (body _dia_kernel), which streams
// data and a three-tile window of x and forms each shift with sublane slices
// and lane rolls, and openmg_tpu/ops/bsr.py::spmv_bsr (body _bsr_kernel),
// which builds the block replicas z_j[r] = x[r - r%B + j] in registers with
// lane rolls and needed B to divide 128 (block size 3 was refused there).
//
// What bounds it on an H100: bytes.  One multiply and one add per stored
// element against its 4 bytes (8 in float64), plus x read and y written
// once: far below the card's flop:byte ratio.
//
// What the design does (the simple, right version):
//   * One thread per row r = I*B + i, grid-stride, any B.  For each (j, s)
//     the data read data[(s*B + j)*n + r] is coalesced across a warp
//     (neighbouring rows are neighbouring addresses).  The x read
//     x[(I + d_s)*B + j] is the same address for the B threads of a block
//     row, so a warp touches about 32/B consecutive elements of x per term,
//     and the slots of a narrow band hit the same lines of L1/L2.
//   * The block size is a template parameter for the sizes the solves use
//     (1, 2, 3, 4), so I = r / B is a constant division and the j loop is
//     unrolled; other sizes take the same body with B read at run time.
//   * The column indices are never read: the offsets are trusted as in the
//     JAX package.  They come from a small device array, so any slot count
//     works (coarse Galerkin levels of vector problems have tens of slots).
//   * x is read only where 0 <= I + d_s < n/B; elsewhere the term is
//     data * 0, as in the plain versions, and no address outside x is ever
//     formed into a load.
//   * The sum runs with the block column j outer and the slot s inner with
//     __fmul_rn / __fadd_rn (and their double twins), which nvcc never
//     contracts into a fused multiply-add.  That is the order of
//     openmg_tpu_torch/ops/bsr.py::spmv_banded_plain, and for B = 1 the
//     slot order of openmg_tpu_torch/ops/ell.py::spmv_banded_plain, so the
//     kernel equals each bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// BC > 0: the block size at compile time; BC == 0: B at run time.
template <typename T, int BC>
__global__ void spmv_banded_kernel(
    const T* __restrict__ data, const int* __restrict__ offs, int k,
    int b_run, const T* __restrict__ x, T* __restrict__ y, long long n)
{
    const int B = BC > 0 ? BC : b_run;
    const long long nbr = n / B;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < n; r += stride) {
        const long long I = r / B;
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < B; ++j) {
            for (int s = 0; s < k; ++s) {
                const long long J = I + __ldg(offs + s);
                const T xv = (J >= 0 && J < nbr) ? __ldg(x + J * B + j) : T(0);
                const T t = mul_rn(
                    __ldg(data + ((long long)s * B + j) * n + r), xv);
                // the first term by its indices, not by a flag carried
                // through the loop: with a flag nvcc does not batch the
                // loads of the slot loop, and on an H100 K6 ran 16 % and
                // K7 at kb 27 45 % slower
                acc = (j == 0 && s == 0) ? t : add_rn(acc, t);
            }
        }
        y[r] = acc;
    }
}

constexpr int THREADS = 256;

int blocks_for(long long n)
{
    long long b = (n + THREADS - 1) / THREADS;
    const long long cap = 132LL * 16;  // enough blocks to fill every SM
    return (int)(b < cap ? (b < 1 ? 1 : b) : cap);
}

template <typename T>
void launch(const T* data, const int* offs, int k, int B, const T* x, T* y,
            long long n, cudaStream_t st)
{
    const int g = blocks_for(n);
    switch (B) {
    case 1: spmv_banded_kernel<T, 1><<<g, THREADS, 0, st>>>(data, offs, k, B, x, y, n); break;
    case 2: spmv_banded_kernel<T, 2><<<g, THREADS, 0, st>>>(data, offs, k, B, x, y, n); break;
    case 3: spmv_banded_kernel<T, 3><<<g, THREADS, 0, st>>>(data, offs, k, B, x, y, n); break;
    case 4: spmv_banded_kernel<T, 4><<<g, THREADS, 0, st>>>(data, offs, k, B, x, y, n); break;
    default: spmv_banded_kernel<T, 0><<<g, THREADS, 0, st>>>(data, offs, k, B, x, y, n); break;
    }
}

}  // namespace

// data (k, B, n) and x, y (n,) of one type (is_double: float64, else
// float32); offs (k,) int32 block offsets, on the device.  An ELL matrix is
// B = 1.  Returns 0, or a negative code for arguments the kernel does not
// take, or the CUDA error of the launch.
extern "C" int omg_spmv_banded(
    const void* data, const int* offs, int k, int B, const void* x, void* y,
    long long n, int is_double, void* stream)
{
    if (k < 1 || B < 1 || n < 1 || n % B) return -1;
    if (y == x) return -3;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_double)
        launch<double>((const double*)data, offs, k, B, (const double*)x,
                       (double*)y, n, st);
    else
        launch<float>((const float*)data, offs, k, B, (const float*)x,
                      (float*)y, n, st);
    return (int)cudaGetLastError();
}
