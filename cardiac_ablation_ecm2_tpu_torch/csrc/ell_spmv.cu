// Sliced-ELL SpMV of a matrix pair on one sparsity pattern:
//
//   y[row[r]] = sum_{j<J_b} (c0*w0[j][r] + c1*w1[j][r]) * x[col[j][r]]
//
// for every row r of every width bucket b; a column >= n adds nothing.
// The bioheat stage operator (M_rc + gamma (K + M_w)) is c0 = 1, c1 = gamma;
// the residual's (K + M_w) is c0 = 0, c1 = 1.  The combined weight is formed
// in registers, so the nnz-sized combined matrix is never written.
//
// Replaces the TPU kernel ops/ell.py::_apply_w / _kernel_w of the JAX
// package (cardiac_ablation_ecm2_tpu), as MultiELLPair.mult_combined calls
// it.  The TPU version cut the matrix into 128-lane row blocks with
// per-block source tables, in-register lane gathers, plane chunks of 8 and
// a final unpermuting gather, because scalar gathers are slow on a TPU.  A
// GPU gathers scalars natively, so the port keeps only the contract:
// natural row and column numbering, a sentinel column reads 0, nothing is
// scattered.
//
// Layout (ops/ell.py builds it): rows are grouped by nnz into buckets; the
// rows of bucket b keep their natural order, and its J_b x n_b planes of
// int32 columns and of both weights are stored plane-major from slot0_b, so
// a warp reads 32 consecutive slots of one plane.  meta[b] = {row0, n_b, J_b,
// slot0, blk0}: the bucket's offset into row_ids[], its rows, its width,
// its first slot and its first block.  One launch covers every bucket; a
// block finds its bucket from blk0.  One thread owns one row and writes it
// once: no atomics.
//
// What bounds it on an H100: bytes.  Per call it streams nnz x (4 B column +
// 2 x sizeof(T) weights) + n x (4 B row id + sizeof(T) y) and reads x
// (1,278,670 dofs, 36,955,522 nnz at the 956,820-tet order-2 mesh: about
// 0.46 GB in float32, 0.14 ms at 3.35 TB/s).  The planes are read coalesced;
// x gathers stay in L2 (5 MB in float32) and local, because rows and
// columns follow the Morton element order.
//
// Arithmetic order: the planes are summed in order j = 0..J_b-1, plane 0
// initialising the sum, with explicitly rounded multiplies and adds
// (__fmul_rn / __fadd_rn never contract into an FMA), the same operations
// as the plain PyTorch version (ops/ell.py::ell_spmv_plain), so the two agree
// bitwise on the card.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC ell_spmv.cu -o libell_spmv.so
// Each entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 256;
constexpr int kMeta = 5;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock)
ell_spmv_kernel(const T* __restrict__ x, int64_t n,
                const int32_t* __restrict__ cols, const T* __restrict__ w0,
                const T* __restrict__ w1, const int32_t* __restrict__ row_ids,
                const int64_t* __restrict__ meta, int nbuckets, T c0, T c1,
                T* __restrict__ y) {
    int b = 0;
    for (int k = 1; k < nbuckets; ++k) {
        if (static_cast<int64_t>(blockIdx.x) >= meta[k * kMeta + 4]) b = k;
    }
    const int64_t* m = meta + b * kMeta;
    const int64_t nb = m[1];
    const int64_t r =
        (static_cast<int64_t>(blockIdx.x) - m[4]) * kRowsPerBlock + threadIdx.x;
    if (r >= nb) return;
    const int J = static_cast<int>(m[2]);
    const int64_t base = m[3] + r;
    T acc = T(0);
#pragma unroll 4
    for (int j = 0; j < J; ++j) {
        const int64_t s = base + static_cast<int64_t>(j) * nb;
        const int32_t c = cols[s];
        const T wc = add_rn(mul_rn(c0, w0[s]), mul_rn(c1, w1[s]));
        const T xv = c < n ? __ldg(x + c) : T(0);
        const T p = mul_rn(wc, xv);
        acc = j == 0 ? p : add_rn(acc, p);
    }
    y[row_ids[m[0] + r]] = acc;
}

template <typename T>
int launch(const void* x, int64_t n, const void* cols, const void* w0,
           const void* w1, const void* row_ids, const void* meta, int nbuckets,
           int64_t nblocks, int rows_per_block, T c0, T c1, void* y,
           void* stream) {
    if (rows_per_block != kRowsPerBlock || nblocks < 1 || nblocks > 2147483647LL
        || nbuckets < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    ell_spmv_kernel<T><<<static_cast<unsigned>(nblocks), kRowsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), n, static_cast<const int32_t*>(cols),
        static_cast<const T*>(w0), static_cast<const T*>(w1),
        static_cast<const int32_t*>(row_ids), static_cast<const int64_t*>(meta),
        nbuckets, c0, c1, static_cast<T*>(y));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* x, int64_t n, const void* cols, const void* w0,
                 const void* w1, const void* row_ids, const void* meta,
                 int nbuckets, int64_t nblocks, int rows_per_block, float c0,
                 float c1, void* y, void* stream) {
    return launch<float>(x, n, cols, w0, w1, row_ids, meta, nbuckets, nblocks,
                         rows_per_block, c0, c1, y, stream);
}

int ell_spmv_f64(const void* x, int64_t n, const void* cols, const void* w0,
                 const void* w1, const void* row_ids, const void* meta,
                 int nbuckets, int64_t nblocks, int rows_per_block, double c0,
                 double c1, void* y, void* stream) {
    return launch<double>(x, n, cols, w0, w1, row_ids, meta, nbuckets, nblocks,
                          rows_per_block, c0, c1, y, stream);
}

const char* ell_spmv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
