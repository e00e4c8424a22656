// SELL-32 SpMV of one weight plane:
//
//   y[row[r]] = sum_{j<J_s} w[j][r] * x[col[j][r]]
//
// for every row r of every slice s; a column >= n adds nothing.  The
// bioheat stage operator M_rc + gamma (K + M_w) is a matrix pair on one
// pattern; its solve forms the weight plane w = c0*w0 + c1*w1 once
// (ops/ell.py, MultiELLPair.combined) and every CG iteration streams that
// one plane.
//
// Replaces the TPU kernel ops/ell.py::_apply_w / _kernel_w of the JAX
// package (cardiac_ablation_ecm2_tpu), as MultiELLPair.mult_combined calls
// it; the port's mult_combined forms the plane and applies it here.  The
// TPU version cut the matrix into 128-lane row blocks with per-block
// source tables, in-register lane gathers, plane chunks of 8 and
// a final unpermuting gather, because scalar gathers are slow on a TPU.  A
// GPU gathers scalars natively, so the port keeps only the contract:
// natural row and column numbering, a sentinel column reads 0, nothing is
// scattered.
//
// Layout (ops/ell.py builds it): SELL-32-sigma.  Rows are sorted by width
// within windows of sigma rows (natural order among equal widths) and cut
// into slices of 32; slice s is as wide as its widest row, J_s, and stores
// its J_s planes of 32 int32 columns and weights plane-major from
// slice_ptr[s] = sum of 32 J over the slices before it, so a warp (one
// slice) reads 128 contiguous bytes of each plane.  row_ids[r] is the
// natural row of sorted row r: every output row is written once, nothing
// unpermutes and there are no atomics.
//
// What bounds it on an H100: bytes.  The least work reads the entries of
// one matrix (int32 column and one weight), the row ids, x and y once: at
// the 956,820-tet order-2 mesh (1,278,670 rows, 36,955,522 nnz) 311.0 MB
// in float32, 0.0928 ms at 3.35 TB/s.  One weight plane instead of two
// cuts the entry bytes from 12 to 8 (float32); slices of 32 pad the slots
// less than the old buckets of 8 entries (10%); each thread keeps kChunk =
// 16 independent column -> x load chains in flight (the chain is dependent
// within one entry; 16 was the fastest of 1, 2, 4, 8 and 16 at the n=66
// shape in 6 of 8 readings, PERF.md).  x (5 MB in float32) stays in L2, and the gathers stay
// local because rows and columns follow the Morton element order.
//
// Arithmetic order: the planes are summed in order j = 0..J_s-1, plane 0
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
constexpr int kChunk = 16;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock)
sell_spmv_kernel(const T* __restrict__ x, int64_t n,
                 const int32_t* __restrict__ cols, const T* __restrict__ w,
                 const int32_t* __restrict__ row_ids,
                 const int64_t* __restrict__ slice_ptr, int64_t nrows,
                 T* __restrict__ y) {
    const int64_t r = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x;
    if (r >= nrows) return;
    const int64_t s = r >> 5;
    const int64_t p0 = slice_ptr[s];
    const int J = static_cast<int>((slice_ptr[s + 1] - p0) >> 5);
    const int64_t base = p0 + (r & 31);
    T acc = T(0);
    for (int j0 = 0; j0 < J; j0 += kChunk) {
        int32_t c[kChunk];
        T wv[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const int64_t q = base + static_cast<int64_t>(j0 + k) * 32;
            const bool live = j0 + k < J;
            c[k] = live ? __ldg(cols + q) : static_cast<int32_t>(n);
            wv[k] = live ? __ldg(w + q) : T(0);
        }
        T xv[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) xv[k] = c[k] < n ? __ldg(x + c[k]) : T(0);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            if (j0 + k < J) {
                const T p = mul_rn(wv[k], xv[k]);
                acc = j0 + k == 0 ? p : add_rn(acc, p);
            }
        }
    }
    y[__ldg(row_ids + r)] = acc;
}

template <typename T>
int launch(const void* x, int64_t n, const void* cols, const void* w,
           const void* row_ids, const void* slice_ptr, int64_t nrows,
           int rows_per_block, void* y, void* stream) {
    const int64_t nblocks = (nrows + kRowsPerBlock - 1) / kRowsPerBlock;
    if (rows_per_block != kRowsPerBlock || nblocks < 1 || nblocks > 2147483647LL) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    sell_spmv_kernel<T><<<static_cast<unsigned>(nblocks), kRowsPerBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), n, static_cast<const int32_t*>(cols),
        static_cast<const T*>(w), static_cast<const int32_t*>(row_ids),
        static_cast<const int64_t*>(slice_ptr), nrows, static_cast<T*>(y));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* x, int64_t n, const void* cols, const void* w,
                 const void* row_ids, const void* slice_ptr, int64_t nrows,
                 int rows_per_block, void* y, void* stream) {
    return launch<float>(x, n, cols, w, row_ids, slice_ptr, nrows,
                         rows_per_block, y, stream);
}

int ell_spmv_f64(const void* x, int64_t n, const void* cols, const void* w,
                 const void* row_ids, const void* slice_ptr, int64_t nrows,
                 int rows_per_block, void* y, void* stream) {
    return launch<double>(x, n, cols, w, row_ids, slice_ptr, nrows,
                          rows_per_block, y, stream);
}

const char* ell_spmv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
