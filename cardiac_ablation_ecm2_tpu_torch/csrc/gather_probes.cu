// The three gather patterns of the Mosaic gather probes, for float and double
// data with int32 indices:
//
//   take_rows         out[i, :] = table[rows[i], :]          (row gather)
//   take_along_lanes  out[b, j] = mat[b, idx[b, j]]          (in-row lane gather)
//   take_along_rows   out[b, c] = table[idx[b, c], c]        (per-column row gather)
//
// An index outside the gathered axis reads 0 (no fault, no clamp).
//
// Replaces the TPU probe kernels of the JAX package's benchmarks/:
// gather_micro4.py::u3 (kernR) and ::u5 (kernD) by take_rows,
// gather_micro3.py::t2 (kern1) and gather_micro4.py::u2 (kernW) by
// take_along_lanes, gather_micro3.py::t1 (kern0) and gather_micro4.py::u1
// (kernA) by take_along_rows.  (gather_micro2.py::p1, a flat u[idx], runs on
// the gather_sum kernel with one plane.)  On the TPU each probe held its
// source in VMEM and measured how Mosaic lowers the pattern; none of that
// lowering carries over.
//
// What bounds them on an H100: bytes.  At the probes' shapes each source
// (3.65 MB) sits in the 50 MB L2, so the device-memory traffic is the index
// reads and the output writes, both coalesced:
// - take_rows: one warp per output row, 16-byte copies when the row length
//   and both base pointers allow (a 128-float row is one int4 per lane);
// - take_along_lanes: a block stages a tile of whole input rows in shared
//   memory with coalesced loads, then each thread reads smem[idx]; rows
//   wider than 48 KB read the row in device memory directly;
// - take_along_rows: one thread per output element, coalesced over c (the
//   table reads of a warp hit 32 rows, one sector each).
// Every kernel copies values, so it is bitwise equal to its plain PyTorch
// version (ops/gather_probes.py).  Making them faster is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC gather_probes.cu -o libgather_probes.so
// Each entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// shared-memory tile of the lane gather: rows of a block fill ~8 KB, at
// least one row; a row up to 48 KB (the default dynamic limit) still fits
constexpr int64_t kTileBytes = 8192;
constexpr int64_t kMaxTileBytes = 48 * 1024;

int grid_or_error(int64_t blocks, unsigned* grid) {
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    *grid = static_cast<unsigned>(blocks);
    return 0;
}

// ---------------------------------------------------------------- row gather
template <typename T>
__global__ void take_rows_kernel(const T* __restrict__ table, int64_t nrows,
                                 int64_t ncols, const int32_t* __restrict__ rows,
                                 int64_t nout, T* __restrict__ out, int vec) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
    const int lane = threadIdx.x & 31;
    if (i >= nout) return;
    const int32_t r = rows[i];
    const bool ok = r >= 0 && r < nrows;
    if (vec) {
        const int64_t nvec = ncols * static_cast<int64_t>(sizeof(T)) / 16;
        int4* d = reinterpret_cast<int4*>(out + i * ncols);
        const int4* s = reinterpret_cast<const int4*>(
            table + (ok ? static_cast<int64_t>(r) : 0) * ncols);
        for (int64_t v = lane; v < nvec; v += 32) {
            d[v] = ok ? __ldg(s + v) : make_int4(0, 0, 0, 0);
        }
    } else {
        T* d = out + i * ncols;
        const T* s = table + (ok ? static_cast<int64_t>(r) : 0) * ncols;
        for (int64_t c = lane; c < ncols; c += 32) d[c] = ok ? __ldg(s + c) : T(0);
    }
}

// --------------------------------------------------------------- lane gather
template <typename T>
__global__ void take_along_lanes_smem(const T* __restrict__ mat, int64_t nrows,
                                      int64_t width, const int32_t* __restrict__ idx,
                                      int64_t k, T* __restrict__ out,
                                      int64_t rows_per_block) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tile = reinterpret_cast<T*>(smem_raw);
    const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
    const int64_t nr = nrows - b0 < rows_per_block ? nrows - b0 : rows_per_block;
    const T* src = mat + b0 * width;
    const int64_t nin = nr * width;
    for (int64_t t = threadIdx.x; t < nin; t += kThreads) tile[t] = __ldg(src + t);
    __syncthreads();
    const int32_t* ib = idx + b0 * k;
    T* ob = out + b0 * k;
    const int64_t nk = nr * k;
    for (int64_t t = threadIdx.x; t < nk; t += kThreads) {
        const int64_t r = t / k;
        const int32_t j = ib[t];
        ob[t] = (j >= 0 && j < width) ? tile[r * width + j] : T(0);
    }
}

template <typename T>
__global__ void take_along_lanes_direct(const T* __restrict__ mat, int64_t nrows,
                                        int64_t width, const int32_t* __restrict__ idx,
                                        int64_t k, T* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (t >= nrows * k) return;
    const int64_t r = t / k;
    const int32_t j = idx[t];
    out[t] = (j >= 0 && j < width) ? __ldg(mat + r * width + j) : T(0);
}

// ------------------------------------------------------------- column gather
template <typename T>
__global__ void take_along_rows_kernel(const T* __restrict__ table, int64_t nrows,
                                       int64_t ncols, const int32_t* __restrict__ idx,
                                       int64_t nout, T* __restrict__ out) {
    const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (t >= nout) return;
    const int64_t c = t % ncols;
    const int32_t r = idx[t];
    out[t] = (r >= 0 && r < nrows) ? __ldg(table + static_cast<int64_t>(r) * ncols + c)
                                   : T(0);
}

// ------------------------------------------------------------------ launches
template <typename T>
int launch_take_rows(const void* table, int64_t nrows, int64_t ncols,
                     const void* rows, int64_t nout, void* out, void* stream) {
    unsigned grid;
    if (int rc = grid_or_error((nout + kWarps - 1) / kWarps, &grid)) return rc;
    const int vec = (ncols * static_cast<int64_t>(sizeof(T))) % 16 == 0
                    && reinterpret_cast<uintptr_t>(table) % 16 == 0
                    && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    take_rows_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(table), nrows, ncols,
        static_cast<const int32_t*>(rows), nout, static_cast<T*>(out), vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_take_along_lanes(const void* mat, int64_t nrows, int64_t width,
                            const void* idx, int64_t k, void* out, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    auto m = static_cast<const T*>(mat);
    auto ix = static_cast<const int32_t*>(idx);
    auto o = static_cast<T*>(out);
    const int64_t row_bytes = width * static_cast<int64_t>(sizeof(T));
    unsigned grid;
    if (row_bytes > kMaxTileBytes) {
        if (int rc = grid_or_error((nrows * k + kThreads - 1) / kThreads, &grid))
            return rc;
        take_along_lanes_direct<T><<<grid, kThreads, 0, st>>>(m, nrows, width, ix,
                                                              k, o);
    } else {
        int64_t rpb = row_bytes > 0 ? kTileBytes / row_bytes : 1;
        if (rpb < 1) rpb = 1;
        if (int rc = grid_or_error((nrows + rpb - 1) / rpb, &grid)) return rc;
        const size_t smem = static_cast<size_t>(rpb * row_bytes);
        take_along_lanes_smem<T><<<grid, kThreads, smem, st>>>(m, nrows, width, ix,
                                                               k, o, rpb);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_take_along_rows(const void* table, int64_t nrows, int64_t ncols,
                           const void* idx, int64_t nout, void* out, void* stream) {
    unsigned grid;
    if (int rc = grid_or_error((nout + kThreads - 1) / kThreads, &grid)) return rc;
    take_along_rows_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(table), nrows, ncols,
        static_cast<const int32_t*>(idx), nout, static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// table (nrows, ncols), rows (nout,), out (nout, ncols)
int take_rows_f32(const void* table, int64_t nrows, int64_t ncols,
                  const void* rows, int64_t nout, void* out, void* stream) {
    return launch_take_rows<float>(table, nrows, ncols, rows, nout, out, stream);
}

int take_rows_f64(const void* table, int64_t nrows, int64_t ncols,
                  const void* rows, int64_t nout, void* out, void* stream) {
    return launch_take_rows<double>(table, nrows, ncols, rows, nout, out, stream);
}

// mat (nrows, width), idx and out (nrows, k)
int take_along_lanes_f32(const void* mat, int64_t nrows, int64_t width,
                         const void* idx, int64_t k, void* out, void* stream) {
    return launch_take_along_lanes<float>(mat, nrows, width, idx, k, out, stream);
}

int take_along_lanes_f64(const void* mat, int64_t nrows, int64_t width,
                         const void* idx, int64_t k, void* out, void* stream) {
    return launch_take_along_lanes<double>(mat, nrows, width, idx, k, out, stream);
}

// table (nrows, ncols), idx and out (nout / ncols, ncols)
int take_along_rows_f32(const void* table, int64_t nrows, int64_t ncols,
                        const void* idx, int64_t nout, void* out, void* stream) {
    return launch_take_along_rows<float>(table, nrows, ncols, idx, nout, out, stream);
}

int take_along_rows_f64(const void* table, int64_t nrows, int64_t ncols,
                        const void* idx, int64_t nout, void* out, void* stream) {
    return launch_take_along_rows<double>(table, nrows, ncols, idx, nout, out, stream);
}

const char* gather_probes_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
