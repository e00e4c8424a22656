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
// What bounds them on an H100: bytes, and at the probes' shapes the bytes
// that cross between L2 and the SMs.  Every source (at most 12 MB) sits in
// the 50 MB L2, and a gather that lets each lane of a warp touch its own
// 32-byte sector moves a whole sector for every 4 or 8 bytes it uses and
// costs the SM's load pipeline a 128-byte line request for it.  Each kernel
// moves only sectors it uses whole:
//
// - take_rows: one warp per output row, 16-byte copies when the row length
//   and both base pointers allow (a 128-float row is one int4 per lane).
//
// - take_along_rows, strip branch: a block owns a strip of w adjacent
//   columns, w * sizeof(T) = kStripBytes (one sector of a table row), and
//   stages table[:, c0:c0+w] whole in shared memory with cp.async copies
//   (16 bytes where a strip row and the table's rows are whole 16-byte
//   units, else one element a copy).  It then walks a chunk of output rows:
//   idx[b, c0:c0+w] and out[b, c0:c0+w] are one sector each, every lookup
//   hits shared memory, and the first rows' indices load under the staging.
//   A warp covers 32 / w rows of w columns, one element a thread, so the
//   lookups of one instruction spread over every bank of the strip's rows.
//   Where the strip of R rows does not fit the 232,448 bytes a block may
//   have, w halves.  The grid is one block per strip and chunk, one block a
//   multiprocessor, fewer chunks where one would write fewer than
//   R / kStageRatio rows; a block has up to kStripThreads threads, each
//   holding kStripUnroll rows in flight.  Bound: the line requests of idx
//   and out (one per row and strip) and the staging, strips x chunks x R
//   sectors, through L2.
// - take_along_rows, direct branch, where even w = 1 does not fit (R above
//   58,112 floats or 29,056 doubles), or the output has fewer than
//   kStripMinRatio rows per table row: a strip block stages R rows before
//   its first lookup, and with few output rows the grid has too few chunks
//   to spread that staging over the multiprocessors.  Both branches were
//   read on an H100 80GB HBM3 at 700 W, float32, at B / R from 0.14 to 16
//   on t1's and u1's tables (PERF.md §6): the direct kernel wins to
//   B / R = 1, ties at 1.15 and loses from 3.3; on t1's 7,136-row table
//   strips read 0.0108 ms at 1 to 4 MiB of output, the direct kernel
//   0.0045-0.0108 ms.  One thread per output,
//   coalesced over c; the table reads of a warp hit 32 rows, one sector
//   each.
//
// - take_along_lanes, staged branch, for dense rows (K / W of at least
//   kDenseNum / kDenseDen, rows up to 48 KB): a block stages a kTileBytes
//   tile of whole input rows in shared memory with 16-byte cp.async copies
//   (one pass over mat, every sector used when K ~ W), its first idx loads
//   issued under the copies, then each thread gathers 4 outputs at a time
//   from shared memory (int4 idx, 16-byte stores).
// - take_along_lanes, direct branch, for sparse rows (and rows wider than
//   48 KB): no staging; each thread reads kLanesLoads indices (int4 where K
//   allows) and issues all its reads of mat[b, idx] through the read-only
//   cache before it stores any.  Only the sectors the indices touch move
//   (1 - e^-1 = 63% of them at K = W / 8).
//
// Every constant was chosen from readings on the card at the probes' shapes
// (``compare_kernels.py --variants``; PERF.md §6).  Those readings, like
// chip_smoke.py's, are of calls queued back to back on sources that stay in
// L2, so the byte bound they are set against (the least bytes over the HBM
// rate) is not a limit such a call has to respect.  Every kernel copies
// values, so it is bitwise equal to its plain PyTorch version
// (ops/gather_probes.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC gather_probes.cu -o libgather_probes.so
// Each entry point returns the first nonzero status of its attribute and
// device queries, else cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// shared memory a block may have: the default limit, and the H100's limit
// for dynamic memory after cudaFuncAttributeMaxDynamicSharedMemorySize
constexpr int64_t kDefaultSmem = 48 * 1024;
constexpr int64_t kMaxSmem = 232448;

// take_along_rows, strip branch
constexpr int kStripThreads = 1024; // the most threads a block
constexpr int kStripBytes = 32;     // first strip width, bytes of a table row
constexpr int kStripUnroll = 8;     // output rows a thread holds in flight
constexpr int64_t kStripMinRatio = 2;  // strips only for B >= kStripMinRatio * R
constexpr int kStageRatio = 4;      // a chunk writes at least R / kStageRatio rows

// take_along_lanes: staged where K * kDenseDen >= W * kDenseNum
constexpr int kDenseNum = 1;
constexpr int kDenseDen = 2;
constexpr int64_t kTileBytes = 16384;  // staged tile, at least one row
constexpr int kLanesUnroll = 2;       // vector items a thread holds, staged
constexpr int kLanesLoads = 8;        // reads in flight a thread, direct

int grid_or_error(int64_t blocks, unsigned* grid) {
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    *grid = static_cast<unsigned>(blocks);
    return 0;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ------------------------------------------------------------- small helpers
// asynchronous global -> shared copy of N bytes (4, 8 or 16)
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if constexpr (N == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
                     : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                     "n"(N)
                     : "memory");
    }
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// V consecutive indices (16 bytes when V = 4)
__device__ __forceinline__ void ld_idx(const int32_t* p, int32_t (&j)[4]) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    j[0] = v.x; j[1] = v.y; j[2] = v.z; j[3] = v.w;
}
__device__ __forceinline__ void ld_idx(const int32_t* p, int32_t (&j)[1]) {
    j[0] = __ldg(p);
}

// V consecutive outputs (16-byte stores when V = 4)
__device__ __forceinline__ void st_vec(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void st_vec(double* p, const double (&x)[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
}
template <typename T>
__device__ __forceinline__ void st_vec(T* p, const T (&x)[1]) { p[0] = x[0]; }

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
// Dense rows: a tile of rows_per_block whole rows staged in shared memory
// (16-byte copies when `E` = 16 / sizeof(T), else one element a copy), then
// vector items of V outputs (V divides k), kLanesUnroll of them in flight.
template <typename T, int V, int E>
__global__ void __launch_bounds__(kThreads)
take_along_lanes_staged(const T* __restrict__ mat, int64_t nrows, int64_t width,
                        const int32_t* __restrict__ idx, int64_t k,
                        T* __restrict__ out, int64_t rows_per_block) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* tile = reinterpret_cast<T*>(smem_raw);
    const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
    const int64_t nr = nrows - b0 < rows_per_block ? nrows - b0 : rows_per_block;
    const T* src = mat + b0 * width;
    const int nin = static_cast<int>(nr * width / E);       // at most 48 KB
    for (int t = threadIdx.x; t < nin; t += kThreads) {
        cp_async<E * sizeof(T)>(tile + t * E, src + t * E);
    }
    const int64_t kv = k / V;
    const int64_t nvec = nr * kv;
    const int32_t* ib = idx + b0 * k;
    T* ob = out + b0 * k;
    int64_t v = threadIdx.x;
    int32_t j[kLanesUnroll][V];
#pragma unroll
    for (int u = 0; u < kLanesUnroll; ++u) {
        const int64_t vu = v + u * kThreads;
        if (vu < nvec) ld_idx(ib + vu * V, j[u]);
    }
    cp_async_wait_all();
    __syncthreads();
    for (; v < nvec; v += kThreads * kLanesUnroll) {
        T x[kLanesUnroll][V];
#pragma unroll
        for (int u = 0; u < kLanesUnroll; ++u) {
            const int64_t vu = v + u * kThreads;
            if (vu < nvec) {
                const T* row = tile + (vu / kv) * width;
#pragma unroll
                for (int e = 0; e < V; ++e) {
                    const int32_t c = j[u][e];
                    x[u][e] = (c >= 0 && c < width) ? row[c] : T(0);
                }
            }
        }
#pragma unroll
        for (int u = 0; u < kLanesUnroll; ++u) {
            const int64_t vn = v + (u + kLanesUnroll) * kThreads;
            if (vn < nvec) ld_idx(ib + vn * V, j[u]);
        }
#pragma unroll
        for (int u = 0; u < kLanesUnroll; ++u) {
            const int64_t vu = v + u * kThreads;
            if (vu < nvec) st_vec(ob + vu * V, x[u]);
        }
    }
}

// Sparse or wide rows: vector items of V outputs (V divides k), straight from
// device memory through the read-only cache, kLanesLoads reads a thread
// issued before its first store.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
take_along_lanes_direct(const T* __restrict__ mat, int64_t width,
                        const int32_t* __restrict__ idx, int64_t kv, int64_t nvec,
                        T* __restrict__ out) {
    constexpr int U = kLanesLoads / V;
    const int64_t v0 = static_cast<int64_t>(blockIdx.x) * (kThreads * U) + threadIdx.x;
    int32_t j[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int64_t v = v0 + u * kThreads;
        if (v < nvec) ld_idx(idx + v * V, j[u]);
    }
    T x[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int64_t v = v0 + u * kThreads;
        if (v < nvec) {
            const T* row = mat + (v / kv) * width;
#pragma unroll
            for (int e = 0; e < V; ++e) {
                const int32_t c = j[u][e];
                x[u][e] = (c >= 0 && c < width) ? __ldg(row + c) : T(0);
            }
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int64_t v = v0 + u * kThreads;
        if (v < nvec) st_vec(out + v * V, x[u]);
    }
}

// ------------------------------------------------------------- column gather
// Strip branch: block (s, q) stages columns [s*w, s*w + w) of every table
// row in shared memory, rows w elements apart, and writes output rows
// [q*rows_per_chunk, (q+1)*rows_per_chunk) of the strip's ws columns (ws = w
// but for a narrower last strip): thread t takes column t % ws of rows
// t / ws + n * rstep.  The strip is staged with cp.async copies of E
// elements.
template <typename T, int E>
__global__ void __launch_bounds__(kStripThreads)
take_along_rows_strip(const T* __restrict__ table, int nrows, int64_t ncols,
                      const int32_t* __restrict__ idx, int64_t nb,
                      T* __restrict__ out, int w, int64_t rows_per_chunk) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* strip = reinterpret_cast<T*>(smem_raw);
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * w;
    const int ws = ncols - c0 < w ? static_cast<int>(ncols - c0) : w;
    const int gs = ws / E;                       // copies a table row
    const T* src = table + c0;
    for (int t = threadIdx.x; t < nrows * gs; t += blockDim.x) {
        const int r = t / gs;
        const int g = t - r * gs;
        cp_async<E * sizeof(T)>(strip + r * w + g * E,
                                src + static_cast<int64_t>(r) * ncols + g * E);
    }
    const int rstep = blockDim.x / ws;
    const bool active = threadIdx.x < rstep * ws;
    const int c = threadIdx.x % ws;
    const int64_t b0 = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
    const int64_t b1 = nb - b0 < rows_per_chunk ? nb : b0 + rows_per_chunk;
    int64_t b = b0 + threadIdx.x / ws;
    const int32_t* ic = idx + c0 + c;
    T* oc = out + c0 + c;
    // the first rows' indices load under the staging
    int32_t j[kStripUnroll];
#pragma unroll
    for (int u = 0; u < kStripUnroll; ++u) {
        const int64_t bu = b + static_cast<int64_t>(u) * rstep;
        j[u] = active && bu < b1 ? __ldg(ic + bu * ncols) : -1;
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) return;
    for (; b < b1; b += static_cast<int64_t>(rstep) * kStripUnroll) {
        T x[kStripUnroll];
#pragma unroll
        for (int u = 0; u < kStripUnroll; ++u) {
            x[u] = static_cast<unsigned>(j[u]) < static_cast<unsigned>(nrows)
                       ? strip[j[u] * w + c] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kStripUnroll; ++u) {
            const int64_t bn = b + static_cast<int64_t>(u + kStripUnroll) * rstep;
            if (bn < b1) j[u] = __ldg(ic + bn * ncols);
        }
#pragma unroll
        for (int u = 0; u < kStripUnroll; ++u) {
            const int64_t bu = b + static_cast<int64_t>(u) * rstep;
            if (bu < b1) oc[bu * ncols] = x[u];
        }
    }
}

// Direct branch: one thread per output, coalesced over c.
template <typename T>
__global__ void take_along_rows_direct(const T* __restrict__ table, int64_t nrows,
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
                    && aligned16(table) && aligned16(out);
    take_rows_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(table), nrows, ncols,
        static_cast<const int32_t*>(rows), nout, static_cast<T*>(out), vec);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, int E>
int launch_lanes_staged(const T* m, int64_t nrows, int64_t width, const int32_t* ix,
                        int64_t k, T* o, cudaStream_t st) {
    const int64_t row_bytes = width * static_cast<int64_t>(sizeof(T));
    const int64_t rpb = kTileBytes / row_bytes > 1 ? kTileBytes / row_bytes : 1;
    unsigned grid;
    if (int rc = grid_or_error((nrows + rpb - 1) / rpb, &grid)) return rc;
    take_along_lanes_staged<T, V, E><<<grid, kThreads, rpb * row_bytes, st>>>(
        m, nrows, width, ix, k, o, rpb);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_lanes_direct(const T* m, int64_t nrows, int64_t width, const int32_t* ix,
                        int64_t k, T* o, cudaStream_t st) {
    constexpr int64_t per_block = static_cast<int64_t>(kThreads) * (kLanesLoads / V);
    const int64_t nvec = nrows * k / V;
    unsigned grid;
    if (int rc = grid_or_error((nvec + per_block - 1) / per_block, &grid)) return rc;
    take_along_lanes_direct<T, V><<<grid, kThreads, 0, st>>>(m, width, ix, k / V, nvec, o);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_lanes_kind(bool staged, bool vec_stage, const T* m, int64_t nrows,
                      int64_t width, const int32_t* ix, int64_t k, T* o,
                      cudaStream_t st) {
    constexpr int E = 16 / sizeof(T);
    if (!staged) return launch_lanes_direct<T, V>(m, nrows, width, ix, k, o, st);
    return vec_stage ? launch_lanes_staged<T, V, E>(m, nrows, width, ix, k, o, st)
                     : launch_lanes_staged<T, V, 1>(m, nrows, width, ix, k, o, st);
}

template <typename T>
int launch_take_along_lanes(const void* mat, int64_t nrows, int64_t width,
                            const void* idx, int64_t k, void* out, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    auto m = static_cast<const T*>(mat);
    auto ix = static_cast<const int32_t*>(idx);
    auto o = static_cast<T*>(out);
    const int64_t row_bytes = width * static_cast<int64_t>(sizeof(T));
    // the branch: staged for dense rows that fit the default shared memory
    const bool staged = width > 0 && row_bytes <= kDefaultSmem
                        && k * kDenseDen >= width * kDenseNum;
    // items of 4 outputs where k and the pointers allow
    const bool vec = k % 4 == 0 && aligned16(idx) && aligned16(out);
    // 16-byte staging copies where rows and the base pointer allow
    const bool vec_stage = row_bytes % 16 == 0 && aligned16(mat);
    return vec ? launch_lanes_kind<T, 4>(staged, vec_stage, m, nrows, width, ix, k, o, st)
               : launch_lanes_kind<T, 1>(staged, vec_stage, m, nrows, width, ix, k, o, st);
}

// cp.async copies of E elements
template <typename T, int E>
int launch_rows_strip(const T* t, int64_t nrows, int64_t ncols, const int32_t* ix,
                      int64_t nb, T* o, int w, cudaStream_t st) {
    auto kernel = take_along_rows_strip<T, E>;
    const int64_t smem = nrows * w * static_cast<int64_t>(sizeof(T));
    cudaError_t rc = cudaSuccess;
    if (smem > kDefaultSmem) {
        rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem));
        if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    // chunks: one block a multiprocessor, fewer where a chunk would write
    // fewer than nrows / kStageRatio rows
    int dev = 0, nsm = 0;
    if ((rc = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(rc);
    if ((rc = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))
        != cudaSuccess)
        return static_cast<int>(rc);
    const int64_t strips = (ncols + w - 1) / w;
    int64_t chunks = nsm / strips;
    const int64_t by_rows = nrows > 0 ? nb * kStageRatio / nrows : nb;
    if (by_rows < chunks) chunks = by_rows;
    if (chunks < 1) chunks = 1;
    if (chunks > nb) chunks = nb;
    const int64_t rows_per_chunk = (nb + chunks - 1) / chunks;
    chunks = (nb + rows_per_chunk - 1) / rows_per_chunk;
    if (strips > 2147483647LL || chunks > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    // threads: kStripUnroll rows each, whole warps, at most kStripThreads
    const int64_t items = (rows_per_chunk * w + kStripUnroll - 1) / kStripUnroll;
    const int threads = items >= kStripThreads ? kStripThreads
                                                : static_cast<int>((items + 31) / 32 * 32);
    const dim3 grid(static_cast<unsigned>(strips), static_cast<unsigned>(chunks));
    kernel<<<grid, threads, static_cast<size_t>(smem), st>>>(
        t, static_cast<int>(nrows), ncols, ix, nb, o, w, rows_per_chunk);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_take_along_rows(const void* table, int64_t nrows, int64_t ncols,
                           const void* idx, int64_t nout, void* out, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    auto t = static_cast<const T*>(table);
    auto ix = static_cast<const int32_t*>(idx);
    auto o = static_cast<T*>(out);
    // the widest strip (one sector a row, at most ncols) whose rows fit
    int w = kStripBytes / static_cast<int>(sizeof(T));
    while (w > 1 && (w / 2 >= ncols || nrows * w * static_cast<int64_t>(sizeof(T)) > kMaxSmem))
        w /= 2;
    const int64_t row_bytes = w * static_cast<int64_t>(sizeof(T));
    const int64_t nb = nout / ncols;
    if (nb >= kStripMinRatio * nrows && nrows * row_bytes <= kMaxSmem) {
        // 16-byte copies where a strip row and the table's rows are whole
        // 16-byte units
        const bool aligned = row_bytes % 16 == 0
                             && ncols * static_cast<int64_t>(sizeof(T)) % 16 == 0
                             && aligned16(table);
        constexpr int E = 16 / sizeof(T);
        return aligned ? launch_rows_strip<T, E>(t, nrows, ncols, ix, nb, o, w, st)
                       : launch_rows_strip<T, 1>(t, nrows, ncols, ix, nb, o, w, st);
    }
    unsigned grid;
    if (int rc = grid_or_error((nout + kThreads - 1) / kThreads, &grid)) return rc;
    take_along_rows_direct<T><<<grid, kThreads, 0, st>>>(t, nrows, ncols, ix, nout, o);
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
