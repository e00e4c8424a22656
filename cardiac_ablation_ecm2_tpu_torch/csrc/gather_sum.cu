// The L<->E element restriction on the card: three kernels.
//
//   gather_sum         out[i] = sum_{j<J} src[idx[j][i]], an index >= nsrc
//                      reads 0 (J = 1: the element-major L->E gather; J >= 2:
//                      a multi-plane gather-sum, kept for its callers)
//   gather_transpose   out[d*ne + e] = src[g[e*nd + d]]: L->E from the
//                      element-major (ne, nd) map into the transposed
//                      (nd, ne) layout the lane-major applies consume
//   segment_sum        out[i] = sum_{k=off[i]}^{off[i+1]-1} src[slot[k]]:
//                      E->L, the slots of each dof in ascending slot order
//
// Replaces the TPU kernel ops/block_gather.py::_apply / _kernel of the JAX
// package (cardiac_ablation_ecm2_tpu), which decomposed the gather into
// 128-lane row blocks, per-row source-block tables and in-register lane
// gathers because scalar gathers are slow on a TPU, and ran E->L as a sum
// of multiplicity planes because its segment-sum lowered badly.  A GPU
// gathers scalars natively, so none of that carries over.
//
// What bounds it on an H100: bytes.  The least work of one direction reads
// the gather map once (ne*nd int32), the source once and writes the output
// once: at the 995,336-hex order-2 mesh (26,874,072 slots, 8,092,657 dofs)
// 247.4 MB in float32, 0.0739 ms at 3.35 TB/s.  What the design does:
// * gather_transpose reads a tile of E consecutive elements' map entries
//   coalesced, gathers the source in element-major order (consecutive slots
//   of one element are neighbouring dofs, and the elements follow the
//   Morton order), stages the values in shared memory (row stride E + 1,
//   so neither the scattered stores nor the row reads conflict on a bank)
//   and writes nd contiguous rows of E values; the last tile is masked.
//   The old (nd, ne) gather walked the map by d, touching each element's
//   dofs 27 times further apart.
// * segment_sum reads each dof's slot list (int32) and its int64 offsets
//   instead of J sentinel-padded planes: no sentinel index is read, which
//   cuts the index bytes by 1/3 at J = 8 and by 6x on the tet space (up to
//   46 planes against a mean multiplicity of ~7.5).
// The sums run in a fixed order with no atomics: the first slot (plane)
// initialises the sum (no "0 +" that would turn -0.0 into +0.0), the
// others add in order; a dof without a slot is +0.0.  These are the
// operations of the plain PyTorch versions (ops/block_gather.py), so the
// two agree bitwise; a gather does no arithmetic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC gather_sum.cu -o libgather_sum.so
// Each entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T load_or_zero(const T* __restrict__ src,
                                          int64_t nsrc, int64_t g) {
    return g < nsrc ? __ldg(src + g) : T(0);
}

// J = 1, the plain gather: each thread owns kGatherPerThread outputs
// kThreads apart, so a warp's index and output accesses stay coalesced and
// a thread keeps four independent loads in flight.  Measured on an H100
// (700 W) at the 995,336-hex planes: 0.16 -> 0.12 ms element-major and
// 0.31 -> 0.26 ms transposed against one output per thread; the same
// change slowed the 8-plane sum (0.176 -> 0.208 ms), hence two kernels.
constexpr int kGatherPerThread = 4;

template <typename T>
__global__ void gather_kernel(const T* __restrict__ src, int64_t nsrc,
                              const int32_t* __restrict__ idx, int64_t nout,
                              T* __restrict__ out) {
    const int64_t base =
        static_cast<int64_t>(blockIdx.x) * (kThreads * kGatherPerThread)
        + threadIdx.x;
    T v[kGatherPerThread];
#pragma unroll
    for (int k = 0; k < kGatherPerThread; ++k) {
        const int64_t i = base + k * kThreads;
        v[k] = i < nout ? load_or_zero(src, nsrc, idx[i]) : T(0);
    }
#pragma unroll
    for (int k = 0; k < kGatherPerThread; ++k) {
        const int64_t i = base + k * kThreads;
        if (i < nout) out[i] = v[k];
    }
}

// J >= 2: one output per thread (its J gathers are already independent).
// Plane 0 initialises the sum, later planes add in order, a sentinel adds
// +0.0: the same operations, in the same order, as the plain version.
template <typename T>
__global__ void gather_sum_kernel(const T* __restrict__ src, int64_t nsrc,
                                  const int32_t* __restrict__ idx, int J,
                                  int64_t nout, T* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= nout) return;
    T acc = load_or_zero(src, nsrc, idx[i]);
    for (int j = 1; j < J; ++j) {
        acc += load_or_zero(src, nsrc, idx[static_cast<int64_t>(j) * nout + i]);
    }
    out[i] = acc;
}

// The transposing L->E.  A block owns the tile of `tile` (a power of two,
// 1 << tile_shift) consecutive elements starting at e0: it reads their
// tile*nd map entries (one contiguous run) four at a time per thread, so
// each thread keeps four gathers in flight, and stores value (e, d) at
// smem[d*(tile+1) + e].  After one barrier, consecutive threads write
// consecutive elements of one row d.
constexpr int kTransposeLoads = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_transpose_kernel(const T* __restrict__ src, int64_t nsrc,
                        const int32_t* __restrict__ g, int64_t ne, int nd,
                        int tile_shift, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tile_v = reinterpret_cast<T*>(smem_raw);
    const int tile = 1 << tile_shift;
    const int stride = tile + 1;
    const int64_t e0 = static_cast<int64_t>(blockIdx.x) << tile_shift;
    const int ecount = static_cast<int>(ne - e0 < tile ? ne - e0 : tile);
    const int nvals = ecount * nd;
    const int32_t* __restrict__ gb = g + e0 * nd;
    // (e, d) of k = threadIdx.x, advanced by kThreads = q*nd + r per step
    const int q = kThreads / nd, r = kThreads - q * nd;
    int e = threadIdx.x / nd, d = threadIdx.x - e * nd;
    for (int k0 = threadIdx.x; k0 < nvals; k0 += kTransposeLoads * kThreads) {
        T v[kTransposeLoads];
        int pos[kTransposeLoads];
#pragma unroll
        for (int u = 0; u < kTransposeLoads; ++u) {
            const int k = k0 + u * kThreads;
            v[u] = k < nvals ? load_or_zero(src, nsrc, gb[k]) : T(0);
            pos[u] = d * stride + e;
            e += q;
            d += r;
            if (d >= nd) {
                d -= nd;
                ++e;
            }
        }
#pragma unroll
        for (int u = 0; u < kTransposeLoads; ++u) {
            if (k0 + u * kThreads < nvals) tile_v[pos[u]] = v[u];
        }
    }
    __syncthreads();
    const int total = nd << tile_shift;
    for (int k = threadIdx.x; k < total; k += kThreads) {
        const int dd = k >> tile_shift;
        const int ee = k & (tile - 1);
        if (ee < ecount) out[static_cast<int64_t>(dd) * ne + e0 + ee] =
            tile_v[dd * stride + ee];
    }
}

// The sorted segment-sum E->L: one thread per dof, its slots in order.
// Measured on an H100 (700 W) at the 995,336-hex slot lists, 0.155-0.171
// ms against 0.200-0.216 for a block that first gathers its dofs' slot run
// into shared memory (coalesced slot reads) and then sums from there.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ src, const int32_t* __restrict__ slots,
                   const int64_t* __restrict__ off, int64_t nseg,
                   T* __restrict__ out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= nseg) return;
    int64_t k = off[i];
    const int64_t end = off[i + 1];
    T acc = T(0);
    if (k < end) acc = __ldg(src + __ldg(slots + k++));
#pragma unroll 4
    for (; k < end; ++k) acc += __ldg(src + __ldg(slots + k));
    out[i] = acc;
}

int grid_of(int64_t work, int64_t per_block, unsigned* blocks) {
    const int64_t b = (work + per_block - 1) / per_block;
    if (b < 1 || b > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    *blocks = static_cast<unsigned>(b);
    return 0;
}

template <typename T>
int launch(const void* src, int64_t nsrc, const void* idx, int J, int64_t nout,
           void* out, void* stream) {
    auto s = static_cast<const T*>(src);
    auto ix = static_cast<const int32_t*>(idx);
    auto o = static_cast<T*>(out);
    auto st = static_cast<cudaStream_t>(stream);
    unsigned blocks;
    const int rc = grid_of(nout, J == 1 ? kThreads * kGatherPerThread : kThreads,
                           &blocks);
    if (rc != 0) return rc;
    if (J == 1) {
        gather_kernel<T><<<blocks, kThreads, 0, st>>>(s, nsrc, ix, nout, o);
    } else {
        gather_sum_kernel<T><<<blocks, kThreads, 0, st>>>(s, nsrc, ix, J, nout, o);
    }
    return static_cast<int>(cudaGetLastError());
}

// Tiles of 128 elements; halved while the tile would exceed the 48 KB of
// static-size shared memory (nd > 46 in float64), down to 32.
template <typename T>
int launch_transpose(const void* src, int64_t nsrc, const void* g, int64_t ne,
                     int nd, void* out, void* stream) {
    if (nd < 1) return static_cast<int>(cudaErrorInvalidValue);
    int shift = 7;
    while (shift > 5 && static_cast<int64_t>(nd) * ((1 << shift) + 1) * sizeof(T)
                            > 48 * 1024) {
        --shift;
    }
    const size_t smem = static_cast<size_t>(nd) * ((1 << shift) + 1) * sizeof(T);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    unsigned blocks;
    const int rc = grid_of(ne, int64_t(1) << shift, &blocks);
    if (rc != 0) return rc;
    gather_transpose_kernel<T><<<blocks, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), nsrc, static_cast<const int32_t*>(g), ne, nd,
        shift, static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segment(const void* src, const void* slots, const void* off,
                   int64_t nseg, void* out, void* stream) {
    unsigned blocks;
    const int rc = grid_of(nseg, kThreads, &blocks);
    if (rc != 0) return rc;
    segment_sum_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(src), static_cast<const int32_t*>(slots),
        static_cast<const int64_t*>(off), nseg, static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gather_sum_f32(const void* src, int64_t nsrc, const void* idx, int J,
                   int64_t nout, void* out, void* stream) {
    return launch<float>(src, nsrc, idx, J, nout, out, stream);
}

int gather_sum_f64(const void* src, int64_t nsrc, const void* idx, int J,
                   int64_t nout, void* out, void* stream) {
    return launch<double>(src, nsrc, idx, J, nout, out, stream);
}

int gather_transpose_f32(const void* src, int64_t nsrc, const void* g,
                         int64_t ne, int nd, void* out, void* stream) {
    return launch_transpose<float>(src, nsrc, g, ne, nd, out, stream);
}

int gather_transpose_f64(const void* src, int64_t nsrc, const void* g,
                         int64_t ne, int nd, void* out, void* stream) {
    return launch_transpose<double>(src, nsrc, g, ne, nd, out, stream);
}

int segment_sum_f32(const void* src, const void* slots, const void* off,
                    int64_t nseg, void* out, void* stream) {
    return launch_segment<float>(src, slots, off, nseg, out, stream);
}

int segment_sum_f64(const void* src, const void* slots, const void* off,
                    int64_t nseg, void* out, void* stream) {
    return launch_segment<double>(src, slots, off, nseg, out, stream);
}

const char* gather_sum_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
