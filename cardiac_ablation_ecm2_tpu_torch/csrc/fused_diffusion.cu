// Fused element-major diffusion apply on hexahedra, packed symmetric qdata:
//
//   y_e = sum_s G_s^T (D_e (G e))_s,   G_x = B(x)B(x)G, G_y = B(x)G(x)B,
//                                      G_z = G(x)B(x)B
//
// e (ne, nd) and y (ne, nd) with nd = n1^3 lex dofs (x fastest); qdata
// (6, ne, nq) with nq = nq1^3 lex points (x fastest), packed as
// [D00, D11, D22, D01, D02, D12]; B1 and G1 are the (nq1, n1) 1D value and
// derivative matrices.  A qdata element stride of 0 broadcasts one
// element's qdata to all (collapsed uniform qdata).  The qdata may also be
// stored in bfloat16 beside float32 e and y (the bioheat operator's
// qdata_bf16): each value is converted to float as it is loaded, so the
// qdata stream is halved and the arithmetic stays float32.
//
// Replaces the TPU kernel ops/pallas_kernels.py::diffusion_apply_pallas /
// _kernel_3d of the JAX package (cardiac_ablation_ecm2_tpu).  The TPU
// version multiplied by the full Kronecker matrices G_s (nq x nd) because
// Mosaic rejects the 4-D reshapes of the sum-factorized form; at order 4
// those matrices would not fit a block's shared memory.  Here the chain is
// sum-factorized in shared memory, one 1D contraction per pass:
//
//   u --x--> (AB, AG) --y--> (C_GB, C_BG, C_BB) --z--> (gx, gy, gz)
//     --packed D--> (Dx, Dy, Dz) --z^T--> (Px, Py, Pz) --y^T--> (S_G, S_B)
//     --x^T--> y
//
// A block owns a tile of E consecutive elements (E from the shared-memory
// budget; the last tile may be short, so any ne works) and runs every pass
// over (element, entry) pairs, consecutive threads on consecutive entries.
// The tile's dofs are read once, coalesced, into shared memory; each
// quadrature point's six qdata values are read once, coalesced, in the
// z pass where the flux is formed; each output is written once, coalesced,
// by the last pass.  No atomics.
//
// What bounds it on an H100: bytes.  Per call it must move
// ne x (2 nd + 6 nq) x sizeof(T): at the 1,000,188-element order-2 lattice
// (nd = nq = 27) in float32, 0.86 GB, 0.26 ms at 3.35 TB/s, against some
// 3,000 flops per element (3 GFLOP, 0.05 ms at 67 TFLOP/s).  Shared-memory
// traffic (two reads per multiply-add) is the next limit.  Tensor cores,
// TMA and a deeper pipeline are later work.
//
// With bfloat16 qdata the bytes are ne x (2 nd x 4 + 6 nq x 2): 0.54 GB
// at that size, 0.16 ms.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC fused_diffusion.cu -o libfused_diffusion.so
// Each entry point returns cudaGetLastError() after the launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 40 * 1024;   // bytes of tile buffers per block

template <typename T, int N1, int Q1>
struct Tile {
    static constexpr int ND = N1 * N1 * N1;
    static constexpr int NQ = Q1 * Q1 * Q1;
    static constexpr int S1 = N1 * N1 * Q1;        // after the x pass
    static constexpr int S2 = N1 * Q1 * Q1;        // after the y pass
    static constexpr int per_elem = (ND + 6 * NQ) * static_cast<int>(sizeof(T));
    static constexpr int raw = kSmemBudget / per_elem;
    static constexpr int E = raw < 1 ? 1 : (raw > 64 ? 64 : raw);
};

// One qdata value in the arithmetic type: as stored, or bfloat16 widened.
template <typename T>
__device__ __forceinline__ T load_q(const T* p) { return *p; }
__device__ __forceinline__ float load_q(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

template <typename T, typename TQ, int N1, int Q1>
__global__ void __launch_bounds__(kThreads)
diffusion_kernel(const T* __restrict__ e, const TQ* __restrict__ qd,
                 int64_t q_plane, int64_t q_elem, const T* __restrict__ B1,
                 const T* __restrict__ G1, int64_t ne, T* __restrict__ out) {
    using Tl = Tile<T, N1, Q1>;
    constexpr int ND = Tl::ND, NQ = Tl::NQ, S1 = Tl::S1, S2 = Tl::S2, E = Tl::E;

    __shared__ T sB[Q1 * N1];
    __shared__ T sG[Q1 * N1];
    __shared__ T su[E * ND];
    __shared__ T sx[3 * E * NQ];   // three sub-buffers, element stride NQ
    __shared__ T sy[3 * E * NQ];
    T* const x0 = sx;
    T* const x1 = sx + E * NQ;
    T* const x2 = sx + 2 * E * NQ;
    T* const y0 = sy;
    T* const y1 = sy + E * NQ;
    T* const y2 = sy + 2 * E * NQ;

    const int64_t e0 = static_cast<int64_t>(blockIdx.x) * E;
    const int ecount = static_cast<int>(ne - e0 < E ? ne - e0 : E);
    const int tid = threadIdx.x;

    for (int t = tid; t < Q1 * N1; t += kThreads) {
        sB[t] = B1[t];
        sG[t] = G1[t];
    }
    for (int t = tid; t < ecount * ND; t += kThreads) su[t] = e[e0 * ND + t];
    __syncthreads();

    // x pass: u[k][j][i] -> AB, AG [k][j][a]
    for (int t = tid; t < ecount * S1; t += kThreads) {
        const int el = t / S1, r = t % S1;
        const int a = r % Q1, kj = r / Q1;
        const T* u = su + el * ND + kj * N1;
        T sb = T(0), sg = T(0);
#pragma unroll
        for (int i = 0; i < N1; ++i) {
            sb += sB[a * N1 + i] * u[i];
            sg += sG[a * N1 + i] * u[i];
        }
        x0[el * NQ + r] = sb;
        x1[el * NQ + r] = sg;
    }
    __syncthreads();

    // y pass: -> C_GB = B.AG, C_BG = G.AB, C_BB = B.AB   [k][b][a]
    for (int t = tid; t < ecount * S2; t += kThreads) {
        const int el = t / S2, r = t % S2;
        const int a = r % Q1, b = (r / Q1) % Q1, k = r / (Q1 * Q1);
        const T* ab = x0 + el * NQ + k * N1 * Q1 + a;
        const T* ag = x1 + el * NQ + k * N1 * Q1 + a;
        T gb = T(0), bg = T(0), bb = T(0);
#pragma unroll
        for (int j = 0; j < N1; ++j) {
            const T vb = ab[j * Q1], vg = ag[j * Q1];
            gb += sB[b * N1 + j] * vg;
            bg += sG[b * N1 + j] * vb;
            bb += sB[b * N1 + j] * vb;
        }
        y0[el * NQ + r] = gb;
        y1[el * NQ + r] = bg;
        y2[el * NQ + r] = bb;
    }
    __syncthreads();

    // z pass and flux: gx = B.C_GB, gy = B.C_BG, gz = G.C_BB at [c][b][a],
    // then D g with the point's six packed qdata values
    for (int t = tid; t < ecount * NQ; t += kThreads) {
        const int el = t / NQ, r = t % NQ;
        const int ba = r % (Q1 * Q1), c = r / (Q1 * Q1);
        const T* cgb = y0 + el * NQ + ba;
        const T* cbg = y1 + el * NQ + ba;
        const T* cbb = y2 + el * NQ + ba;
        T gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
        for (int k = 0; k < N1; ++k) {
            const T bc = sB[c * N1 + k];
            gx += bc * cgb[k * Q1 * Q1];
            gy += bc * cbg[k * Q1 * Q1];
            gz += sG[c * N1 + k] * cbb[k * Q1 * Q1];
        }
        const TQ* q = qd + (e0 + el) * q_elem + r;
        const T d00 = load_q(q), d11 = load_q(q + q_plane);
        const T d22 = load_q(q + 2 * q_plane), d01 = load_q(q + 3 * q_plane);
        const T d02 = load_q(q + 4 * q_plane), d12 = load_q(q + 5 * q_plane);
        x0[el * NQ + r] = d00 * gx + d01 * gy + d02 * gz;
        x1[el * NQ + r] = d01 * gx + d11 * gy + d12 * gz;
        x2[el * NQ + r] = d02 * gx + d12 * gy + d22 * gz;
    }
    __syncthreads();

    // z^T pass: Px = B^T.Dx, Py = B^T.Dy, Pz = G^T.Dz   [k][b][a]
    for (int t = tid; t < ecount * S2; t += kThreads) {
        const int el = t / S2, r = t % S2;
        const int ba = r % (Q1 * Q1), k = r / (Q1 * Q1);
        const T* dx = x0 + el * NQ + ba;
        const T* dy = x1 + el * NQ + ba;
        const T* dz = x2 + el * NQ + ba;
        T px = T(0), py = T(0), pz = T(0);
#pragma unroll
        for (int c = 0; c < Q1; ++c) {
            const T bc = sB[c * N1 + k];
            px += bc * dx[c * Q1 * Q1];
            py += bc * dy[c * Q1 * Q1];
            pz += sG[c * N1 + k] * dz[c * Q1 * Q1];
        }
        y0[el * NQ + r] = px;
        y1[el * NQ + r] = py;
        y2[el * NQ + r] = pz;
    }
    __syncthreads();

    // y^T pass: S_G = B^T.Px, S_B = G^T.Py + B^T.Pz   [k][j][a]
    for (int t = tid; t < ecount * S1; t += kThreads) {
        const int el = t / S1, r = t % S1;
        const int a = r % Q1, j = (r / Q1) % N1, k = r / (N1 * Q1);
        const T* px = y0 + el * NQ + k * Q1 * Q1 + a;
        const T* py = y1 + el * NQ + k * Q1 * Q1 + a;
        const T* pz = y2 + el * NQ + k * Q1 * Q1 + a;
        T sg = T(0), sb = T(0);
#pragma unroll
        for (int b = 0; b < Q1; ++b) {
            const T bj = sB[b * N1 + j];
            sg += bj * px[b * Q1];
            sb += sG[b * N1 + j] * py[b * Q1] + bj * pz[b * Q1];
        }
        x0[el * NQ + r] = sg;
        x1[el * NQ + r] = sb;
    }
    __syncthreads();

    // x^T pass: y[k][j][i] = G^T.S_G + B^T.S_B, written once, coalesced
    for (int t = tid; t < ecount * ND; t += kThreads) {
        const int el = t / ND, r = t % ND;
        const int i = r % N1, kj = r / N1;
        const T* sg = x0 + el * NQ + kj * Q1;
        const T* sb = x1 + el * NQ + kj * Q1;
        T acc = T(0);
#pragma unroll
        for (int a = 0; a < Q1; ++a) {
            acc += sG[a * N1 + i] * sg[a] + sB[a * N1 + i] * sb[a];
        }
        out[e0 * ND + t] = acc;
    }
}

template <typename T, typename TQ, int N1, int Q1>
int launch_one(const void* e, const void* qd, int64_t q_plane, int64_t q_elem,
               const void* B1, const void* G1, int64_t ne, void* out,
               cudaStream_t st) {
    constexpr int E = Tile<T, N1, Q1>::E;
    const int64_t blocks = (ne + E - 1) / E;
    if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
    diffusion_kernel<T, TQ, N1, Q1><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(e), static_cast<const TQ*>(qd), q_plane, q_elem,
        static_cast<const T*>(B1), static_cast<const T*>(G1), ne,
        static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

// n1 in 2..5 and nq1 in {n1, n1 + 1}: orders 1-4 at quad_extra 0 and 1.
template <typename T, typename TQ>
int launch(const void* e, const void* qd, int64_t q_plane, int64_t q_elem,
           const void* B1, const void* G1, int n1, int nq1, int64_t ne,
           void* out, void* stream) {
    auto st = static_cast<cudaStream_t>(stream);
    if (ne <= 0) return 0;
#define FD_CASE(N, Q)                                                        \
    if (n1 == N && nq1 == Q)                                                 \
        return launch_one<T, TQ, N, Q>(e, qd, q_plane, q_elem, B1, G1, ne, out, st);
    FD_CASE(2, 2) FD_CASE(2, 3) FD_CASE(3, 3) FD_CASE(3, 4)
    FD_CASE(4, 4) FD_CASE(4, 5) FD_CASE(5, 5) FD_CASE(5, 6)
#undef FD_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int fused_diffusion_f32(const void* e, const void* qd, int64_t q_plane,
                        int64_t q_elem, const void* B1, const void* G1, int n1,
                        int nq1, int64_t ne, void* out, void* stream) {
    return launch<float, float>(e, qd, q_plane, q_elem, B1, G1, n1, nq1, ne, out,
                                stream);
}

int fused_diffusion_f32_bf16q(const void* e, const void* qd, int64_t q_plane,
                              int64_t q_elem, const void* B1, const void* G1,
                              int n1, int nq1, int64_t ne, void* out,
                              void* stream) {
    return launch<float, __nv_bfloat16>(e, qd, q_plane, q_elem, B1, G1, n1, nq1,
                                        ne, out, stream);
}

int fused_diffusion_f64(const void* e, const void* qd, int64_t q_plane,
                        int64_t q_elem, const void* B1, const void* G1, int n1,
                        int nq1, int64_t ne, void* out, void* stream) {
    return launch<double, double>(e, qd, q_plane, q_elem, B1, G1, n1, nq1, ne, out,
                                  stream);
}

const char* fused_diffusion_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
