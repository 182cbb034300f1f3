// direct_stencil: the direct-form CME stencil SpMV on the masked
// power-of-two box for models whose propensities do not factor per species
// (coupled expressions such as k/(1+X*Y), and custom propensity callables),
// for NVIDIA Hopper (sm_90a), in float64 and float32.
//
// Replaces two TPU kernels of krylovfspssa_tpu/ops/pallas_stencil.py that
// compute one function: make_pallas_stencil_matvec_v2 (B5, :2153, the TPU's
// only kernel for such models) and make_pallas_stencil_matvec (B6, v1, :66).
// It computes the math of ops/stencil.py's make_stencil_matvec (direct
// branch), not their tiling.  For each cell z < vol:
//
//   xm       = mask * x
//   c_s(z)   = (z >> shift_s) & (ext_s - 1)
//   valid_k  = prod_{s moved by k} [0 <= c_s(z) - nu_{k,s} < ext_s]
//   y[z]     = mask[z] * ( sum_k valid_k(z) * F_k[src_k] * xm[src_k]
//                          - (sum_k F_k[z]) * xm[z] ),
//   src_k    = (z - off_k) & (vol - 1)
//
// F_k is the propensity field of reaction k on this box geometry, evaluated
// once per geometry by the wrapper (ops/stencil.py propensity_fields): a
// kernel cannot run a user's Python callable, so it reads fields instead of
// evaluating expressions as the TPU kernel does.
//
// Validity is tested per moved species.  Unlike box_stencil's shifted
// tables, a field holds a genuine (non-zero) propensity at a wrapped or
// out-of-box predecessor, so the test cannot be baked into the operands.
// Products are taken as F_k * xm and rounded before they are added (no FMA
// contraction), in the plain version's order, so that inf*0 gives the same
// NaN and a float64 result the same bits as the plain version.  The
// diagonal sums all R fields, including reactions whose target leaves the
// box: that is the FSP truncation (reference FMATVEC,
// KrylovSolver.f90:577-607).
//
// What bounds it: device memory.  Per active cell it reads x, mask, the R
// fields at z (diagonal) and at the R predecessors, and the predecessors' x
// and mask, and writes y.  The field reads at z - off_k hit the same arrays
// as their neighbours' diagonal reads, so the compulsory traffic is
// (R + 2) words + 1 byte per cell: at 2^22 cells with R = 10 in float64
// that is 407 MB, an HBM floor of 121 us at 3.35 TB/s.  Predecessors more
// than a few MB back (high-bit species) miss L2 and can double the field
// traffic.  Arithmetic is ~3R operations per cell, far below the card's
// rate.  Design: one thread per cell in a grid-stride loop, as box_stencil
// does, so neighbouring threads read neighbouring addresses of every
// array (each offset is constant per reaction); offsets and validity meta
// are staged once per block in shared memory.  TMA, tiling over the offset
// window (to reuse p_k = F_k * xm between the diagonal and the inflow), and
// evaluating the expression in registers instead of reading fields are
// left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (see ops/stencil_cuda.py).  Plain C entry points, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr size_t kSmemLimit = 48 * 1024;

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// meta (int32) layout:
//   off[R]            flat offset of each reaction
//   start[R + 1]      moved species of reaction k are mv[start[k] .. start[k+1])
//   mv[3 * n_moved]   (shift, extent - 1, nu) per moved species
template <typename T>
__global__ void __launch_bounds__(kThreads)
direct_stencil_kernel(const T* __restrict__ x,
                      const uint8_t* __restrict__ mask,
                      const T* __restrict__ fields,
                      const int* __restrict__ meta,
                      T* __restrict__ y,
                      int vol, int n_reactions, int n_meta) {
  extern __shared__ int s_meta[];
  for (int i = threadIdx.x; i < n_meta; i += blockDim.x) s_meta[i] = meta[i];
  __syncthreads();
  const int* off = s_meta;
  const int* start = s_meta + n_reactions;
  const int* mv = start + n_reactions + 1;
  const unsigned vmask = static_cast<unsigned>(vol) - 1u;

  const int stride = gridDim.x * blockDim.x;
  for (int z = blockIdx.x * blockDim.x + threadIdx.x; z < vol; z += stride) {
    T acc = T(0);
    if (mask[z]) {
      T d = T(0);
      for (int k = 0; k < n_reactions; ++k) {
        d += fields[static_cast<size_t>(k) * vol + z];
      }
      acc = mul_rn(-d, x[z]);
      for (int k = 0; k < n_reactions; ++k) {
        bool ok = true;
        for (int f = start[k]; f < start[k + 1]; ++f) {
          const int* e = mv + 3 * f;
          const int pred = ((z >> e[0]) & e[1]) - e[2];
          ok = ok && static_cast<unsigned>(pred) <= static_cast<unsigned>(e[1]);
        }
        if (!ok) continue;
        const int src =
            static_cast<int>((static_cast<unsigned>(z) -
                              static_cast<unsigned>(off[k])) & vmask);
        const T xs = mask[src] ? x[src] : T(0);
        acc += mul_rn(fields[static_cast<size_t>(k) * vol + src], xs);
      }
    }
    y[z] = acc;
  }
}

// SM count of the current device, looked up once per device.
int sm_count() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      return 132;
    cache[dev] = n;
  }
  return cache[dev];
}

template <typename T>
int launch(const void* x, const void* mask, const void* fields,
           const void* meta, void* y, int vol, int n_reactions, int n_moved,
           void* stream) {
  if (vol <= 0 || (vol & (vol - 1)) != 0) return cudaErrorInvalidValue;
  const int n_meta = 2 * n_reactions + 1 + 3 * n_moved;
  const size_t smem = (size_t)n_meta * sizeof(int);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;

  long long blocks = (static_cast<long long>(vol) + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;

  direct_stencil_kernel<T><<<static_cast<int>(blocks), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(fields), static_cast<const int*>(meta),
      static_cast<T*>(y), vol, n_reactions, n_meta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int kfs_direct_stencil_f64(const void* x, const void* mask,
                           const void* fields, const void* meta, void* y,
                           int vol, int n_reactions, int n_moved,
                           void* stream) {
  return launch<double>(x, mask, fields, meta, y, vol, n_reactions, n_moved,
                        stream);
}

int kfs_direct_stencil_f32(const void* x, const void* mask,
                           const void* fields, const void* meta, void* y,
                           int vol, int n_reactions, int n_moved,
                           void* stream) {
  return launch<float>(x, mask, fields, meta, y, vol, n_reactions, n_moved,
                       stream);
}

}  // extern "C"
