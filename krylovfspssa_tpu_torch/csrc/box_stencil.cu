// box_stencil: the separable destination-form CME stencil SpMV on the masked
// power-of-two box, for NVIDIA Hopper (sm_90a), in float64 and float32.
//
// Replaces the four TPU tilings of one function in
// krylovfspssa_tpu/ops/pallas_stencil.py: make_pallas_stencil_matvec_v6
// (B1, the TPU production default), _v5 (B2), _v4 (B3) and _v3 (B4).  It
// computes the math of ops/stencil.py's make_stencil_matvec (separable
// branch), not any of those tilings.  For each cell z < vol:
//
//   c_s(z) = (z >> shift_s) & (ext_s - 1)
//   y[z]   = mask[z] * ( sum_k const_k * prod_{s in S_k} u_{k,s}[c_s(z)]
//                                       * (mask*x)[(z - off_k) & (vol - 1)]
//                        - D[z] * (mask*x)[z] )
//
// u_{k,s} is the shifted factor table of reaction k and species s (zero
// where the source state leaves the box), D the total outflow rate per cell
// (streamed as a precomputed vector).  vol is a power of two, so the wrapped
// predecessor index equals torch.roll exactly: the wrap never leaves the
// array, and a wrapped read always meets a zero u.
//
// What bounds it: device memory.  Per cell it reads x, mask and D, and up to
// R neighbour x and mask values that are mostly L1/L2 hits (the offsets
// are small next to the box), and writes y: 3 words + 1 byte of compulsory
// traffic.  It does about 2R multiply-adds per cell, far below the card's
// arithmetic rate.  Design: one thread per cell in a grid-stride loop, so
// neighbouring threads read neighbouring addresses for x, D, y and for each
// shifted x; the per-reaction factor lists and (when they fit) the factor
// tables are staged once per block in shared memory.  Tiling over the
// offset window, TMA and fusing the Arnoldi AXPYs are left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (see ops/stencil_cuda.py).  Plain C entry points, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr size_t kStaticSmemLimit = 48 * 1024;

// meta (int32) layout:
//   off[R]            flat offset of each reaction
//   start[R + 1]      factor list of reaction k is fac[start[k] .. start[k+1])
//   fac[3 * n_fac]    (shift, extent - 1, table offset) per factor
template <typename T>
__global__ void __launch_bounds__(kThreads)
box_stencil_kernel(const T* __restrict__ x,
                   const uint8_t* __restrict__ mask,
                   const T* __restrict__ diag,
                   const T* __restrict__ tables,
                   const T* __restrict__ consts,
                   const int* __restrict__ meta,
                   T* __restrict__ y,
                   int vol, int n_reactions, int n_meta, int n_tab,
                   int stage_tables) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_meta = reinterpret_cast<int*>(smem_raw);
  const size_t meta_bytes = ((size_t)n_meta * sizeof(int) + 15) & ~size_t(15);
  T* s_tab = reinterpret_cast<T*>(smem_raw + meta_bytes);

  for (int i = threadIdx.x; i < n_meta; i += blockDim.x) s_meta[i] = meta[i];
  if (stage_tables) {
    for (int i = threadIdx.x; i < n_tab; i += blockDim.x) s_tab[i] = tables[i];
  }
  __syncthreads();
  const T* tab = stage_tables ? s_tab : tables;
  const int* off = s_meta;
  const int* start = s_meta + n_reactions;
  const int* fac = start + n_reactions + 1;
  const unsigned vmask = static_cast<unsigned>(vol) - 1u;

  const int stride = gridDim.x * blockDim.x;
  for (int z = blockIdx.x * blockDim.x + threadIdx.x; z < vol; z += stride) {
    T acc = T(0);
    if (mask[z]) {
      acc = -diag[z] * x[z];
      for (int k = 0; k < n_reactions; ++k) {
        const int src =
            static_cast<int>((static_cast<unsigned>(z) -
                              static_cast<unsigned>(off[k])) & vmask);
        if (!mask[src]) continue;
        T u = __ldg(consts + k);
        for (int f = start[k]; f < start[k + 1]; ++f) {
          const int* e = fac + 3 * f;
          u *= tab[e[2] + ((z >> e[0]) & e[1])];
        }
        acc += u * x[src];
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
int launch(const void* x, const void* mask, const void* diag,
           const void* tables, const void* consts, const void* meta, void* y,
           int vol, int n_reactions, int n_fac, int n_tab, void* stream) {
  if (vol <= 0 || (vol & (vol - 1)) != 0) return cudaErrorInvalidValue;
  const int n_meta = 2 * n_reactions + 1 + 3 * n_fac;
  const size_t meta_bytes = ((size_t)n_meta * sizeof(int) + 15) & ~size_t(15);
  const size_t tab_bytes = (size_t)n_tab * sizeof(T);
  if (meta_bytes > kStaticSmemLimit) return cudaErrorInvalidValue;
  const int stage = meta_bytes + tab_bytes <= kStaticSmemLimit ? 1 : 0;
  const size_t smem = meta_bytes + (stage ? tab_bytes : 0);

  long long blocks = (static_cast<long long>(vol) + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;

  box_stencil_kernel<T><<<static_cast<int>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(diag), static_cast<const T*>(tables),
      static_cast<const T*>(consts), static_cast<const int*>(meta),
      static_cast<T*>(y), vol, n_reactions, n_meta, n_tab, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int kfs_box_stencil_f64(const void* x, const void* mask, const void* diag,
                        const void* tables, const void* consts,
                        const void* meta, void* y, int vol, int n_reactions,
                        int n_fac, int n_tab, void* stream) {
  return launch<double>(x, mask, diag, tables, consts, meta, y, vol,
                        n_reactions, n_fac, n_tab, stream);
}

int kfs_box_stencil_f32(const void* x, const void* mask, const void* diag,
                        const void* tables, const void* consts,
                        const void* meta, void* y, int vol, int n_reactions,
                        int n_fac, int n_tab, void* stream) {
  return launch<float>(x, mask, diag, tables, consts, meta, y, vol,
                       n_reactions, n_fac, n_tab, stream);
}

}  // extern "C"
