// halo_stencil: the separable destination-form CME stencil SpMV on ONE rank's
// rows of a row-sharded masked box, for NVIDIA Hopper (sm_90a), in float64
// and float32.
//
// Replaces two TPU kernels of krylovfspssa_tpu/ops/pallas_stencil.py that
// compute one function: make_pallas_local_matvec_v6 (B7, :1828, the halo
// path's preferred local kernel) and make_pallas_local_matvec_v5 (B8, :1496,
// its fallback).  They are box_stencil's function (B1/B2) on one shard, with
// the shard-edge blocks reading their halo rows from the neighbours'
// buffers.  This kernel computes that function, not their tiling.  A rank
// holds the global cells [z0, z0 + rows); for each local cell i < rows
// (global z = z0 + i):
//
//   c_s(z)  = (z >> shift_s) & (ext_s - 1)
//   src(j)  = mask[j] * x[j]    for 0 <= j < rows
//           = left[halo + j]    for j < 0        (global z0 + j)
//           = right[j - rows]   for j >= rows    (global z0 + j)
//   y[i]    = mask[i] * ( sum_k const_k * prod_{s in S_k} u_{k,s}[c_s(z)]
//                                       * src(i - off_k)
//                         - D[i] * mask[i] * x[i] )
//
// left and right are the masked x at the halo = max_k |off_k| cells before
// and after the rows, exchanged between the ranks by the caller (zero
// outside the box; ops/halo.py).  There is no wrap: a valid source never
// leaves the global flat range, and u_{k,s} is zero for a source outside
// the box.  The factor tables are indexed at global coordinates, and the
// sum runs in box_stencil's order with box_stencil's arithmetic, so in
// float64 the concatenated shards equal box_stencil on the whole vector.
//
// What bounds it: device memory, as box_stencil.  Per cell it reads x, mask
// and D, and up to R neighbour x and mask values (L1/L2 hits: the offsets
// are small next to the shard), and writes y: 3 words + 1 byte of
// compulsory traffic, about 2R multiply-adds.  The halos add 2H words per
// call (H = 65,408 cells at the 2^22-cell Goutsias box).  Design: one
// thread per cell in a grid-stride loop, so neighbouring threads read
// neighbouring addresses; the per-reaction factor lists and (when they fit)
// the factor tables are staged once per block in shared memory.  The three
// source branches are uniform across a warp except in the H cells at each
// end of the shard.  Overlapping the exchange with the interior cells, TMA
// and offset-window tiling are left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (see ops/stencil_cuda.py).  Plain C entry points, bound with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr size_t kStaticSmemLimit = 48 * 1024;

// meta (int32) layout, as box_stencil's:
//   off[R]            flat offset of each reaction
//   start[R + 1]      factor list of reaction k is fac[start[k] .. start[k+1])
//   fac[3 * n_fac]    (shift, extent - 1, table offset) per factor
template <typename T>
__global__ void __launch_bounds__(kThreads)
halo_stencil_kernel(const T* __restrict__ x,
                    const uint8_t* __restrict__ mask,
                    const T* __restrict__ left,
                    const T* __restrict__ right,
                    const T* __restrict__ diag,
                    const T* __restrict__ tables,
                    const T* __restrict__ consts,
                    const int* __restrict__ meta,
                    T* __restrict__ y,
                    int rows, int z0, int halo, int n_reactions, int n_meta,
                    int n_tab, int stage_tables) {
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

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < rows; i += stride) {
    T acc = T(0);
    if (mask[i]) {
      const int z = z0 + i;
      acc = -diag[i] * x[i];
      for (int k = 0; k < n_reactions; ++k) {
        const int j = i - off[k];
        T src;
        if (j < 0) {
          src = left[halo + j];
        } else if (j >= rows) {
          src = right[j - rows];
        } else {
          if (!mask[j]) continue;
          src = x[j];
        }
        T u = __ldg(consts + k);
        for (int f = start[k]; f < start[k + 1]; ++f) {
          const int* e = fac + 3 * f;
          u *= tab[e[2] + ((z >> e[0]) & e[1])];
        }
        acc += u * src;
      }
    }
    y[i] = acc;
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
int launch(const void* x, const void* mask, const void* left,
           const void* right, const void* diag, const void* tables,
           const void* consts, const void* meta, void* y, int rows, int z0,
           int halo, int n_reactions, int n_fac, int n_tab, void* stream) {
  if (rows <= 0 || z0 < 0 || halo < 0) return cudaErrorInvalidValue;
  const int n_meta = 2 * n_reactions + 1 + 3 * n_fac;
  const size_t meta_bytes = ((size_t)n_meta * sizeof(int) + 15) & ~size_t(15);
  const size_t tab_bytes = (size_t)n_tab * sizeof(T);
  if (meta_bytes > kStaticSmemLimit) return cudaErrorInvalidValue;
  const int stage = meta_bytes + tab_bytes <= kStaticSmemLimit ? 1 : 0;
  const size_t smem = meta_bytes + (stage ? tab_bytes : 0);

  long long blocks = (static_cast<long long>(rows) + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;

  halo_stencil_kernel<T><<<static_cast<int>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const T*>(diag), static_cast<const T*>(tables),
      static_cast<const T*>(consts), static_cast<const int*>(meta),
      static_cast<T*>(y), rows, z0, halo, n_reactions, n_meta, n_tab, stage);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int kfs_halo_stencil_f64(const void* x, const void* mask, const void* left,
                         const void* right, const void* diag,
                         const void* tables, const void* consts,
                         const void* meta, void* y, int rows, int z0,
                         int halo, int n_reactions, int n_fac, int n_tab,
                         void* stream) {
  return launch<double>(x, mask, left, right, diag, tables, consts, meta, y,
                        rows, z0, halo, n_reactions, n_fac, n_tab, stream);
}

int kfs_halo_stencil_f32(const void* x, const void* mask, const void* left,
                         const void* right, const void* diag,
                         const void* tables, const void* consts,
                         const void* meta, void* y, int rows, int z0,
                         int halo, int n_reactions, int n_fac, int n_tab,
                         void* stream) {
  return launch<float>(x, mask, left, right, diag, tables, consts, meta, y,
                       rows, z0, halo, n_reactions, n_fac, n_tab, stream);
}

}  // extern "C"
