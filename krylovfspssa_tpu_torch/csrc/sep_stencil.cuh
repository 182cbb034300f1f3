// sep_stencil: the destination-form CME stencil SpMV, for NVIDIA Hopper
// (sm_90a), in float64 and float32.  One kernel body, in two compile-time
// modes, serves three wrappers: the separable mode the whole box
// (box_stencil) and one rank's rows of a row-sharded box (halo_stencil),
// the direct mode every model whose propensities do not factor per species
// (direct_stencil).
//
// Replaces the eight TPU kernels of krylovfspssa_tpu/ops/pallas_stencil.py.
// Separable mode: make_pallas_stencil_matvec_v6 (B1, :1149), _v5 (B2,
// :809), _v4 (B3, :486), _v3 (B4, :228), and their row-shard forms
// make_pallas_local_matvec_v6 (B7, :1828) and _v5 (B8, :1496).  Direct
// mode: make_pallas_stencil_matvec_v2 (B5, :2153) and
// make_pallas_stencil_matvec (B6, v1, :66).  A launch covers the global
// cells [z0, z0 + rows) of a power-of-two box; for each local cell
// i < rows (global z = z0 + i):
//
//   c_s(z)  = (z >> shift_s) & (ext_s - 1)
//   src(j)  = x[j]                for 0 <= j < rows
//           = left[hl + j]        for -hl <= j < 0
//           = right[j - rows]     for rows <= j < rows + hl
//           = 0                   elsewhere
//   y[i]    = mask[i] * ( sum_k u_k(z) * src(i - off_k) - D[i] * x[i] )
//   u_k(z)  = F[tile(z), k] * prod_{s in S_k, shift_s < log2 T} u_{k,s}[c_s(z)]
//                                                            (separable)
//           = U[k, i]                                        (direct)
//
// box_stencil and direct_stencil are launches with z0 = 0, rows = vol and
// hl = 0; halo_stencil passes the H = max_k |off_k| cells of masked x
// before and after its rows (ops/halo.py).
//
// Separable mode: u_{k,s} is the shifted factor table of reaction k and
// species s (zero where the source state leaves the box, so the zeros
// outside the halos read nothing that counts).  F is the per-geometry
// (tile, reaction) table of const_k times the factors of every species whose
// coordinate is constant over a tile of T cells (shift_s >= log2 T, tiles at
// global multiples of T): the TPU v6 kernel's scalar table, with validity
// baked in.
//
// Direct mode: U is the per-geometry rate field of every reaction at its
// destination, U[k, z] = valid_k(z) ? a_k(z - nu_k) : 0, with a_k the
// propensity field evaluated on the host (a kernel cannot run a user's
// Python callable); D = sum_k a_k is stored beside it.  Validity is baked
// into U as into the separable tables, so the kernel tests nothing per
// reaction.  Products are rounded before they are added (no FMA
// contraction), so a float64 y has the bits of the plain version's.
//
// Sums run as -D*x first, then the reactions in k order, in one body for
// every entry point: the concatenated shards of a box equal box_stencil on
// it bit for bit.
//
// Caller contract (as pallas_stencil.py:501 and :1187): supp(x) is inside
// mask, so sources are read without a mask gather and the mask is read once
// per cell, for the output.  The solver keeps it: every Arnoldi vector is a
// combination of masked matvec outputs, a drop zeroes w where it clears the
// mask, growth only widens the mask.
//
// What bounds it: device memory.  Compulsory traffic per active cell is
// x, D and y (one word each) and the mask byte in separable mode: 25 B in
// float64, 13 B in float32 (31.3 us / 16.3 us at the 2^22-cell Goutsias
// box at 3.35 TB/s); in direct mode the R rate words as well, (R + 2)
// words + the mask byte + y: 105 B in float64 with R = 10 (the TPU kernel
// reads x and evaluates the propensities instead).  About 2R operations
// per active cell, far below the card's arithmetic rate.
//
// Design: one thread per cell in a grid-stride loop, so neighbouring
// threads read neighbouring addresses for x, D, y, U and for each shifted
// source.  An inactive cell reads its mask byte and writes 0: an FSP's
// support fills a small part of its box (about 1.4% of the 2^22-cell
// Goutsias box at t=10), and a warp of inactive cells costs one mask line
// and one y line.  An active cell walks the reactions kReactionBlock at a
// time, unrolled: it issues the block's rate (or row-factor) and source
// loads together (no load waits on another), then, in separable mode,
// multiplies in the per-cell factors from shared memory.  A warp's cells
// share a tile, so its row-factor loads are one broadcast.  A zero rate
// skips its product.  The offsets, the per-reaction low-factor lists and
// (when they fit) the factor tables are staged once per block in shared
// memory.  Four reactions a block: eight took 60 registers in float64
// against 40 and ran slower, and int4 records in place of the int32 lists
// took 48 and ran slower too; in direct mode ten (one block for R = 10)
// took 55 and ran no faster (ab_stencil.py, PERF.md section 6).  The
// separable mode caps the grid at the blocks the card holds at once; the
// direct mode launches a block per 256 cells, which ran up to 13% faster
// on the ge5d solve's sparse input (2.7% of 2^23 cells active).
//
// Expected L1/L2 traffic per active cell: R source words, mostly L1 hits
// for the small offsets of low-bit species and L2 hits for the far ones (up
// to H cells away: 511 KiB in float64 at the 2^22-cell Goutsias box), and R
// broadcast row-factor words (separable mode).
//
// Budget: shared memory is the meta (4 (2R + 1 + 3 n_low) bytes, 4R in
// direct mode) and the factor tables if both fit in 48 KB; 256 threads a
// block.  Registers (nvcc 12.8 -Xptxas -v, sm_90a): 40 in float64, 32 in
// float32 in separable mode, 38 and 32 in direct mode; one barrier.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC -I csrc (see ops/stencil_cuda.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace kfs_sep {

constexpr int kThreads = 256;
//: reactions whose loads an active cell issues together
constexpr int kReactionBlock = 4;
//: shared memory a block takes without opting in
constexpr int kSmemLimit = 48 * 1024;

// meta (int32):
//   off[R]            flat offset of each reaction
//   start[R + 1]      reaction k's per-cell factors are fac[start[k] ..
//                     start[k+1])            (separable mode only)
//   fac[3 n_low]      (shift, ext - 1, table offset) of each factor of a
//                     species with shift < log2 T   (separable mode only)
struct Args {
  const void* x;
  const uint8_t* mask;
  const void* left;
  const void* right;
  const void* diag;
  const void* tables;
  const void* row_factors;  // F, (n_tiles, R) for this launch's tiles
  const void* rates;        // U, (R, rows): direct mode
  const int* meta;
  void* y;
  int rows, z0, hl, n_reactions, n_meta, n_tab, log2_tile, stage_tables;
};

__host__ __device__ __forceinline__ int meta_bytes(int n_meta) {
  return (n_meta * static_cast<int>(sizeof(int)) + 15) & ~15;
}

// src(j): x inside the rows, the halos beside them, 0 beyond.
template <typename T>
__device__ __forceinline__ T source(const Args& a, int j) {
  if (j >= 0 && j < a.rows) return __ldg(static_cast<const T*>(a.x) + j);
  if (j < 0)
    return j >= -a.hl ? __ldg(static_cast<const T*>(a.left) + (a.hl + j))
                      : T(0);
  return j - a.rows < a.hl
             ? __ldg(static_cast<const T*>(a.right) + (j - a.rows))
             : T(0);
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// kDirect: u_k(z) is U[k, i] (direct_stencil); otherwise the row factor
// times the per-cell factors (box_stencil, halo_stencil).
template <typename T, bool kDirect>
__global__ void __launch_bounds__(kThreads) sep_stencil_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_meta = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < a.n_meta; i += blockDim.x)
    s_meta[i] = a.meta[i];
  const T* tab = static_cast<const T*>(a.tables);
  if (a.stage_tables) {
    T* s_tab = reinterpret_cast<T*>(smem + meta_bytes(a.n_meta));
    for (int i = threadIdx.x; i < a.n_tab; i += blockDim.x) s_tab[i] = tab[i];
    tab = s_tab;
  }
  __syncthreads();
  const int R = a.n_reactions;
  const int* off = s_meta;
  const int* start = off + R;
  const int* fac = start + R + 1;
  const T* x = static_cast<const T*>(a.x);
  const T* diag = static_cast<const T*>(a.diag);
  const T* F = static_cast<const T*>(a.row_factors);
  const T* U = static_cast<const T*>(a.rates);
  T* y = static_cast<T*>(a.y);
  const int g0 = a.z0 >> a.log2_tile;

  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.rows;
       i += stride) {
    T acc = T(0);
    if (a.mask[i]) {
      const int z = a.z0 + i;
      const T* f_row =
          kDirect ? nullptr
                  : F + static_cast<long long>((z >> a.log2_tile) - g0) * R;
      // direct mode: -D*x rounded, else nvcc contracts it into the
      // first reaction's add
      if constexpr (kDirect)
        acc = mul_rn(-__ldg(diag + i), __ldg(x + i));
      else
        acc = -__ldg(diag + i) * __ldg(x + i);
      for (int k0 = 0; k0 < R; k0 += kReactionBlock) {
        T u[kReactionBlock], v[kReactionBlock];
#pragma unroll
        for (int kk = 0; kk < kReactionBlock; ++kk) {
          const int k = k0 + kk;
          if constexpr (kDirect)
            u[kk] = k < R ? __ldg(U + static_cast<long long>(k) * a.rows + i)
                          : T(0);
          else
            u[kk] = k < R ? __ldg(f_row + k) : T(0);
          v[kk] = k < R ? source<T>(a, i - off[k]) : T(0);
        }
#pragma unroll
        for (int kk = 0; kk < kReactionBlock; ++kk) {
          // 0 where reaction k's source leaves the box (on this tile), or
          // k is past R
          if (u[kk] == T(0)) continue;
          if constexpr (kDirect) {
            acc += mul_rn(u[kk], v[kk]);
          } else {
            const int k = k0 + kk;
            T uk = u[kk];
            for (int f = start[k]; f < start[k + 1]; ++f) {
              const int* e = fac + 3 * f;
              uk *= tab[e[2] + ((z >> e[0]) & e[1])];
            }
            acc += uk * v[kk];
          }
        }
      }
    }
    y[i] = acc;
  }
}

// SM count of the current device, looked up once per device.
inline int sm_count(int dev) {
  static int cache[64] = {0};
  if (dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      return 132;
    cache[dev] = n;
  }
  return cache[dev];
}

// Blocks of sep_stencil_kernel<T, kDirect> one SM holds at `smem` bytes.
template <typename T, bool kDirect>
int blocks_per_sm(int dev, int smem) {
  static int last_smem[64] = {0}, last_blocks[64] = {0};
  if (dev < 0 || dev >= 64) return 0;
  if (last_blocks[dev] == 0 || last_smem[dev] != smem) {
    int nb = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &nb, sep_stencil_kernel<T, kDirect>, kThreads, smem) !=
        cudaSuccess)
      return 0;
    last_smem[dev] = smem;
    last_blocks[dev] = nb;
  }
  return last_blocks[dev];
}

// Launches the kernel on the rows; the factor tables go to shared memory
// when they fit beside the meta.  The direct mode's meta is off[R] alone.
// Returns cudaGetLastError() after the launch (0 = launched).
template <typename T, bool kDirect>
int launch(Args a, void* stream) {
  const int min_meta = kDirect ? a.n_reactions : 2 * a.n_reactions + 1;
  if (a.rows <= 0 || a.z0 < 0 || a.hl < 0 || a.n_reactions <= 0 ||
      a.n_meta < min_meta || a.log2_tile < 0 || a.log2_tile > 30 ||
      meta_bytes(a.n_meta) > kSmemLimit || (kDirect && a.rates == nullptr))
    return cudaErrorInvalidValue;
  const long long tab_bytes = static_cast<long long>(a.n_tab) * sizeof(T);
  a.stage_tables = meta_bytes(a.n_meta) + tab_bytes <= kSmemLimit;
  const int smem = meta_bytes(a.n_meta) +
                   (a.stage_tables ? static_cast<int>(tab_bytes) : 0);
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return cudaErrorInvalidDevice;
  const int nb = blocks_per_sm<T, kDirect>(dev, smem);
  if (nb <= 0) return cudaErrorInvalidConfiguration;
  const long long cap = static_cast<long long>(nb) * sm_count(dev);
  const long long need = (static_cast<long long>(a.rows) + kThreads - 1) /
                         kThreads;
  // direct mode: a block per 256 cells, uncapped (block turnover hides
  // the mask load of sparse inputs better than a grid-stride walk)
  const int grid = static_cast<int>((kDirect || need < cap) ? need : cap);
  sep_stencil_kernel<T, kDirect><<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kfs_sep
