// arnoldi_column: one column of the IOP Arnoldi factorization after its
// matvec, for NVIDIA Hopper (sm_90a), in float64 or float32.
//
// Computes what the port's plain version does
// (krylovfspssa_tpu_torch/krylov/arnoldi.py, column_update_plain and
// avnorm_update_plain): given w = A v_j, modified Gram-Schmidt over the
// window of basis rows istart..j (1-based; the IOP window, all rows for a
// full orthogonalisation), in that order,
//   for i = istart..j:  h_ij = <v_i, w>;  w -= h_ij v_i
//   h_{j+1,j} = ||w||,
// then the masked update of a column that reads nothing back:
//   live = status[BRK] == 0;  H[i-1, j-1] = h_ij only while live;
//   go = live && h_{j+1,j} > tol;  H[j, j-1] = h_{j+1,j} only where go;
//   V[j] = go ? w * (T)(1 / h_{j+1,j}) : 0  (the divisor is 1 wherever the
//     column stops, so no inf or NaN is made; zeros after a breakdown);
//   on the first small norm of a live column status[BRK] = 1, status[MB] = j.
// The avnorm entry writes status[AVNORM] = live ? ||w|| : 0.  tol is read
// from device memory, so one captured CUDA graph serves every step.
//
// Replaces no Pallas kernel: the JAX package's column
// (krylovfspssa_tpu/krylov/arnoldi.py) is XLA ops.  It was added because
// the port's column was ~25 cuBLAS and elementwise launches of 1.5-3 us
// each, against a matvec of ~3 us, and the card set the pace of the solve.
//
// Arithmetic.  Every dot accumulates in float64: a float64 basis forms its
// products and sums in float64; a float32 basis forms each product in
// float32 (as dot64 does) and sums them in float64.  The AXPY and V stay in
// the basis dtype, with h rounded to it first, and the product and the
// difference rounded apart (as the plain version's two torch ops round
// them).  Cross-block sums are per-block partials that the next launch sums
// in a fixed order, never floating-point atomics: the same inputs give the
// same bits on every run (toggle trajectories fork on round-off).
//
// What bounds it.  Bytes: at qiop = 2 in float64, w, v_{j-1} and v_j read
// and V[j] written, 32 vol bytes, 2.5 us at 3.35 TB/s for the toggle's
// 2^18-cell box; the 6 MB working set stays in the 50 MB L2.  What costs is
// launches and grid-wide reductions.  The design:
//
// 1. A chain of q + 2 launches for a window of q rows (4 at qiop = 2), each
//    a grid-stride pass of kThreads-thread blocks, at most kMaxBlocks of
//    them (two per SM): launch k = 0 forms the partials of <v_istart, w>;
//    launch k = 1..q sums the partials of launch k - 1 into h (every block
//    the same sum, in the same order, so every block holds the same bits;
//    block 0 writes it into H), does the AXPY with it into V[j] (launch 1
//    reads w, later ones V[j]: w itself is never written) and forms the
//    partials of the next dot, or of <w, w> after the last row; the last
//    launch sums those into the norm and scales V[j] in place.  The
//    partials alternate between two halves of a scratch of 2 kMaxBlocks
//    doubles.  Summing a launch's partials in every block of the next one
//    costs a read of kMaxBlocks doubles a block from L2, and needs no
//    atomic ticket, counter or fence.
// 2. Not one persistent launch with grid-wide barriers: a hand-rolled
//    barrier needs every block resident at once, which nothing guarantees
//    under a graph replay beside other work, and a hang loses the card;
//    the chain's launches follow each other inside a CUDA graph at about a
//    microsecond each.
// 3. Under a mesh (a row-sharded basis) the caller makes the launches one
//    at a time (kfs_arnoldi_column_launch_*) and all-reduces each launch's
//    partials, elementwise, between them; the next launch sums the reduced
//    partials in the same fixed order.  Every rank holds as many rows, so
//    every rank writes as many partials, and every rank gets the same h.
// 4. A finishing launch reads status[BRK] while block 0 may set it: that
//    write happens only where the norm is small, and there every block
//    stops the column whatever it read (go needs the norm above tol), so
//    every block writes the same V[j].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// two blocks per SM of the H100's 132
constexpr int kMaxBlocks = 264;
static_assert(kMaxBlocks <= kThreads, "a block sums the partials in one pass");

constexpr int BRK = 0, MB = 1, AVNORM = 2;

int blocks_of(int vol) {
  const long long b = (static_cast<long long>(vol) + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? static_cast<int>(b) : kMaxBlocks;
}

// The sum of every thread's v, in a fixed order (a shuffle tree in each
// warp, then warp 0 over the warps' sums), handed to every thread.
__device__ double block_sum(double v) {
  __shared__ double warp_sums[kWarps];
  __shared__ double total;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    double s = lane < kWarps ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

// The sum of the previous launch's n partials, the same in every block.
__device__ double sum_partials(const double* part, int n) {
  return block_sum(static_cast<int>(threadIdx.x) < n ? part[threadIdx.x]
                                                     : 0.0);
}

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// One term of a dot: the product in the basis dtype, summed in float64.
__device__ __forceinline__ double term(double a, double b) { return a * b; }
__device__ __forceinline__ double term(float a, float b) {
  return static_cast<double>(__fmul_rn(a, b));
}

// Launch k of the chain.  kAxpy: sum the previous partials into h, write
// it to *h_out while live, and V[j] = src - h prev.  Then the partials of
// <next, w> (kNorm false) or <w, w> (kNorm true) into out_part.
template <typename T, bool kAxpy, bool kNorm>
__global__ void __launch_bounds__(kThreads)
    mgs_phase_kernel(const T* src, T* dst, const T* prev, const T* next,
                     const double* in_part, int n_in, double* out_part,
                     double* h_out, const double* status, unsigned vol) {
  T h = T(0);
  if (kAxpy) {
    const double hd = sum_partials(in_part, n_in);
    h = static_cast<T>(hd);
    if (blockIdx.x == 0 && threadIdx.x == 0 && status[BRK] == 0.0)
      *h_out = hd;
  }
  double acc = 0.0;
  const unsigned stride = gridDim.x * kThreads;
#pragma unroll 4
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < vol;
       e += stride) {
    T x = src[e];
    if (kAxpy) {
      x = x - mul_rn(h, prev[e]);
      dst[e] = x;
    }
    acc += term(kNorm ? x : next[e], x);
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) out_part[blockIdx.x] = s;
}

// The last launch of a column: the norm from the partials, H[j, j-1] and
// the status, and V[j] scaled in place (zeros where the column stops).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    mgs_finish_kernel(T* vj, const double* in_part, int n_in,
                      double* h_norm, double* status, const double* tol,
                      double jcol, unsigned vol) {
  const double hn = sqrt(sum_partials(in_part, n_in));
  const bool live = status[BRK] == 0.0;
  const bool small = hn <= *tol;
  const bool go = live && !small;
  const T inv = static_cast<T>(1.0 / (go ? hn : 1.0));
  const unsigned stride = gridDim.x * kThreads;
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < vol;
       e += stride)
    vj[e] = go ? vj[e] * inv : T(0);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (go) *h_norm = hn;
    if (live && small) {
      status[BRK] = 1.0;
      status[MB] = jcol;
    }
  }
}

// status[AVNORM] from the partials of <w, w>: one block.
__global__ void __launch_bounds__(kThreads)
    avnorm_finish_kernel(const double* in_part, int n_in, double* status) {
  const double av = sqrt(sum_partials(in_part, n_in));
  if (threadIdx.x == 0) status[AVNORM] = status[BRK] == 0.0 ? av : 0.0;
}

template <typename T, bool kAxpy, bool kNorm>
int phase(int grid, cudaStream_t st, const T* src, T* dst, const T* prev,
          const T* next, const double* in_part, int n_in, double* out_part,
          double* h_out, const double* status, int vol) {
  mgs_phase_kernel<T, kAxpy, kNorm><<<grid, kThreads, 0, st>>>(
      src, dst, prev, next, in_part, n_in, out_part, h_out, status,
      static_cast<unsigned>(vol));
  return static_cast<int>(cudaGetLastError());
}

// Launch k (0..q+1) of column j's chain: it sums the n_in doubles at
// in_part (the partials of launch k - 1, or a mesh's reduction of them;
// launch 0 reads none) and writes blocks_of(vol) partials at out_part
// (the last launch none).
template <typename T>
int column_launch(const void* w_, void* V_, void* H_, void* status_,
                  const void* tol, const double* in_part, int n_in,
                  double* out_part, int vol, int MH, int j, int istart,
                  int k, cudaStream_t st) {
  const int q = j - istart + 1;
  if (vol <= 0 || MH <= 0 || istart < 1 || istart > j || j >= MH || k < 0 ||
      k > q + 1 || (k > 0 && (n_in < 1 || n_in > kThreads)))
    return cudaErrorInvalidValue;
  const T* w = static_cast<const T*>(w_);
  T* V = static_cast<T*>(V_);
  double* H = static_cast<double*>(H_);
  double* status = static_cast<double*>(status_);
  const int grid = blocks_of(vol);
  const size_t n = static_cast<size_t>(vol);
  T* vj = V + static_cast<size_t>(j) * n;
  auto row = [&](int i) { return V + static_cast<size_t>(i - 1) * n; };
  auto h_at = [&](int i) {  // H[i-1, j-1]
    return H + static_cast<size_t>(i - 1) * MH + (j - 1);
  };
  if (k == 0)
    return phase<T, false, false>(grid, st, w, nullptr, nullptr, row(istart),
                                  nullptr, 0, out_part, nullptr, status, vol);
  if (k <= q) {
    const T* src = k == 1 ? w : vj;
    const T* prev = row(istart + k - 1);
    double* h_out = h_at(istart + k - 1);
    return k < q ? phase<T, true, false>(grid, st, src, vj, prev,
                                         row(istart + k), in_part, n_in,
                                         out_part, h_out, status, vol)
                 : phase<T, true, true>(grid, st, src, vj, prev, nullptr,
                                        in_part, n_in, out_part, h_out,
                                        status, vol);
  }
  mgs_finish_kernel<T><<<grid, kThreads, 0, st>>>(
      vj, in_part, n_in, H + static_cast<size_t>(j) * MH + (j - 1), status,
      static_cast<const double*>(tol), static_cast<double>(j),
      static_cast<unsigned>(vol));
  return static_cast<int>(cudaGetLastError());
}

// The whole chain on one card: the partials alternate between the two
// halves of the scratch.
template <typename T>
int column(const void* w, void* V, void* H, void* status, const void* tol,
           void* scratch_, int vol, int MH, int j, int istart, void* stream) {
  double* part[2] = {static_cast<double*>(scratch_),
                     static_cast<double*>(scratch_) + kMaxBlocks};
  const int grid = blocks_of(vol);
  int rc = 0;
  for (int k = 0; k <= j - istart + 2 && rc == 0; ++k)
    rc = column_launch<T>(w, V, H, status, tol, part[(k + 1) & 1], grid,
                          part[k & 1], vol, MH, j, istart, k,
                          static_cast<cudaStream_t>(stream));
  return rc;
}

// Launch k (0 or 1) of the avnorm: the partials of <w, w>, then
// status[AVNORM] from the n_in doubles at in_part.
template <typename T>
int avnorm_launch(const void* w, void* status_, const double* in_part,
                  int n_in, double* out_part, int vol, int k,
                  cudaStream_t st) {
  if (vol <= 0 || k < 0 || k > 1 || (k == 1 && (n_in < 1 || n_in > kThreads)))
    return cudaErrorInvalidValue;
  double* status = static_cast<double*>(status_);
  if (k == 0)
    return phase<T, false, true>(blocks_of(vol), st, static_cast<const T*>(w),
                                 nullptr, nullptr, nullptr, nullptr, 0,
                                 out_part, nullptr, status, vol);
  avnorm_finish_kernel<<<1, kThreads, 0, st>>>(in_part, n_in, status);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int avnorm(const void* w, void* status, void* scratch_, int vol,
           void* stream) {
  double* part = static_cast<double*>(scratch_);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = avnorm_launch<T>(w, status, nullptr, 0, part, vol, 0, st);
  return rc != 0 ? rc
                 : avnorm_launch<T>(w, status, part, blocks_of(vol), nullptr,
                                    vol, 1, st);
}

}  // namespace

extern "C" {

// Doubles of scratch that kfs_arnoldi_column_* and kfs_arnoldi_avnorm_*
// take (the partials of two launches).
int kfs_arnoldi_scratch() { return 2 * kMaxBlocks; }

// The partials one launch of a chain writes for vol cells.
int kfs_arnoldi_blocks(int vol) { return vol > 0 ? blocks_of(vol) : 0; }

// w: (vol) of the basis dtype, the matvec of V[j-1]; V: (>= j+1, vol) of
// the basis dtype, row-major; H: (MH, MH) float64, row-major; status: 3
// float64 (BRK, MB, AVNORM); tol: one float64; scratch:
// kfs_arnoldi_scratch() float64; all in device memory.  j, istart:
// 1-based column and first row of its window.  Returns cudaGetLastError()
// after the last launch (0 = launched).
int kfs_arnoldi_column_f64(const void* w, void* V, void* H, void* status,
                           const void* tol, void* scratch, int vol, int MH,
                           int j, int istart, void* stream) {
  return column<double>(w, V, H, status, tol, scratch, vol, MH, j, istart,
                        stream);
}

int kfs_arnoldi_column_f32(const void* w, void* V, void* H, void* status,
                           const void* tol, void* scratch, int vol, int MH,
                           int j, int istart, void* stream) {
  return column<float>(w, V, H, status, tol, scratch, vol, MH, j, istart,
                       stream);
}

// Launch k (0..j-istart+2) of the same chain alone, for a row-sharded
// basis: the caller sums each launch's kfs_arnoldi_blocks(vol) partials at
// out_part over the ranks, elementwise, and hands the sums to launch k + 1
// as in_part (n_in of them).
int kfs_arnoldi_column_launch_f64(const void* w, void* V, void* H,
                                  void* status, const void* tol,
                                  const void* in_part, int n_in,
                                  void* out_part, int vol, int MH, int j,
                                  int istart, int k, void* stream) {
  return column_launch<double>(
      w, V, H, status, tol, static_cast<const double*>(in_part), n_in,
      static_cast<double*>(out_part), vol, MH, j, istart, k,
      static_cast<cudaStream_t>(stream));
}

int kfs_arnoldi_column_launch_f32(const void* w, void* V, void* H,
                                  void* status, const void* tol,
                                  const void* in_part, int n_in,
                                  void* out_part, int vol, int MH, int j,
                                  int istart, int k, void* stream) {
  return column_launch<float>(
      w, V, H, status, tol, static_cast<const double*>(in_part), n_in,
      static_cast<double*>(out_part), vol, MH, j, istart, k,
      static_cast<cudaStream_t>(stream));
}

// status[AVNORM] = status[BRK] == 0 ? ||w|| : 0, w: (vol) of the basis
// dtype.
int kfs_arnoldi_avnorm_f64(const void* w, void* status, void* scratch,
                           int vol, void* stream) {
  return avnorm<double>(w, status, scratch, vol, stream);
}

int kfs_arnoldi_avnorm_f32(const void* w, void* status, void* scratch,
                           int vol, void* stream) {
  return avnorm<float>(w, status, scratch, vol, stream);
}

// Launch k (0 or 1) of the avnorm alone, as kfs_arnoldi_column_launch_*.
int kfs_arnoldi_avnorm_launch_f64(const void* w, void* status,
                                  const void* in_part, int n_in,
                                  void* out_part, int vol, int k,
                                  void* stream) {
  return avnorm_launch<double>(w, status, static_cast<const double*>(in_part),
                               n_in, static_cast<double*>(out_part), vol, k,
                               static_cast<cudaStream_t>(stream));
}

int kfs_arnoldi_avnorm_launch_f32(const void* w, void* status,
                                  const void* in_part, int n_in,
                                  void* out_part, int vol, int k,
                                  void* stream) {
  return avnorm_launch<float>(w, status, static_cast<const double*>(in_part),
                              n_in, static_cast<double*>(out_part), vol, k,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
