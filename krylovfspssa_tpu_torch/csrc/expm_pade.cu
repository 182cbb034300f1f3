// expm_pade: the dense exponential of the small Krylov Hessenberg, for
// NVIDIA Hopper (sm_90a), in float64, in one thread block.
//
// Computes EXPOKIT's DGPADM (reference/src/expokit/dgpadm.f:2-339) as the
// port's plain version does (krylovfspssa_tpu_torch/ops/expm.py,
// expm_pade_plain): E = exp(t * A) for the leading mx x mx block A of the
// (MH, MH) workspace H, by the irreducible (ideg, ideg) diagonal Pade
// approximant with scaling and squaring, plus the DGPADMNORM output
// hnorm = |t| * ||A||_inf and the squaring count ns.
//
// Replaces the JAX package's expm (krylovfspssa_tpu/ops/expm.py:79), which
// XLA compiles; it is not a Pallas kernel.  The port had run it as ~30
// small torch launches with three host reads (hnorm sets ns; the LU's info
// check; the block size mx).  This kernel reads mx and t from device
// memory, so the stepper can hand it a block size and a step that are
// still on the device (a breakdown sets both), and reads nothing back.
//
// Steps, with n = mx:
//   hnorm = |t| max_i sum_j |A_ij|;  ns = 0 if !(hnorm > 0), 1100 if hnorm
//     is infinite, else clamp(trunc(log(hnorm)/log(2)) + 2, 0, 1100)
//     (ops/expm.py:_squarings; 1100 > log2 of the float64 maximum);
//   s = t / 2^ns;  A2 = s^2 (A A);  p = c_{ideg-1} I, q = c_ideg I;
//   Horner: alternately q = q A2 + c_{k-1} I, p = p A2 + c_{k-1} I;
//   the odd part times s A;  q = q - p;  X = q^{-1} p by an LU with
//   partial pivoting (the first largest pivot, as the JAX package's
//   solve_plu);  E = 2X + I (negated for odd parity with ns = 0);
//   E = E^(2^ns) by ns squarings.
// E is written as an (MH, MH) matrix: exp(tA) in the leading block, the
// identity elsewhere; stats = {hnorm, ns}.
//
// Storage: three n x n matrices (A2, p, q; A itself is read from H) in
// shared memory while 3 n^2 doubles fit beside the fixed part (a row panel
// and a reduction buffer): n <= 96 at the H100's 227 KB.  Larger blocks
// use the global scratch the wrapper passes (3 MH^2 doubles).  A product
// X <- X Y that overwrites X goes one panel of rows at a time (the panel
// is copied out first); the squarings alternate between two buffers.
//
// What bounds it: latency.  The work is (ideg + 1 + ns) products of 2 n^3
// operations and an LU with n right-hand sides, about 40 MFLOP at n = 102
// with ns = 10: about 0.6 us at the 67 TFLOP/s of the card's float64
// tensor cores, were it spread over the card.  One block runs it on one SM, through a serial
// chain: every product waits for the one before it, the pivot search and
// elimination take n dependent rounds of block barriers, and the ns
// squarings depend on each other.  One block keeps that chain in shared
// memory with no launch between its links; the stepper needs one expm at
// a time, so there is nothing to run beside it.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 512;
constexpr int kPanel = 8;   // rows of X copied out per in-place product
constexpr int kRed = 64;    // doubles of reduction / pivot scratch
constexpr int kMaxDeg = 32;

// Every product of the products and of the LU is rounded before it is
// added (no fused multiply-add), and the back substitution runs by columns.
// This arithmetic was chosen because it let chip_smoke's toggle t=1000
// gate pass, not because it is more accurate: fused multiply-adds or a
// back substitution by rows are as close to the plain version (2.8e-14)
// and sent that solve down round-off forks that overflowed the box.  The
// fault was the step controller's; since its repair (ROADMAP.md Queue C)
// the solve ends within the FSP contract under every variant
// (ab_expm.py), and the arithmetic was kept.
__device__ __forceinline__ double madd(double acc, double a, double b) {
  return __dadd_rn(acc, __dmul_rn(a, b));
}
__device__ __forceinline__ double msub(double acc, double a, double b) {
  return __dsub_rn(acc, __dmul_rn(a, b));
}

struct Mat {
  double* a;
  int ld;
  __device__ double& operator()(int i, int j) const { return a[i * ld + j]; }
};

// X <- alpha * (X Y) + beta * I over n x n, a panel of rows at a time;
// Y may be in global memory (H).
__device__ void mul_inplace(Mat X, Mat Y, int n, double alpha, double beta,
                            double* panel) {
  for (int r0 = 0; r0 < n; r0 += kPanel) {
    const int rows = min(kPanel, n - r0);
    for (int e = threadIdx.x; e < rows * n; e += blockDim.x)
      panel[e] = X(r0 + e / n, e % n);
    __syncthreads();
    for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
      const int i = e / n, j = e % n;
      double acc = 0.0;
      for (int k = 0; k < n; ++k) acc = madd(acc, panel[i * n + k], Y(k, j));
      X(r0 + i, j) = alpha * acc + (r0 + i == j ? beta : 0.0);
    }
    __syncthreads();
  }
}

// C <- alpha * (X Y), C distinct from X and Y.
__device__ void mul_into(Mat C, Mat X, Mat Y, int n, double alpha) {
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc = madd(acc, X(i, k), Y(k, j));
    C(i, j) = alpha * acc;
  }
  __syncthreads();
}

// max that keeps a NaN (torch.max propagates it)
__device__ double nanmax(double a, double b) {
  return (b > a || isnan(b)) ? b : a;
}

// X = Q^{-1} P in place of P (Q is overwritten by its LU factors).
__device__ void lu_solve(Mat Q, Mat P, int n, double* red, double* fac) {
  int* piv = reinterpret_cast<int*>(red);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      double best = -1.0;
      int bi = k;
      for (int i = k + lane; i < n; i += 32) {
        const double v = fabs(Q(i, k));
        if (v > best) {
          best = v;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (lane == 0) piv[0] = bi;
    }
    __syncthreads();
    const int p = piv[0];
    if (p != k) {
      for (int j = threadIdx.x; j < 2 * n; j += blockDim.x) {
        const Mat M = j < n ? Q : P;
        const int c = j < n ? j : j - n;
        const double t = M(k, c);
        M(k, c) = M(p, c);
        M(p, c) = t;
      }
    }
    __syncthreads();
    const double pv = Q(k, k);
    for (int i = k + 1 + threadIdx.x; i < n; i += blockDim.x)
      fac[i] = Q(i, k) / pv;
    __syncthreads();
    const int rest = n - k - 1;
    for (int e = threadIdx.x; e < rest * (rest + n); e += blockDim.x) {
      const int i = k + 1 + e / (rest + n), c = e % (rest + n);
      if (c < rest)
        Q(i, k + 1 + c) = msub(Q(i, k + 1 + c), fac[i], Q(k, k + 1 + c));
      else
        P(i, c - rest) = msub(P(i, c - rest), fac[i], P(k, c - rest));
    }
    __syncthreads();
  }
  // back substitution, a row of X at a time, then eliminated upwards
  for (int k = n - 1; k >= 0; --k) {
    const double d = Q(k, k);
    for (int j = threadIdx.x; j < n; j += blockDim.x) P(k, j) /= d;
    __syncthreads();
    for (int e = threadIdx.x; e < k * n; e += blockDim.x) {
      const int i = e / n, j = e % n;
      P(i, j) = msub(P(i, j), Q(i, k), P(k, j));
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
    expm_pade_kernel(const double* __restrict__ H,
                     const long long* __restrict__ mx_p,
                     const double* __restrict__ t_p, double* __restrict__ E,
                     double* __restrict__ stats, double* scratch, int MH,
                     int ideg, int smem_bytes) {
  extern __shared__ double smem[];
  double* red = smem;
  double* panel = smem + kRed;  // kPanel * MH doubles, also the LU factors
  const long long mx_raw = *mx_p;
  const int n = static_cast<int>(mx_raw < 0 ? 0 : (mx_raw > MH ? MH : mx_raw));
  const double t = *t_p;
  const Mat A{const_cast<double*>(H), MH};

  // ---- hnorm and ns (dgpadm.f:68-87) ---------------------------------
  double mymax = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += fabs(A(i, j));
    mymax = nanmax(mymax, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    mymax = nanmax(mymax, __shfl_down_sync(0xffffffffu, mymax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mymax;
  __syncthreads();
  double rmax = 0.0;
  for (int w = 0; w < kThreads / 32; ++w) rmax = nanmax(rmax, red[w]);
  const double hnorm = fabs(t) * rmax;
  int ns = 0;
  if (hnorm > 0.0) {
    if (isinf(hnorm)) {
      ns = 1100;
    } else {
      const double r = trunc(log(hnorm) / log(2.0)) + 2.0;
      ns = static_cast<int>(fmin(fmax(r, 0.0), 1100.0));
    }
  }
  __syncthreads();  // red is reused below
  if (threadIdx.x == 0) {
    stats[0] = hnorm;
    stats[1] = static_cast<double>(ns);
  }
  const double scale = t / exp2(static_cast<double>(ns));

  double c[kMaxDeg + 1];
  c[0] = 1.0;
  for (int k = 1; k <= ideg; ++k)
    c[k] = c[k - 1] * static_cast<double>(ideg + 1 - k) /
           static_cast<double>(k * (2 * ideg + 1 - k));

  const long long fixed = static_cast<long long>(kRed + kPanel * MH);
  const bool in_smem =
      (fixed + 3LL * n * n) * static_cast<long long>(sizeof(double)) <=
      smem_bytes;
  double* base = in_smem ? smem + fixed : scratch;
  const Mat A2{base, n}, P{base + n * n, n}, Q{base + 2 * n * n, n};

  if (n > 0) {
    // ---- A2 = s^2 A A; Horner on the even/odd parts (dgpadm.f:89-131) -
    mul_into(A2, A, A, n, scale * scale);
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
      const bool d = e / n == e % n;
      P.a[e] = d ? c[ideg - 1] : 0.0;
      Q.a[e] = d ? c[ideg] : 0.0;
    }
    __syncthreads();
    int iodd = 1;
    for (int k = ideg - 1; k > 0; --k) {
      mul_inplace(iodd ? Q : P, A2, n, 1.0, c[k - 1], panel);
      iodd = 1 - iodd;
    }
    // ---- (+/-)(I + 2 (q - p)^{-1} p) (dgpadm.f:133-155) --------------
    mul_inplace(iodd ? Q : P, A, n, scale, 0.0, panel);
    for (int e = threadIdx.x; e < n * n; e += blockDim.x) Q.a[e] -= P.a[e];
    __syncthreads();
    lu_solve(Q, P, n, red, panel);
    const double sign = (iodd == 1 && ns == 0) ? -1.0 : 1.0;
    for (int e = threadIdx.x; e < n * n; e += blockDim.x)
      P.a[e] = sign * (2.0 * P.a[e] + (e / n == e % n ? 1.0 : 0.0));
    __syncthreads();
    // ---- squaring: E <- E^(2^ns) (dgpadm.f:157-166) ------------------
    Mat cur = P, other = Q;
    for (int s = 0; s < ns; ++s) {
      mul_into(other, cur, cur, n, 1.0);
      const Mat tmp = cur;
      cur = other;
      other = tmp;
    }
    for (int e = threadIdx.x; e < MH * MH; e += blockDim.x) {
      const int i = e / MH, j = e % MH;
      E[e] = (i < n && j < n) ? cur(i, j) : (i == j ? 1.0 : 0.0);
    }
  } else {
    for (int e = threadIdx.x; e < MH * MH; e += blockDim.x)
      E[e] = (e / MH == e % MH) ? 1.0 : 0.0;
  }
}

}  // namespace

extern "C" {

// H, E: (MH, MH) float64; mx: one int64, t: one float64, both in device
// memory; stats: two float64 (hnorm, ns); scratch: 3 MH^2 float64 for
// blocks that do not fit in shared memory (may be null when MH is small
// enough).  Returns cudaGetLastError() after the launch (0 = launched).
int kfs_expm_pade(const void* H, const void* mx, const void* t, void* E,
                  void* stats, void* scratch, int MH, int ideg,
                  void* stream) {
  if (MH <= 0 || ideg < 1 || ideg > kMaxDeg) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return cudaErrorInvalidDevice;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return cudaErrorInvalidDevice;
  const long long fixed = static_cast<long long>(kRed + kPanel * MH) * 8;
  const long long full = fixed + 3LL * MH * MH * 8;
  if (fixed > optin) return cudaErrorInvalidValue;
  if (full > optin && scratch == nullptr) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(full < optin ? full : optin);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        expm_pade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  expm_pade_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(H), static_cast<const long long*>(mx),
      static_cast<const double*>(t), static_cast<double*>(E),
      static_cast<double*>(stats), static_cast<double*>(scratch), MH, ideg,
      smem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
