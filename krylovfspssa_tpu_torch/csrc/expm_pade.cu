// expm_pade: the dense exponential of the small Krylov Hessenberg, for
// NVIDIA Hopper (sm_90a), in float64, in one thread block, on the float64
// tensor cores.
//
// Computes EXPOKIT's DGPADM (reference/src/expokit/dgpadm.f:2-339) as the
// port's plain version does (krylovfspssa_tpu_torch/ops/expm.py,
// expm_pade_plain): E = exp(t * A) for the leading mx x mx block A of the
// (MH, MH) workspace H, by the irreducible (ideg, ideg) diagonal Pade
// approximant with scaling and squaring, plus the DGPADMNORM output
// hnorm = |t| * ||A||_inf and the squaring count ns.
//
// Replaces the JAX package's expm (krylovfspssa_tpu/ops/expm.py:79), which
// XLA compiles; it is not a Pallas kernel.  The kernel reads mx and t from
// device memory, so the stepper can hand it a block size and a step that
// are still on the device (a breakdown sets both), and reads nothing back.
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
// What bounds it.  The work is (ideg + 1 + ns) products of 2 n^3
// operations and an LU with n right-hand sides: about 39 MFLOP at n = 102
// with ns = 10, 0.6 us at the card's 67 TFLOP/s of float64 tensor cores.
// But the products form a serial chain (each waits on the one before it),
// and the stepper needs one exponential at a time, so one block on one SM
// runs it: the bound that applies is one SM's share of the tensor cores,
// about 0.51 TFLOP/s, 77 us at n = 102 with ns = 10.  What the design
// does about it:
//
// 1. The block is padded to n_pad = 8 ceil(n / 8) columns, and the
//    padding is zero: the JAX package's masked form
//    (krylovfspssa_tpu/ops/expm.py:96-100).  The padding block solves to
//    the identity, and the leading block is the same computation.  hnorm
//    is taken over the leading n x n only.
// 2. Every product runs on the tensor cores (mma.sync m16n8k8 f64).  Warp
//    w owns the row strip w (16 rows, all n_pad columns; the last strip's
//    rows beyond n_pad are allocated and never read into a result) of
//    every product: its A operand is the strip's own rows, its B operand
//    the whole right factor, its 13 x 4 accumulators a lane sit in
//    registers.  A product X <- X Y therefore only reads X's rows that its
//    warp overwrites: it is in place after a __syncwarp, with no panel
//    copy and no block barrier, and the Horner chains run without one.
//    (The m16n8k4 and m8n8k4 shapes ran them slower on this card.)
// 3. The operands stay in shared memory while n_pad <= 104 (MH <= 104):
//    two matrices of 16 ceil(n_pad / 16) x (n_pad + 4) doubles, 193,536
//    bytes at MH = 102.  During Horner they are the B operand (A2) and
//    the current one of p and q; the chains of p and q run one after the
//    other (each in the reference's order), and the idle one waits in the
//    accumulators' layout, 8 of its tiles a strip in registers and 5 in
//    shared memory beside the operands (35,840 bytes).  The LU holds Q and
//    P, the squarings E and its square.  The row stride n_pad + 4 puts the
//    16 addresses of a half-warp's fragment load on 16 bank pairs.  Layout
//    that held (ptxas -v): 256 threads, 247 registers a thread in the
//    shared-memory kernel and 234 in the scratch one, no spills.
// 4. The LU with partial pivoting is blocked by panels of 8 columns on
//    [Q | P], right-looking with a look-ahead of one panel: warp 0 factors
//    a panel with its rows in registers (the pivot, the first largest
//    |value|, by two warp reductions and a ballot), every thread then
//    applies its row swaps and 8 x 8 unit-lower solve to one column of
//    Q's rest and of P, and the trailing rank-8 update runs on the
//    tensor cores (m8n8k4), the next panel's columns by warp 0 (which then factors
//    it) and the rest by the other warps meanwhile.  The back
//    substitution goes by 8-row blocks from the bottom, each an 8 x 8
//    upper solve a column and a tensor-core update of the rows above.
//    Two block barriers a panel, instead of about six a row.
// 5. Blocks with n_pad > 104 (m_max above 102) keep the same tiles with
//    their operands in a global scratch that the wrapper passes only
//    then: four matrices (the idle one of p and q and a product's target
//    among them), products out of place in chunks of 13 column tiles.
//
// What still holds it back: one SM.  Stamped with clock64 phase by phase
// at n = 102 and ns = 7 on an H100, a call spends about half its cycles
// in the products (each at about three quarters of one SM's share of the
// float64 tensor-core peak: 7 strips on 4 schedulers) and most of the
// rest in the LU: each pivot step of a panel is a chain on one warp,
// which the look-ahead overlaps with the trailing update but cannot
// shorten.  A cluster of blocks could
// split each product's strips over several SMs through distributed shared
// memory; that is left for a later change.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;        // a column tile, and the LU's panel width
constexpr int kRows = 16;       // the rows of a strip: the m16n8k8 tile
constexpr int kMaxT = 13;       // column tiles a warp accumulates at once
constexpr int kRegT = 8;        // tiles of the idle strip in registers
constexpr int kPanelRows = 4;   // panel rows a lane holds in registers
constexpr int kMaxDeg = 32;
// the shared-memory design (n_pad <= kTile * kMaxT) gives each strip of a
// product its own warp
static_assert((kMaxT + 1) / 2 <= kWarps, "a strip per warp");

struct Mat {
  double* a;
  int ld;
  __device__ double& operator()(int i, int j) const { return a[i * ld + j]; }
};

// With g = lane / 4 and c = lane % 4:
// d (8 x 8; (g, 2c), (g, 2c + 1)) += a (8 x 4; (g, c)) b (4 x 8; (c, g))
__device__ __forceinline__ void mma884(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// d (16 x 8; (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1)) +=
// a (16 x 8; (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4))
// b (8 x 8; (c, g), (c + 4, g))
__device__ __forceinline__ void mma1688(double (&d)[4], double a0, double a1,
                                        double a2, double a3, double b0,
                                        double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// the warp's index, broadcast from lane 0 so that the compiler knows it is
// the same in every lane: branches on it then need no divergence
// handling around the shuffles and tensor-core products they hold
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 5, 0);
}

// max that keeps a NaN (torch.max propagates it)
__device__ double nanmax(double a, double b) {
  return (b > a || isnan(b)) ? b : a;
}

// Z <- alpha (X Y) + beta I over n_pad = 8 T.  Warp w computes the 16-row
// strips w, w + kWarps, ... in chunks of kMaxT column tiles; the rows of
// the last strip beyond n_pad are rows of the allocation that no result
// reads.  Z may be X when T <= kMaxT: a strip is then one chunk, and its
// rows of X are read by its warp alone.
__device__ void product(Mat Z, Mat X, Mat Y, int T, double alpha,
                        double beta) {
  const int lane = threadIdx.x & 31, warp = warp_id();
  const int g = lane >> 2, c = lane & 3;
  const int np = kTile * T, strips = (T + 1) / 2;
  for (int s = warp; s < strips; s += kWarps) {
    __syncwarp();  // the strip's lanes wrote X and Z before
    const int i0 = kRows * s + g;
    const double* x0 = &X(i0, c);
    const double* x1 = &X(i0 + 8, c);
    for (int c0 = 0; c0 < T; c0 += kMaxT) {
      double acc[kMaxT][4];
#pragma unroll
      for (int t = 0; t < kMaxT; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0;
      const double* yr = &Y(c, kTile * c0 + g);
      for (int k = 0; k < np; k += 8) {
        const double a0 = x0[k], a1 = x1[k], a2 = x0[k + 4], a3 = x1[k + 4];
        const double* yk = yr + k * Y.ld;
#pragma unroll
        for (int t = 0; t < kMaxT; ++t) {
          if (c0 + t < T)
            mma1688(acc[t], a0, a1, a2, a3, yk[kTile * t],
                    yk[4 * Y.ld + kTile * t]);
        }
      }
      if (Z.a == X.a) __syncwarp();
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        if (c0 + t < T) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = i0 + 8 * (q >> 1);
            const int j = kTile * (c0 + t) + 2 * c + (q & 1);
            Z(i, j) = alpha * acc[t][q] + (i == j ? beta : 0.0);
          }
        }
      }
    }
  }
}

// D -= L U on count 8 x 8 tiles, by the warps w0 .. w0 + nw - 1, two a
// warp at a time: tile(w, D, U, r0, c0) names tile w (rows r0.., columns
// c0.. of D; U the B operand's matrix), whose A operand is L's 8 x 8 block
// at (r0, k0), and whose B operand is U's rows k0.. at column c0.
template <class F>
__device__ __forceinline__ void update_tiles(int count, Mat L, int k0,
                                             int w0, int nw, F tile) {
  const int lane = threadIdx.x & 31, warp = warp_id();
  const int g = lane >> 2, c = lane & 3;
  for (int w = warp - w0; w < count; w += 2 * nw) {
    const bool two = w + nw < count;
    Mat D[2], U[2];
    int r0[2], c0[2];
    tile(w, D[0], U[0], r0[0], c0[0]);
    tile(two ? w + nw : w, D[1], U[1], r0[1], c0[1]);
    double d[2][2], a[2][2], b[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = r0[h] + g, j = c0[h] + 2 * c;
      d[h][0] = D[h](i, j);
      d[h][1] = D[h](i, j + 1);
      a[h][0] = -L(i, k0 + c);
      a[h][1] = -L(i, k0 + 4 + c);
      b[h][0] = U[h](k0 + c, c0[h] + g);
      b[h][1] = U[h](k0 + 4 + c, c0[h] + g);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mma884(d[h], a[h][0], b[h][0]);
      mma884(d[h], a[h][1], b[h][1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 0 || two) {
        const int i = r0[h] + g, j = c0[h] + 2 * c;
        D[h](i, j) = d[h][0];
        D[h](i, j + 1) = d[h][1];
      }
    }
  }
}

// The panel Q[k0:n, k0:k0 + 8] factored in place by one warp, its rows in
// registers (n - k0 <= 32 kPanelRows): lane l holds rows k0 + l + 32 m.
// piv[a] is the row swapped with k0 + a.
__device__ void panel_regs(Mat Q, int k0, int n, int* piv) {
  const int lane = threadIdx.x & 31;
  double v[kPanelRows][kTile];
#pragma unroll
  for (int m = 0; m < kPanelRows; ++m) {
    const int r = k0 + lane + 32 * m;
#pragma unroll
    for (int j = 0; j < kTile; ++j) v[m][j] = r < n ? Q(r, k0 + j) : 0.0;
  }
#pragma unroll
  for (int kk = 0; kk < kTile; ++kk) {
    const int k = k0 + kk;
    // the first largest |value| of column k over rows k..n-1: a key a
    // row (|value|'s bits + 1, 0 for a NaN or a row out of range: keys
    // order as the values), the largest key by two 32-bit reductions,
    // then the first row that holds it
    unsigned long long key[kPanelRows], mine = 0;
#pragma unroll
    for (int m = 0; m < kPanelRows; ++m) {
      const int r = k0 + lane + 32 * m;
      const double a = fabs(v[m][kk]);
      key[m] = r >= k && r < n && !isnan(a)
                   ? static_cast<unsigned long long>(__double_as_longlong(a)) + 1
                   : 0;
      mine = key[m] > mine ? key[m] : mine;
    }
    const unsigned hi = static_cast<unsigned>(mine >> 32);
    const unsigned top = __reduce_max_sync(0xffffffffu, hi);
    const unsigned low = __reduce_max_sync(
        0xffffffffu, hi == top ? static_cast<unsigned>(mine) : 0u);
    const unsigned long long best =
        static_cast<unsigned long long>(top) << 32 | low;
    int bi = k;
#pragma unroll
    for (int m = kPanelRows - 1; m >= 0; --m) {
      const unsigned hit =
          __ballot_sync(0xffffffffu, best != 0 && key[m] == best);
      if (hit) bi = k0 + 32 * m + __ffs(static_cast<int>(hit)) - 1;
    }
    // row k and the pivot row (slot pm of lane pl; pm is the same in every
    // lane, so a branch picks the slot), broadcast; then swapped
    const int pl = (bi - k0) & 31, pm = (bi - k0) >> 5;
    double prow[kTile], krow[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      krow[j] = __shfl_sync(0xffffffffu, v[0][j], kk);
      prow[j] = krow[j];
    }
#pragma unroll
    for (int m = 0; m < kPanelRows; ++m) {
      if (m == pm && bi != k) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          prow[j] = __shfl_sync(0xffffffffu, v[m][j], pl);
          if (lane == kk) v[0][j] = prow[j];
          if (lane == pl) v[m][j] = krow[j];
        }
      }
    }
    if (lane == 0) piv[kk] = bi;
    const double rd = 1.0 / prow[kk];
#pragma unroll
    for (int m = 0; m < kPanelRows; ++m) {
      const int r = k0 + lane + 32 * m;
      if (r > k && r < n) {
        const double l = v[m][kk] * rd;
        v[m][kk] = l;
#pragma unroll
        for (int j = kk + 1; j < kTile; ++j) v[m][j] = fma(-l, prow[j], v[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kPanelRows; ++m) {
    const int r = k0 + lane + 32 * m;
    if (r < n) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) Q(r, k0 + j) = v[m][j];
    }
  }
}

// The same panel in place in memory, for taller panels (global scratch).
__device__ void panel_mem(Mat Q, int k0, int n, int* piv) {
  const int lane = threadIdx.x & 31;
  for (int k = k0; k < k0 + kTile; ++k) {
    double best = -1.0;
    int bi = k;
    for (int i = k + lane; i < n; i += 32) {
      const double a = fabs(Q(i, k));
      if (a > best) {
        best = a;
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
    bi = __shfl_sync(0xffffffffu, bi, 0);
    if (lane == 0) piv[k - k0] = bi;
    if (bi != k && lane < kTile) {
      const double tmp = Q(k, k0 + lane);
      Q(k, k0 + lane) = Q(bi, k0 + lane);
      Q(bi, k0 + lane) = tmp;
    }
    __syncwarp();
    const double rd = 1.0 / Q(k, k);
    for (int i = k + 1 + lane; i < n; i += 32) {
      const double l = Q(i, k) * rd;
      Q(i, k) = l;
      for (int j = k + 1; j < k0 + kTile; ++j)
        Q(i, j) = fma(-l, Q(k, j), Q(i, j));
    }
    __syncwarp();
  }
}

// The panel Q[k0:n, k0:k0 + 8] factored in place by the calling warp.
__device__ __forceinline__ void panel(Mat Q, int k0, int n, int* piv) {
  if (n - k0 <= 32 * kPanelRows)
    panel_regs(Q, k0, n, piv);
  else
    panel_mem(Q, k0, n, piv);
}

// P <- Q^{-1} P over n = 8 T rows (Q is overwritten by its LU factors).
// Right-looking with a look-ahead of one panel: while warp 0 brings the
// next panel's columns up to date and factors them, the other warps
// update the rest of the trailing matrix.
__device__ void lu_solve(Mat Q, Mat P, int T, int* piv) {
  const int warp = warp_id();
  const int n = kTile * T;
  for (int kb = 0; kb < T; ++kb) {
    const int k0 = kTile * kb, k1 = k0 + kTile;
    // the trailing rank-8 update left by the panel before (kp), the rows
    // below it: warp 0 takes this panel's columns and then factors it,
    // the others Q right of it and P
    const int kp = k0 - kTile, qt = T - kb;
    if (warp == 0) {
      if (kb > 0)
        update_tiles(qt, Q, kp, 0, 1,
                     [&](int w, Mat& D, Mat& U, int& r0, int& c0) {
                       D = U = Q;
                       r0 = k0 + kTile * w;
                       c0 = k0;
                     });
      __syncwarp();
      panel(Q, k0, n, piv);
    } else if (kb > 0) {
      const int ct = qt - 1 + T;
      update_tiles(qt * ct, Q, kp, 1, kWarps - 1,
                   [&](int w, Mat& D, Mat& U, int& r0, int& c0) {
                     const int cc = w % ct;
                     r0 = k0 + kTile * (w / ct);
                     D = U = cc < qt - 1 ? Q : P;
                     c0 = cc < qt - 1 ? k1 + kTile * cc
                                      : kTile * (cc - qt + 1);
                   });
    }
    __syncthreads();
    // the panel's row swaps and its unit-lower 8 x 8 solve, one column a
    // thread: Q right of the panel and all of P
    double l[kTile][kTile];
    int p[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      p[a] = piv[a];
#pragma unroll
      for (int b = 0; b < a; ++b) l[a][b] = Q(k0 + a, k0 + b);
    }
    const int qcols = n - k1;
    for (int e = threadIdx.x; e < qcols + n; e += kThreads) {
      const Mat M = e < qcols ? Q : P;
      const int col = e < qcols ? k1 + e : e - qcols;
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        if (p[a] != k0 + a) {
          const double tmp = M(k0 + a, col);
          M(k0 + a, col) = M(p[a], col);
          M(p[a], col) = tmp;
        }
      }
      double x[kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) x[a] = M(k0 + a, col);
#pragma unroll
      for (int a = 1; a < kTile; ++a) {
#pragma unroll
        for (int b = 0; b < a; ++b) x[a] = fma(-l[a][b], x[b], x[a]);
      }
#pragma unroll
      for (int a = 0; a < kTile; ++a) M(k0 + a, col) = x[a];
    }
    __syncthreads();
  }
  // back substitution by 8-row blocks from the bottom: an 8 x 8 upper
  // solve a column, then the rows above
  for (int kb = T - 1; kb >= 0; --kb) {
    const int k0 = kTile * kb;
    {
      double u[kTile][kTile], rd[kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        rd[a] = 1.0 / Q(k0 + a, k0 + a);
#pragma unroll
        for (int b = a + 1; b < kTile; ++b) u[a][b] = Q(k0 + a, k0 + b);
      }
      for (int col = threadIdx.x; col < n; col += kThreads) {
        double x[kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a) x[a] = P(k0 + a, col);
#pragma unroll
        for (int a = kTile - 1; a >= 0; --a) {
#pragma unroll
          for (int b = a + 1; b < kTile; ++b)
            x[a] = fma(-u[a][b], x[b], x[a]);
          x[a] *= rd[a];
        }
#pragma unroll
        for (int a = 0; a < kTile; ++a) P(k0 + a, col) = x[a];
      }
    }
    __syncthreads();
    update_tiles(kb * T, Q, k0, 0, kWarps,
                 [&](int w, Mat& D, Mat& U, int& r0, int& c0) {
                   D = U = P;
                   r0 = kTile * (w / T);
                   c0 = kTile * (w % T);
                 });
    __syncthreads();
  }
}

// this warp's strip of the idle one of p and q (shared-memory design), in
// the accumulators' layout: tiles below kRegT in registers, the others in
// shared memory beside the two operands
struct Strip {
  double v[kRegT][4];
  double* spare;
};


// calls f(i, j, value) for each element of this warp's strip of the idle
// one (shared-memory design), (i, j) its place in the matrix: the register
// tiles unrolled, the others in a loop
template <class F>
__device__ __forceinline__ void each_idle(Strip& s, int T, F f) {
  const int lane = threadIdx.x & 31, warp = warp_id();
  const int i0 = kRows * warp + (lane >> 2), c = lane & 3;
  if (warp >= (T + 1) / 2) return;
#pragma unroll
  for (int t = 0; t < kRegT; ++t) {
    if (t < T) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        f(i0 + 8 * (q >> 1), kTile * t + 2 * c + (q & 1), s.v[t][q]);
    }
  }
  for (int t = kRegT; t < T; ++t) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      f(i0 + 8 * (q >> 1), kTile * t + 2 * c + (q & 1),
        s.spare[((t - kRegT) * 4 + q) * 32 + lane]);
  }
}

// X <- alpha X Y + beta I: in place (shared memory) or through Z, which
// then changes places with X (scratch)
template <bool kShared>
__device__ __forceinline__ void mul(Mat& X, Mat& Z, Mat Y, int T,
                                    double alpha, double beta) {
  if (kShared) {
    product(X, X, Y, T, alpha, beta);
  } else {
    product(Z, X, Y, T, alpha, beta);
    const Mat tmp = X;
    X = Z;
    Z = tmp;
  }
}

// Q = q - p into Y, P = p into X at (i, j), from X and the idle one
// (other) of p and q; the padding block Q = I, P = 0
__device__ __forceinline__ void split(Mat X, Mat Y, int i, int j,
                                      double other, bool x_is_q, int n) {
  const double x = X(i, j);
  const double q = x_is_q ? x : other, p = x_is_q ? other : x;
  const bool in = i < n && j < n;
  Y(i, j) = in ? q - p : (i == j ? 1.0 : 0.0);
  X(i, j) = in ? p : 0.0;
}

// Y(i, j) = f(i, j) for i, j < np, a batch of 4 rows x 4 column groups of
// 32 at a time for each warp: the batch's values are fetched before any is
// stored, so a batch waits for one load latency, not sixteen.
template <class F>
__device__ __forceinline__ void fill(Mat Y, int rows, int cols, F f) {
  const int lane = threadIdx.x & 31, warp = warp_id();
  for (int i0 = warp; i0 < rows; i0 += 4 * kWarps) {
    for (int j0 = lane; j0 < cols; j0 += 4 * 32) {
      double v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + r * kWarps, j = j0 + 32 * u;
          v[r][u] = i < rows && j < cols ? f(i, j) : 0.0;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + r * kWarps, j = j0 + 32 * u;
          if (i < rows && j < cols) Y(i, j) = v[r][u];
        }
      }
    }
  }
}

// A (zero padding) into Y's leading np x np
__device__ __forceinline__ void load_a(Mat Y, const double* __restrict__ H,
                                       int MH, int n, int np) {
  fill(Y, np, np, [&](int i, int j) {
    return i < n && j < n ? H[i * MH + j] : 0.0;
  });
}

// kShared: the operands in shared memory (n_pad <= kTile * kMaxT), the
// idle one of p and q in registers and beside them; else in the global
// scratch.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    expm_pade_kernel(const double* __restrict__ H,
                     const long long* __restrict__ mx_p,
                     const double* __restrict__ t_p, double* __restrict__ E,
                     double* __restrict__ stats, double* scratch, int MH,
                     int ideg) {
  extern __shared__ double smem[];
  __shared__ double coef[kMaxDeg + 1];
  __shared__ double red[kWarps];
  __shared__ int piv[kTile];
  const int lane = threadIdx.x & 31, warp = warp_id();
  const long long mx_raw = *mx_p;
  const int n = static_cast<int>(mx_raw < 0 ? 0 : (mx_raw > MH ? MH : mx_raw));
  const double t = *t_p;

  const int T = (n + kTile - 1) / kTile, np = kTile * T;
  const int rows = kRows * ((T + 1) / 2), ld = np + 4;
  double* base = kShared ? smem : scratch;
  Mat X{base, ld}, Y{base + rows * ld, ld};
  Mat I{base + 2 * rows * ld, ld}, Z{base + 3 * rows * ld, ld};  // scratch
  Strip idle;  // shared memory
  idle.spare = base + 2 * rows * ld + warp * (kMaxT - kRegT) * 4 * 32;

  // ---- hnorm and ns (dgpadm.f:68-87), from A in Y: a row a thread, its
  // columns taken from the diagonal on (no two lanes on one bank) ------
  load_a(Y, H, MH, n, np);
  if (threadIdx.x == 0) {
    coef[0] = 1.0;
    for (int k = 1; k <= ideg; ++k)
      coef[k] = coef[k - 1] * static_cast<double>(ideg + 1 - k) /
                static_cast<double>(k * (2 * ideg + 1 - k));
  }
  __syncthreads();
  double mymax = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    double s = 0.0;
    for (int j = i; j < i + n; ++j) s += fabs(Y(i, j < n ? j : j - n));
    mymax = nanmax(mymax, s);
  }
  for (int off = 16; off > 0; off >>= 1)
    mymax = nanmax(mymax, __shfl_down_sync(0xffffffffu, mymax, off));
  if (lane == 0) red[warp] = mymax;
  __syncthreads();
  double rmax = 0.0;
  for (int w = 0; w < kWarps; ++w) rmax = nanmax(rmax, red[w]);
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
  if (threadIdx.x == 0) {
    stats[0] = hnorm;
    stats[1] = static_cast<double>(ns);
  }
  if (n == 0) {
    fill(Mat{E, MH}, MH, MH, [](int i, int j) { return i == j ? 1.0 : 0.0; });
    return;
  }
  const double scale = t / exp2(static_cast<double>(ns));

  // ---- A2 = s^2 A A; Horner on the even/odd parts (dgpadm.f:89-131) ---
  product(X, Y, Y, T, scale * scale, 0.0);
  {
    const Mat tmp = X;
    X = Y;
    Y = tmp;
  }
  __syncthreads();
  // The reference alternates q = q A2 + c_{k-1} I (k = ideg - 1, ideg - 3,
  // ...) and p = p A2 + c_{k-1} I (k = ideg - 2, ...), then multiplies
  // one of them by s A (q if iodd = 1).  The two chains do not touch each
  // other, so each runs whole, in the reference's order: first the one
  // the odd part leaves alone, while the other is still c I, then, with
  // the first parked as the idle one, the other.
  const int iodd = (ideg - 1) % 2 == 0 ? 1 : 0;
  const bool x_is_q = iodd == 1;  // the matrix in X at the odd part
  const int k_first = x_is_q ? ideg - 2 : ideg - 1;  // and its c_k first
  const int k_second = x_is_q ? ideg - 1 : ideg - 2;
  for (int i = warp; i < np; i += kWarps)
    for (int j = lane; j < np; j += 32)
      X(i, j) = i == j ? coef[k_first + 1] : 0.0;
  __syncthreads();
  for (int k = k_first; k > 0; k -= 2)
    mul<kShared>(X, Z, Y, T, 1.0, coef[k - 1]);
  // park the first as the idle one; X = c I starts the other
  const double c2 = coef[k_second + 1];
  if (kShared) {
    each_idle(idle, T, [&](int i, int j, double& v) {
      v = X(i, j);
      X(i, j) = i == j ? c2 : 0.0;
    });
  } else {
    __syncthreads();
    const Mat tmp = X;
    X = I;
    I = tmp;
    for (int i = warp; i < np; i += kWarps)
      for (int j = lane; j < np; j += 32) X(i, j) = i == j ? c2 : 0.0;
    __syncthreads();
  }
  for (int k = k_second; k > 0; k -= 2)
    mul<kShared>(X, Z, Y, T, 1.0, coef[k - 1]);
  // ---- (+/-)(I + 2 (q - p)^{-1} p) (dgpadm.f:133-155) ----------------
  __syncthreads();
  load_a(Y, H, MH, n, np);
  __syncthreads();
  mul<kShared>(X, Z, Y, T, scale, 0.0);
  __syncthreads();
  if (kShared) {
    each_idle(idle, T, [&](int i, int j, double& v) {
      if (i < np) split(X, Y, i, j, v, x_is_q, n);
    });
  } else {
    for (int i = warp; i < np; i += kWarps)
      for (int j = lane; j < np; j += 32) split(X, Y, i, j, I(i, j), x_is_q, n);
  }
  __syncthreads();
  lu_solve(Y, X, T, piv);
  const double sign = (iodd == 1 && ns == 0) ? -1.0 : 1.0;
  for (int i = warp; i < np; i += kWarps)
    for (int j = lane; j < np; j += 32)
      X(i, j) = sign * (2.0 * X(i, j) + (i == j ? 1.0 : 0.0));
  __syncthreads();
  // ---- squaring: E <- E^(2^ns) (dgpadm.f:157-166) --------------------
  for (int s = 0; s < ns; ++s) {
    product(Y, X, X, T, 1.0, 0.0);
    __syncthreads();
    const Mat tmp = X;
    X = Y;
    Y = tmp;
  }
  fill(Mat{E, MH}, MH, MH, [&](int i, int j) {
    return i < n && j < n ? X(i, j) : (i == j ? 1.0 : 0.0);
  });
}

// The operands' rows and row stride at MH: n_pad rounded up to the strip.
int rows_of(int MH) {
  return kRows * ((MH + kRows - 1) / kRows);
}
int ld_of(int MH) { return kTile * ((MH + kTile - 1) / kTile) + 4; }

// Doubles of dynamic shared memory for the shared-memory design, 0 when
// MH is too large for it: the two operands and the idle strips' tiles
// from kRegT on.
long long shared_doubles(int MH) {
  const int T = (MH + kTile - 1) / kTile;
  if (T > kMaxT) return 0;
  const long long spare =
      T > kRegT ? static_cast<long long>((T + 1) / 2) * (kMaxT - kRegT) * 128
                : 0;
  return 2LL * rows_of(MH) * ld_of(MH) + spare;
}

}  // namespace

extern "C" {

// Doubles of global scratch kfs_expm_pade needs for an (MH, MH) workspace
// on the current device: 0 when the operands fit in shared memory, else
// four matrices of rows_of(MH) x ld_of(MH); -1 on a CUDA error.
long long kfs_expm_pade_scratch(int MH) {
  // per device, read and set once: the dynamic shared memory a block of
  // the shared-memory design may use (the opt-in limit less its static
  // shared memory), granted to the kernel up front
  static int room[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (room[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    if (cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, expm_pade_kernel<true>) != cudaSuccess)
      return -1;
    const int bytes = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(expm_pade_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes) != cudaSuccess)
      return -1;
    room[dev] = bytes;
  }
  const long long dyn = shared_doubles(MH) * 8;
  if (dyn > 0 && dyn <= room[dev]) return 0;
  return 4LL * rows_of(MH) * ld_of(MH);
}

// H, E: (MH, MH) float64; mx: one int64, t: one float64, both in device
// memory; stats: two float64 (hnorm, ns); scratch: kfs_expm_pade_scratch
// (MH) float64 (null when that is 0).  Returns cudaGetLastError() after
// the launch (0 = launched).
int kfs_expm_pade(const void* H, const void* mx, const void* t, void* E,
                  void* stats, void* scratch, int MH, int ideg,
                  void* stream) {
  if (MH <= 0 || ideg < 1 || ideg > kMaxDeg) return cudaErrorInvalidValue;
  const long long need = kfs_expm_pade_scratch(MH);
  if (need < 0) return cudaErrorInvalidDevice;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (need == 0) {
    expm_pade_kernel<true>
        <<<1, kThreads, static_cast<int>(shared_doubles(MH) * 8), st>>>(
            static_cast<const double*>(H), static_cast<const long long*>(mx),
            static_cast<const double*>(t), static_cast<double*>(E),
            static_cast<double*>(stats), nullptr, MH, ideg);
  } else {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    expm_pade_kernel<false><<<1, kThreads, 0, st>>>(
        static_cast<const double*>(H), static_cast<const long long*>(mx),
        static_cast<const double*>(t), static_cast<double*>(E),
        static_cast<double*>(stats), static_cast<double*>(scratch), MH,
        ideg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
