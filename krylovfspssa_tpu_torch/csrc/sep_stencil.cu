// C entry points of the stencil kernel body (sep_stencil.cuh), bound with
// ctypes by ops/stencil_cuda.py.  Each mode takes the same geometry: the
// rows [z0, z0 + rows) of the flat box and the hl cells of x on either side
// of them (left, right).  box_stencil launches the separable mode with
// z0 = 0, rows = vol and no halos, halo_stencil with one rank's rows and
// its two halos; direct_stencil launches the direct mode in either of
// those two ways.

#include "sep_stencil.cuh"

namespace {

template <typename T>
int run(const void* x, const void* mask, const void* left, const void* right,
        const void* diag, const void* tables, const void* row_factors,
        const void* meta, void* y, int rows, int z0, int hl, int n_reactions,
        int n_meta, int n_tab, int log2_tile, void* stream) {
  const kfs_sep::Args a{x,
                        static_cast<const uint8_t*>(mask),
                        left,
                        right,
                        diag,
                        tables,
                        row_factors,
                        nullptr,
                        static_cast<const int*>(meta),
                        y,
                        rows,
                        z0,
                        hl,
                        n_reactions,
                        n_meta,
                        n_tab,
                        log2_tile,
                        0};
  return kfs_sep::launch<T, false>(a, stream);
}

template <typename T>
int run_direct(const void* x, const void* mask, const void* left,
               const void* right, const void* diag, const void* rates,
               const void* meta, void* y, int rows, int z0, int hl,
               int n_reactions, void* stream) {
  const kfs_sep::Args a{x,
                        static_cast<const uint8_t*>(mask),
                        left,
                        right,
                        diag,
                        nullptr,
                        nullptr,
                        rates,
                        static_cast<const int*>(meta),
                        y,
                        rows,
                        z0,
                        hl,
                        n_reactions,
                        n_reactions,
                        0,
                        0,
                        0};
  return kfs_sep::launch<T, true>(a, stream);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = launched).
int kfs_sep_stencil_f64(const void* x, const void* mask, const void* left,
                        const void* right, const void* diag,
                        const void* tables, const void* row_factors,
                        const void* meta, void* y, int rows, int z0, int hl,
                        int n_reactions, int n_meta, int n_tab, int log2_tile,
                        void* stream) {
  return run<double>(x, mask, left, right, diag, tables, row_factors, meta, y,
                     rows, z0, hl, n_reactions, n_meta, n_tab, log2_tile,
                     stream);
}

int kfs_sep_stencil_f32(const void* x, const void* mask, const void* left,
                        const void* right, const void* diag,
                        const void* tables, const void* row_factors,
                        const void* meta, void* y, int rows, int z0, int hl,
                        int n_reactions, int n_meta, int n_tab, int log2_tile,
                        void* stream) {
  return run<float>(x, mask, left, right, diag, tables, row_factors, meta, y,
                    rows, z0, hl, n_reactions, n_meta, n_tab, log2_tile,
                    stream);
}

// meta is off[R]; diag and rates are D and U, (R, rows), of the rows.
int kfs_direct_stencil_f64(const void* x, const void* mask, const void* left,
                           const void* right, const void* diag,
                           const void* rates, const void* meta, void* y,
                           int rows, int z0, int hl, int n_reactions,
                           void* stream) {
  return run_direct<double>(x, mask, left, right, diag, rates, meta, y, rows,
                            z0, hl, n_reactions, stream);
}

int kfs_direct_stencil_f32(const void* x, const void* mask, const void* left,
                           const void* right, const void* diag,
                           const void* rates, const void* meta, void* y,
                           int rows, int z0, int hl, int n_reactions,
                           void* stream) {
  return run_direct<float>(x, mask, left, right, diag, rates, meta, y, rows,
                           z0, hl, n_reactions, stream);
}

}  // extern "C"
