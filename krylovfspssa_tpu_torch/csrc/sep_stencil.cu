// C entry points of the separable stencil kernel (sep_stencil.cuh), bound
// with ctypes by ops/stencil_cuda.py: box_stencil launches them with
// z0 = 0, rows = vol and no halos, halo_stencil with one rank's rows and
// its two halos.

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
  return kfs_sep::launch<T>(a, stream);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
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

}  // extern "C"
