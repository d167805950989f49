// Block-sparse FeaStConv aggregate, backward, for Hopper (sm_90a).
//
// Replaces TPU kernel #6 of geobignn_tpu/ops/blocksparse.py: `_bwd_kernel`
// (aggregate-first, C_out >= C_in) and `_bwd_kernel_tf` (transform-first,
// C_out < C_in), called via _bs_bwd, together with the fold of their window
// slabs over blk_idx (_fold_blocks_T): the kernels of window_bwd.cuh own
// their output rows, so there are no slabs and no fold.  The row pass finds
// a set slot's node through blk_idx; the column pass needs, for each column
// block, the (row block, list position) pairs whose windows hold it, which
// the wrapper derives from blk_idx as a CSR transpose (colptr, pairs).  A
// padded list entry (the row block's own index again, under an all-zero
// mask) is one more pair whose column scan finds nothing.

#include "window_bwd.cuh"

extern "C" {

// Limits the wrapper checks before it calls in: the tile is a multiple of
// tile_multiple, heads <= max_heads, heads * cv <= max_width.
int gbn_bs_bwd_tile_multiple() { return kColNodes; }
int gbn_bs_bwd_max_heads() { return kMaxHeads; }
int gbn_bs_bwd_max_width() { return kMaxChunks * kChunkCols; }

// r, p (n, heads); x (n, c_in); w (heads, c_in, c_out); m (n/tile, tile,
// k*tile) int8, 16-byte aligned; blk_idx (n/tile, k), colptr (n/tile + 1)
// and pairs (n/tile * k) int64: pairs[colptr[c] .. colptr[c+1]) hold b*k +
// position for every entry of blk_idx equal to c; gout (n, c_out).
// Scratch, each (n, ldk) with ldk = heads*cv rounded up to a multiple of 4
// and cv = tf ? c_out : c_in: v, g, and y (transform-first) or gy
// (aggregate-first, the other may be null), wl (zr or yb).  wpart (n/tile,
// heads*cv, tf ? c_in : c_out).  Outputs rbar, pbar (n, heads), xbar
// (n, c_in).  part_ms: null, or kMaxParts floats that receive each launch's
// milliseconds.  All f32 unless noted, contiguous, on the current device.
// Returns the cudaGetLastError() code after the launches (0 on success).
int gbn_bs_aggregate_bwd(const float* r, const float* p, const float* x,
                         const float* w, const int8_t* m,
                         const long long* blk_idx, const long long* colptr,
                         const long long* pairs, const float* gout, float* v,
                         float* g, float* y, float* gy, float* wl,
                         float* wpart, float* rbar, float* pbar, float* xbar,
                         int n, int tile, int k, int heads, int c_in,
                         int c_out, int ldk, int tf, int bf16, void* stream,
                         float* part_ms) {
  const WindowMap<true> map{blk_idx, colptr, pairs, tile, k, n / tile};
  return launch_window_bwd<true>(r, p, x, w, m, gout, v, g, y, gy, wl, wpart,
                                 rbar, pbar, xbar, map, n, heads, c_in, c_out,
                                 ldk, tf, bf16, stream, part_ms);
}

}  // extern "C"
