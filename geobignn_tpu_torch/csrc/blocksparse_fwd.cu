// Block-sparse FeaStConv aggregate, forward, for Hopper (sm_90a).
//
// Replaces TPU kernel #5 of geobignn_tpu/ops/blocksparse.py: `_fwd_kernel`
// (aggregate-first, C_out >= C_in) and `_fwd_kernel_tf` (transform-first,
// C_out < C_in), called via _call_fwd.  There `blk_idx` rides as a
// scalar-prefetch operand that drives the index maps of K window operands
// per row block; here the row walk of window_fwd.cuh reads it directly: the
// window of row block b is the K column blocks blk_idx[b, :], and a set
// slot w of a row finds its node through blk_idx[b, w / T].  The mask,
// (B, T, K T) int8 with about 12 set slots per row, is most of the bytes
// the kernel must move; each row's part of it is read once, 16 bytes a lane.

#include "window_fwd.cuh"

extern "C" {

// Limits the wrapper checks before it calls in: the tile is a multiple of
// tile_multiple, heads <= max_heads, heads * cv <= max_width.
int gbn_bs_tile_multiple() { return 32; }
int gbn_bs_max_heads() { return kMaxHeads; }
int gbn_bs_max_width() { return kMaxChunks * kChunkCols; }

// r, p (n, heads); x (n, c_in); w (heads, c_in, c_out); m (n/tile, tile,
// k*tile) int8, 16-byte aligned; blk_idx (n/tile, k) int64 with entries in
// [0, n/tile); out (n, c_out).  Scratch: v and (aggregate-first only, else
// null) zr, each (n, ldk) with ldk = heads*(tf ? c_out : c_in) rounded up
// to a multiple of 4.  part_ms: null, or kMaxParts floats that receive each
// launch's milliseconds.  All f32 unless noted, contiguous, on the current
// device.  Returns the cudaGetLastError() code after the launches (0 on
// success).
int gbn_bs_aggregate_fwd(const float* r, const float* p, const float* x,
                         const float* w, const int8_t* m,
                         const long long* blk_idx, float* v, float* zr,
                         float* out, int n, int tile, int k, int heads,
                         int c_in, int c_out, int ldk, int tf, int bf16,
                         void* stream, float* part_ms) {
  const WindowMap<true> map{blk_idx, nullptr, nullptr, tile, k, n / tile};
  return launch_window_fwd<true>(r, p, x, w, m, v, zr, out, map, n, heads,
                                 c_in, c_out, ldk, tf, bf16, stream, part_ms);
}

}  // extern "C"
