// Block-sparse FeaStConv aggregate, forward, for Hopper (sm_90a).
//
// Replaces TPU kernel #5 of geobignn_tpu/ops/blocksparse.py: `_fwd_kernel`
// (aggregate-first, C_out >= C_in) and `_fwd_kernel_tf` (transform-first,
// C_out < C_in), called via _call_fwd.  There `blk_idx` rides as a
// scalar-prefetch operand that drives the index maps of K window operands
// per row block; here the kernel of window_fwd.cuh reads it directly: the
// window of row block b is the K column blocks blk_idx[b, :], each staged
// chunk of 32 slots takes its first node from blk_idx[b, w / T] (T is a
// multiple of 32, so no chunk straddles two column blocks), and a chunk
// whose mask tile is empty is skipped.  The mask, (B, T, K T) int8 with
// about 12 set slots per row, is most of the bytes the kernel must move.

#include "window_fwd.cuh"

extern "C" {

// Limits the wrapper checks before it calls in.
int gbn_bs_rows_per_cta() { return kRows; }
int gbn_bs_max_heads() { return kMaxHeads; }
int gbn_bs_max_out() { return kMaxOut; }

// r, p (n, heads); x (n, c_in); w (heads, c_in, c_out); m (n/tile, tile,
// k*tile) int8; blk_idx (n/tile, k) int64 with entries in [0, n/tile);
// v scratch (n, heads*(tf ? c_out : c_in)); out (n, c_out).  All f32 unless
// noted, contiguous, on the current device; tile a multiple of 32.  Returns
// the cudaGetLastError() code after the launches (0 on success).
int gbn_bs_aggregate_fwd(const float* r, const float* p, const float* x,
                         const float* w, const int8_t* m,
                         const long long* blk_idx, float* v, float* out,
                         int n, int tile, int k, int heads, int c_in,
                         int c_out, int tf, int bf16, void* stream) {
  const WindowMap<true> map{blk_idx, nullptr, nullptr, tile, k, n / tile};
  return launch_window_fwd<true>(r, p, x, w, m, v, out, map, n, heads, c_in,
                                 c_out, tf, bf16, stream);
}

}  // extern "C"
