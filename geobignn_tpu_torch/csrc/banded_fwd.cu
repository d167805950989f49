// Banded FeaStConv aggregate, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of geobignn_tpu/ops/banded_pallas.py:
//   #1 `_fwd_kernel` (aggregate-first, C_out >= C_in), called via _call_fwd;
//   #2 `_fwd_kernel_tf` / `_fwd_body_tf` (transform-first, C_out < C_in).
// The launch sequence is window_fwd.cuh's, instantiated over the contiguous
// band: the window of band block b is the 3T nodes from (b-1)T, rows
// outside [0, N) read as zero.

#include "window_fwd.cuh"

extern "C" {

// Limits the wrapper checks before it calls in: the tile is a multiple of
// tile_multiple, heads <= max_heads, heads * cv <= max_width.
int gbn_banded_tile_multiple() { return 32; }
int gbn_banded_max_heads() { return kMaxHeads; }
int gbn_banded_max_width() { return kMaxChunks * kChunkCols; }

// r, p (n, heads); x (n, c_in); w (heads, c_in, c_out); m (n/tile, tile,
// 3*tile) int8, 16-byte aligned; out (n, c_out).  Scratch: v and (aggregate-
// first only, else null) zr, each (n, ldk) with ldk = heads*(tf ? c_out :
// c_in) rounded up to a multiple of 4.  part_ms: null, or kMaxParts floats
// that receive each launch's milliseconds.  All f32 unless noted,
// contiguous, on the current device.  Returns the cudaGetLastError() code
// after the launches (0 on success).
int gbn_banded_aggregate_fwd(const float* r, const float* p, const float* x,
                             const float* w, const int8_t* m, float* v,
                             float* zr, float* out, int n, int tile,
                             int heads, int c_in, int c_out, int ldk, int tf,
                             int bf16, void* stream, float* part_ms) {
  const WindowMap<false> map{nullptr, nullptr, nullptr, tile, 3, n / tile};
  return launch_window_fwd<false>(r, p, x, w, m, v, zr, out, map, n, heads,
                                  c_in, c_out, ldk, tf, bf16, stream, part_ms);
}

}  // extern "C"
