// Banded FeaStConv aggregate, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of geobignn_tpu/ops/banded_pallas.py:
//   #3 `_bwd_kernel` (aggregate-first, C_out >= C_in), called via
//      _banded_aggregate_bwd;
//   #4 `_bwd_kernel_tf` / `_bwd_body_tf` (transform-first, C_out < C_in).
// The kernels are window_bwd.cuh's, instantiated over the contiguous band:
// a node's column is scanned in the three row blocks that see it.

#include "window_bwd.cuh"

extern "C" {

// Limits the wrapper checks before it calls in: the tile is a multiple of
// tile_multiple, heads <= max_heads, heads * cv <= max_width.
int gbn_banded_bwd_tile_multiple() { return kColNodes; }
int gbn_banded_bwd_max_heads() { return kMaxHeads; }
int gbn_banded_bwd_max_width() { return kMaxChunks * kChunkCols; }

// r, p (n, heads); x (n, c_in); w (heads, c_in, c_out); m (n/tile, tile,
// 3*tile) int8, 16-byte aligned; gout (n, c_out).  Scratch, each (n, ldk)
// with ldk = heads*cv rounded up to a multiple of 4 and cv = tf ? c_out :
// c_in: v, g, and y (transform-first) or gy (aggregate-first, the other may
// be null), wl (zr or yb).  wpart (n/tile, heads*cv, tf ? c_in : c_out).
// Outputs rbar, pbar (n, heads), xbar (n, c_in).  part_ms: null, or
// kMaxParts floats that receive each launch's milliseconds.  All f32 unless
// noted, contiguous, on the current device.  Returns the cudaGetLastError()
// code after the launches (0 on success).
int gbn_banded_aggregate_bwd(const float* r, const float* p, const float* x,
                             const float* w, const int8_t* m,
                             const float* gout, float* v, float* g, float* y,
                             float* gy, float* wl, float* wpart, float* rbar,
                             float* pbar, float* xbar, int n, int tile,
                             int heads, int c_in, int c_out, int ldk, int tf,
                             int bf16, void* stream, float* part_ms) {
  const WindowMap<false> map{nullptr, nullptr, nullptr, tile, 3, n / tile};
  return launch_window_bwd<false>(r, p, x, w, m, gout, v, g, y, gy, wl, wpart,
                                  rbar, pbar, xbar, map, n, heads, c_in, c_out,
                                  ldk, tf, bf16, stream, part_ms);
}

}  // extern "C"
