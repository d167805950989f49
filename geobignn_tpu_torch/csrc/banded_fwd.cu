// Banded FeaStConv aggregate, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of geobignn_tpu/ops/banded_pallas.py:
//   #1 `_fwd_kernel` (aggregate-first, C_out >= C_in), called via _call_fwd;
//   #2 `_fwd_kernel_tf` / `_fwd_body_tf` (transform-first, C_out < C_in).
// The kernel is window_fwd.cuh's, instantiated over the contiguous band:
// the window of band block b is the 3T nodes from (b-1)T, rows outside
// [0, N) read as zero.

#include "window_fwd.cuh"

extern "C" {

// Limits the wrapper checks before it calls in.
int gbn_banded_rows_per_cta() { return kRows; }
int gbn_banded_max_heads() { return kMaxHeads; }
int gbn_banded_max_out() { return kMaxOut; }

// r, p (n, heads); x (n, c_in); w (heads, c_in, c_out); m (n/tile, tile,
// 3*tile) int8; v scratch (n, heads*(tf ? c_out : c_in)); out (n, c_out).
// All f32 unless noted, contiguous, on the current device.  Returns the
// cudaGetLastError() code after the launches (0 on success).
int gbn_banded_aggregate_fwd(const float* r, const float* p, const float* x,
                             const float* w, const int8_t* m, float* v,
                             float* out, int n, int tile, int heads, int c_in,
                             int c_out, int tf, int bf16, void* stream) {
  const WindowMap<false> map{nullptr, nullptr, nullptr, tile, 3, n / tile};
  return launch_window_fwd<false>(r, p, x, w, m, v, out, map, n, heads, c_in,
                                  c_out, tf, bf16, stream);
}

}  // extern "C"
