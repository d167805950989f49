// FeaStConv window aggregate, forward, for Hopper (sm_90a): the launch
// sequence that banded_fwd.cu instantiates over the contiguous band and
// blocksparse_fwd.cu over block-sparse windows (WindowMap, banded_common.cuh).
//
// Function, for each row block b of T rows and its window of k T slots
// (slot w is node j = map.node(b, w); an absent node reads as zero):
//   D[t,w]  = sum_h r[t,h] p[w,h]                         (f32)
//   A[t,w]  = cd(M[t,w] / max(D[t,w], 1e-12))
//   V[w,k]  = cd(p[w,h] x[w,c])             k = h*C_in + c   (aggregate-first)
//           = cd(p[w,h] sum_c cd(w[h,c,o]) cd(x[w,c]))   k = h*C_out + o
//                                                         (transform-first)
//   Z[t,k]  = sum_w A[t,w] V[w,k]                          (f32 accumulate)
//   zr[t,k] = cd(Z[t,k] r[t,h(k)])
//   out[t,o] = sum_k cd(w[k,o]) zr[t,k]   (aggregate-first, w flattened
//                                          (H*C_in, C_out))
//            = sum_h zr[t, h*C_out + o]   (transform-first, the head sum)
// where cd() rounds to bf16 when the compute dtype is bf16 (identity for
// f32): the casts sit where the Pallas bodies put them, and every product
// of two bf16 values is exact in f32, so f32 FMAs or bf16 mma with f32
// accumulators reproduce the TPU's bf16-operand / f32-accumulate products
// up to summation order.
//
// What bounds it on the H100: bytes — the int8 mask and the (N, C)
// operands; only about 12 of a row's window slots are set, so the window
// product is a sparse one and a little arithmetic.  The TPU kernel keeps a
// block's whole (T, kT) f32 D and mask in VMEM and multiplies the window
// densely on the MXU; here nothing is computed for a slot that is not set:
//   - V is built once per node: an elementwise launch (aggregate-first), or
//     the tiled product Y = cd(x) cd(W2) with V = cd(p Y) as its epilogue
//     (transform-first; node_product.cuh, on the tensor cores under bf16);
//   - one warp per row walks the row's set slots with all K = H*cv columns
//     of Z in registers (window_walk.cuh): the mask, r and p are read once
//     per row, whatever K is;
//   - transform-first: the walk's epilogue is the r scaling and the head
//     sum, so `out` is written once;
//   - aggregate-first: the walk writes zr (N, K), and the W contraction
//     out = zr cd(W_flat) is the tiled product again.

#pragma once

#include "node_product.cuh"
#include "window_walk.cuh"

namespace {

// v and zr (aggregate-first only) are (n, ldk) scratch, ldk = heads*cv
// rounded up to a multiple of 4 with cv = tf ? c_out : c_in.  part_ms
// (nullable, kMaxParts floats) receives the milliseconds of each launch in
// order and makes the call synchronise.  Returns the cudaGetLastError()
// code after the launches (0 on success).
template <bool kIndexed>
int launch_window_fwd(const float* r, const float* p, const float* x,
                      const float* w, const int8_t* m, float* v, float* zr,
                      float* out, WindowMap<kIndexed> map, int n, int heads,
                      int c_in, int c_out, int ldk, int tf, int bf16,
                      void* stream, float* part_ms) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = tf ? c_out : c_in;
  PartTimer timer(s, part_ms);
  int err;

  if (tf) {
    err = launch_tf_operand(p, x, w, v, nullptr, n, heads, c_in, c_out, ldk,
                            bf16, s);
  } else {
    scaled_operand_kernel<<<elementwise_blocks((long long)n * ldk), 256, 0,
                            s>>>(p, x, v, n, heads, cv, ldk, bf16);
    err = (int)cudaGetLastError();
  }
  if (err) return timer.finish(err);
  timer.mark();

  err = launch_row_walk<kIndexed, false>(r, p, v, nullptr, nullptr, m, out,
                                         nullptr, zr, map, n, heads, cv, ldk,
                                         tf, bf16, s);
  if (err) return timer.finish(err);
  timer.mark();

  if (!tf) {  // out = zr cd(W_flat)
    ProductArgs q{};
    q.a = zr; q.b = w; q.c = out;
    q.m = n; q.n = c_out; q.k = heads * c_in;
    q.lda = ldk; q.ldb = c_out; q.ldc = c_out;
    q.cast_a = 0; q.cast_b = 1; q.bf16 = bf16;
    err = launch_node_product<false, false, false, false>(q, 1, s);
    if (err) return timer.finish(err);
    timer.mark();
  }
  return timer.finish(0);
}

}  // namespace
