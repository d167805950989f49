// Shared by the banded and the block-sparse FeaStConv aggregates (forward
// and backward): the compute-dtype cast, where a row block's window lies
// among the node rows, and the per-node window operand.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeads = 16;
constexpr int kMaxOut = 128;  // 4 column groups of 32

// cd(): round to bf16 when the compute dtype is bf16 (identity for f32) —
// the casts of the Pallas bodies.  A product of two bf16 values is exact in
// f32, so f32 FMAs over cd() operands reproduce bf16-operand / f32-accumulate
// products up to summation order.
__device__ __forceinline__ float cd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Where the window of a row block of T rows lies among the node rows.
//   band (kIndexed = false): the k = 3 neighbouring blocks, window slot w of
//     block b is node (b-1)T + w; nodes outside [0, N) are absent;
//   block-sparse (kIndexed = true): the k column blocks listed in
//     blk_idx[b, :] (int64), slot w is node blk_idx[b, w/T] T + w%T, always
//     in range.  A padded list entry repeats the row block's own index under
//     an all-zero mask, so one column block may stand twice in a list.
// The backward's column pass goes the other way: for column block c, the
// (row block, list position) pairs whose windows hold it.  The band has the
// three neighbours; block-sparse reads them from a CSR transpose of blk_idx
// (colptr (B+1), pairs holding b*k + position, both int64).
template <bool kIndexed>
struct WindowMap {
  const long long* blk_idx;
  const long long* colptr;
  const long long* pairs;
  int tile;
  int k;
  int n_blk;

  __device__ __forceinline__ int width() const { return k * tile; }

  // node of window slot w of row block b; w + 31 must not cross a column
  // block for the caller to step linearly from it (tile % 32 == 0)
  __device__ __forceinline__ long long node(int b, int w) const {
    if (kIndexed) {
      const int pos = w / tile;
      return blk_idx[(long long)b * k + pos] * tile + (w - pos * tile);
    }
    return (long long)(b - 1) * tile + w;
  }

  __device__ __forceinline__ long long visits_begin(int c) const {
    return kIndexed ? colptr[c] : c - 1;
  }
  __device__ __forceinline__ long long visits_end(int c) const {
    return kIndexed ? colptr[c + 1] : c + 2;
  }
  // visit q of column block c: the row block b (false when the band's
  // neighbour does not exist) and the list position of c in b's window
  __device__ __forceinline__ bool visit(long long q, int c, int& b,
                                        int& pos) const {
    if (kIndexed) {
      const long long pr = pairs[q];
      b = (int)(pr / k);
      pos = (int)(pr - (long long)b * k);
      return true;
    }
    b = (int)q;
    pos = c - b + 1;
    return b >= 0 && b < n_blk;
  }
};

// V (N, H*cv) row-major, the window operand, built once per node:
//   aggregate-first (cv = C_in):  V[j, h*C_in + c]  = cd(p[j,h] x[j,c])
//   transform-first (cv = C_out): Y[j, h*C_out + o] = sum_c cd(w[h,c,o]) cd(x[j,c])
//                                 V[j, h*C_out + o] = cd(p[j,h] Y[j, h*C_out + o])
// y (nullable) receives Y, which the transform-first backward needs.
__global__ void window_operand_kernel(const float* __restrict__ p,
                                      const float* __restrict__ x,
                                      const float* __restrict__ w,
                                      float* __restrict__ v,
                                      float* __restrict__ y, int n, int heads,
                                      int c_in, int c_out, int tf, int bf16) {
  const int cv = tf ? c_out : c_in;
  const int kk = heads * cv;
  const long long total = (long long)n * kk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long node = e / kk;
    const int col = (int)(e - node * kk);
    const int h = col / cv;
    const int k = col - h * cv;
    const float ph = p[node * heads + h];
    float val;
    if (tf) {
      const float* xr = x + node * c_in;
      const float* wc = w + (long long)h * c_in * c_out + k;
      float acc = 0.f;
      for (int c = 0; c < c_in; ++c) {
        acc = fmaf(cd(wc[(long long)c * c_out], bf16), cd(xr[c], bf16), acc);
      }
      if (y != nullptr) y[e] = acc;
      val = ph * acc;
    } else {
      val = ph * x[node * c_in + k];
    }
    v[e] = cd(val, bf16);
  }
}

// grid of a grid-stride elementwise launch over `total` items
inline unsigned elementwise_blocks(long long total) {
  long long blocks = (total + 255) / 256;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace
