// Shared by the banded and the block-sparse FeaStConv aggregates (forward
// and backward): the compute-dtype cast, where a row block's window lies
// among the node rows, the elementwise per-node operand, and the event
// timer of a launch sequence's parts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeads = 16;
constexpr int kMaxParts = 8;   // launches of one entry point
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a kernel may ask for without opting in: the default
// 48 KB a block may use, less room for the kernels' static arrays
constexpr int kDefaultSmem = 40 * 1024;

// cd(): round to bf16 when the compute dtype is bf16 (identity for f32) —
// the casts of the Pallas bodies.  A product of two bf16 values is exact in
// f32, so f32 FMAs over cd() operands reproduce bf16-operand / f32-accumulate
// products up to summation order.
__device__ __forceinline__ float cd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ void load_heads(float (&dst)[kMaxHeads],
                                           const float* src, int heads) {
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) dst[h] = h < heads ? src[h] : 0.f;
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

  // node of window slot w of row block b
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

// dst (n, ld) with dst[i, h*cv + c] = cd(scale[i, h] src[i, c]) and zeros in
// the padding columns [heads*cv, ld): the aggregate-first window operand
// V = cd(p x) and the transform-first row operand G = cd(r gout).
__global__ void scaled_operand_kernel(const float* __restrict__ scale,
                                      const float* __restrict__ src,
                                      float* __restrict__ dst, int n,
                                      int heads, int cv, int ld, int bf16) {
  const int kk = heads * cv;
  const long long total = (long long)n * ld;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / ld;
    const int k = (int)(e - i * ld);
    float val = 0.f;
    if (k < kk) {
      const int h = k / cv;
      val = cd(scale[i * heads + h] * src[i * cv + (k - h * cv)], bf16);
    }
    dst[e] = val;
  }
}

// grid of a grid-stride elementwise launch over `total` items
inline unsigned elementwise_blocks(long long total) {
  long long blocks = (total + 255) / 256;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  return (unsigned)(blocks > 0 ? blocks : 1);
}

// Opts a kernel in to more than the default dynamic shared memory.  The
// attribute holds for the process, so each kernel is opted in once per size
// above the last: a launch captured into a CUDA graph then makes no such
// call, the eager warm-up before the capture having made it.
inline int set_smem(const void* kernel, int bytes) {
  if (bytes <= kDefaultSmem) return 0;
  constexpr int kSlots = 64;
  static const void* seen[kSlots];
  static int seen_bytes[kSlots];
  static int n_seen = 0;
  int i = 0;
  while (i < n_seen && seen[i] != kernel) ++i;
  if (i < n_seen && seen_bytes[i] >= bytes) return 0;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == 0 && i < kSlots) {
    seen[i] = kernel;
    seen_bytes[i] = bytes;
    if (i == n_seen) ++n_seen;
  }
  return err;
}

// The parts of one entry point's launch sequence, timed with CUDA events
// when the caller hands in `ms` (kMaxParts floats, one per launch in
// order); with ms == nullptr it does nothing and nothing synchronises.
struct PartTimer {
  cudaStream_t stream;
  float* ms;
  int n = 0;
  cudaEvent_t ev[kMaxParts + 1];

  PartTimer(cudaStream_t s, float* out) : stream(s), ms(out) { mark(); }

  void mark() {
    if (ms == nullptr || n > kMaxParts) return;
    cudaEventCreate(&ev[n]);
    cudaEventRecord(ev[n], stream);
    ++n;
  }

  // the launch error, or the first error of reading the events
  int finish(int err) {
    if (ms == nullptr) return err;
    if (n > 0 && err == 0) err = (int)cudaEventSynchronize(ev[n - 1]);
    for (int i = 0; i + 1 < n && err == 0; ++i) {
      err = (int)cudaEventElapsedTime(&ms[i], ev[i], ev[i + 1]);
    }
    for (int i = 0; i < n; ++i) cudaEventDestroy(ev[i]);
    return err;
  }
};

}  // namespace
