// Brute-force nearest-neighbour distance for Hopper (sm_90a).
//
// Replaces TPU kernel #7, geobignn_tpu/ops/pallas_nn.py `_nn_kernel` (called
// through `_nearest_sq_padded` / `nearest_distance_pallas`): for each row of
// a (n, k), the minimum over the rows of b (m, k) of
//     |a|^2 - 2 a.b + |b|^2,
// float32 throughout; then sqrt(max(., 0)) unless the squared distance is
// asked for.  The (n, m) distance matrix never exists.
//
// What bounds it: operations.  a, b and out are (n + m) k + n floats, read
// and written once, against n m (2k + 3) float32 operations that run on the
// CUDA cores (no rounding to bf16 or TF32 is allowed here: the expansion
// cancels for near points).  At n = m = 40,000, k = 3 that is 1 MB against
// 1.4e10 operations.
//
// Design.  One query per thread, a running minimum in a register, one launch
// per call; b streams through shared memory in tiles that every thread of
// the block reads at the same address (a broadcast, no bank conflict), with
// |b|^2 computed once per tile row by the thread that loads it.  Nothing of
// the TPU layout is kept: no padding of k to a lane width, no padded rows,
// no +inf mask; n, m and k are arguments and every access is bounds-checked.
//   * k <= 4 (meshes: k = 3): the query and |a|^2 sit in registers for the
//     whole kernel; a tile is 1024 rows of b as float4 (zero beyond k) plus
//     their |b|^2; per pair 4 FMAs for the dot and one for the combination.
//   * k > 4: k is walked in chunks of 16 coordinates.  A tile is 32 rows of
//     b; per chunk the block loads b's (32, 16) slab into shared memory,
//     each thread loads its query's 16 coordinates into registers and adds
//     to 32 partial dots in registers.  After the last chunk the 32
//     distances are combined with |a|^2 and the tile's |b|^2.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSmallK = 4;       // widest k of the register path
constexpr int kTileSmall = 1024;  // rows of b per tile, k <= 4
constexpr int kTileWide = 32;     // rows of b per tile, k > 4
constexpr int kChunk = 16;        // coordinates per chunk, k > 4

__device__ __forceinline__ float finish(float d2, int squared) {
  // a slightly negative d2 (cancellation) clamps to 0; fmaxf drops a NaN
  return squared ? d2 : sqrtf(fmaxf(d2, 0.0f));
}

__global__ void __launch_bounds__(kThreads)
nearest_small_k(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int n, int m, int k, int squared) {
  __shared__ float4 b_s[kTileSmall];
  __shared__ float b2_s[kTileSmall];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float q[kSmallK] = {0.0f, 0.0f, 0.0f, 0.0f};
  float a2 = 0.0f;
#pragma unroll
  for (int c = 0; c < kSmallK; ++c) {  // unrolled: q stays in registers
    if (i < n && c < k) q[c] = a[(long long)i * k + c];
    a2 = fmaf(q[c], q[c], a2);
  }
  float best = INFINITY;
  for (int j0 = 0; j0 < m; j0 += kTileSmall) {
    const int rows = min(kTileSmall, m - j0);
    __syncthreads();  // the previous tile has been read by every thread
    for (int j = threadIdx.x; j < rows; j += kThreads) {
      float v[kSmallK] = {0.0f, 0.0f, 0.0f, 0.0f};
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < kSmallK; ++c) {
        if (c < k) v[c] = b[(long long)(j0 + j) * k + c];
        s = fmaf(v[c], v[c], s);
      }
      b_s[j] = make_float4(v[0], v[1], v[2], v[3]);
      b2_s[j] = s;
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float4 t = b_s[j];
      float dot = q[0] * t.x;
      dot = fmaf(q[1], t.y, dot);
      dot = fmaf(q[2], t.z, dot);
      dot = fmaf(q[3], t.w, dot);
      best = fminf(best, fmaf(-2.0f, dot, a2 + b2_s[j]));
    }
  }
  if (i < n) out[i] = finish(best, squared);
}

__global__ void __launch_bounds__(kThreads)
nearest_wide_k(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int n, int m, int k, int squared) {
  __shared__ float b_s[kTileWide][kChunk];
  __shared__ float b2_s[kTileWide];
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kThreads + tid;
  const float* row = a + (long long)min(i, n - 1) * k;  // rows >= n compute, never write
  float a2 = 0.0f;
  for (int c = 0; c < k; ++c) a2 = fmaf(row[c], row[c], a2);

  float best = INFINITY;
  for (int j0 = 0; j0 < m; j0 += kTileWide) {
    float acc[kTileWide];
#pragma unroll
    for (int j = 0; j < kTileWide; ++j) acc[j] = 0.0f;
    float b2 = 0.0f;  // |b|^2 of tile row `tid`, kept by threads tid < kTileWide
    for (int c0 = 0; c0 < k; c0 += kChunk) {
      __syncthreads();  // the previous slab has been read by every thread
      for (int e = tid; e < kTileWide * kChunk; e += kThreads) {
        const int j = e / kChunk, c = e % kChunk;
        b_s[j][c] = (j0 + j < m && c0 + c < k)
                        ? b[(long long)(j0 + j) * k + c0 + c] : 0.0f;
      }
      __syncthreads();
      if (tid < kTileWide) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) b2 = fmaf(b_s[tid][c], b_s[tid][c], b2);
      }
      float q[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) q[c] = (c0 + c < k) ? row[c0 + c] : 0.0f;
#pragma unroll
      for (int j = 0; j < kTileWide; ++j) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) acc[j] = fmaf(q[c], b_s[j][c], acc[j]);
      }
    }
    // b2_s was last read before the syncs of this tile's chunk loop (k >= 1)
    if (tid < kTileWide) b2_s[tid] = b2;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTileWide; ++j) {
      if (j0 + j < m) best = fminf(best, fmaf(-2.0f, acc[j], a2 + b2_s[j]));
    }
  }
  if (i < n) out[i] = finish(best, squared);
}

}  // namespace

extern "C" {

// a (n, k), b (m, k), out (n,): f32, contiguous, on the current device;
// n, m, k >= 1.  out[i] = min_j |a_i - b_j|^2 when `squared`, else its
// clamped square root.  Returns the cudaGetLastError() code after the launch
// (0 on success).
int gbn_nearest_distance(const float* a, const float* b, float* out, int n,
                         int m, int k, int squared, void* stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= kSmallK) {
    nearest_small_k<<<grid, kThreads, 0, s>>>(a, b, out, n, m, k, squared);
  } else {
    nearest_wide_k<<<grid, kThreads, 0, s>>>(a, b, out, n, m, k, squared);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
