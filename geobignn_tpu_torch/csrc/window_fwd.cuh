// FeaStConv window aggregate, forward, for Hopper (sm_90a): the kernel that
// banded_fwd.cu instantiates over the contiguous band and
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
// of two bf16 values is exact in f32, so f32 FMAs reproduce the TPU's
// bf16-operand / f32-accumulate products up to summation order.
//
// What bounds it on the H100: as written, the CUDA cores.  The work counted
// densely over the window (2 N kT (H(C+1) + ...) flops, the TPU wrapper's
// own count) runs as f32 FMAs, while the bytes it must move (the int8 mask
// plus the (N, C) operands) take a few microseconds at 3.35 TB/s.  Design:
//   - the TPU kernel keeps one block's whole (T, kT) f32 D and mask in VMEM
//     (786 KB at T=256, k=3); a Hopper block cannot, so each CTA owns a strip
//     of kRows rows of one row block and streams the window in kWin-slot
//     chunks staged in shared memory (p, V, mask), recomputing D and A per
//     chunk (H = 9 makes that cheap);
//   - the H*C accumulator is split into passes of kCols columns; each pass
//     re-streams the window, then folds its columns into the per-thread
//     output registers (the r scaling and the W contraction / head sum are
//     this epilogue), so the kernel writes each output once;
//   - V (p times x, or p times W2 x) is built once per node by a first
//     launch instead of once per window that holds the node;
//   - the block-sparse instantiation skips a chunk whose 32 x 32 mask tile
//     has no set slot (about 12 of a row's k T slots are set, and k is 8-14
//     where the band has 3); the band instantiation walks every chunk.
// Later work: mma/wgmma tiles, and the chunk skip for the band as well.

#pragma once

#include "banded_common.cuh"

namespace {

constexpr int kRows = 32;     // rows of one row block per CTA
constexpr int kWin = 32;      // window slots per staged chunk
constexpr int kCols = 128;    // accumulator columns (of H*C) per pass
constexpr int kThreads = 256;
constexpr int kMaskPerThread = kRows * kWin / kThreads;

template <bool kIndexed>
__global__ void __launch_bounds__(kThreads)
window_aggregate_kernel(const float* __restrict__ r,
                        const float* __restrict__ p,
                        const float* __restrict__ v,
                        const float* __restrict__ w,
                        const int8_t* __restrict__ m, float* __restrict__ out,
                        WindowMap<kIndexed> map, int n, int heads, int cv,
                        int c_out, int tf, int bf16) {
  __shared__ float r_s[kRows][kMaxHeads];
  __shared__ float p_s[kWin][kMaxHeads];
  __shared__ float a_s[kRows][kWin + 1];
  __shared__ float v_s[kWin][kCols];
  __shared__ float z_s[kRows][kCols + 1];

  const int tid = threadIdx.x;
  const int tile = map.tile;
  const int row0 = blockIdx.x * kRows;  // first global row of this strip
  const int blk = row0 / tile;           // its row block
  const int t0 = row0 - blk * tile;      // strip offset inside the block
  const int win = map.width();
  const int kk = heads * cv;
  const int rg = tid / 32;  // this thread's rows: rg*4 .. rg*4+3
  const int cg = tid % 32;  // this thread's columns: cg + 32*j, j < 4

  for (int e = tid; e < kRows * heads; e += kThreads) {
    const int t = e / heads;
    const int h = e - t * heads;
    r_s[t][h] = r[(long long)(row0 + t) * heads + h];
  }

  float o_acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o_acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kk; k0 += kCols) {
    float z[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[i][j] = 0.f;

    for (int w0 = 0; w0 < win; w0 += kWin) {
      // this thread's slots of the chunk's mask tile: (t, wl) = e / kWin,
      // e % kWin for e = tid + q * kThreads
      int8_t mk[kMaskPerThread];
      int any = 0;
#pragma unroll
      for (int q = 0; q < kMaskPerThread; ++q) {
        const int e = tid + q * kThreads;
        const int t = e / kWin;
        const int wl = e - t * kWin;
        mk[q] = m[((long long)blk * tile + t0 + t) * win + w0 + wl];
        any |= mk[q];
      }
      // the previous chunk's readers are done; a chunk of block-sparse
      // windows without a set slot adds nothing and is skipped by all
      if (kIndexed) {
        if (!__syncthreads_or(any)) continue;
      } else {
        __syncthreads();
      }
      const long long j0 = map.node(blk, w0);  // the chunk's first node
      for (int e = tid; e < kWin * heads; e += kThreads) {
        const int wl = e / heads;
        const int h = e - wl * heads;
        const long long j = j0 + wl;
        p_s[wl][h] = (j >= 0 && j < n) ? p[j * heads + h] : 0.f;
      }
      for (int e = tid; e < kWin * kCols; e += kThreads) {
        const int wl = e / kCols;
        const int c = e - wl * kCols;
        const long long j = j0 + wl;
        const int k = k0 + c;
        v_s[wl][c] = (j >= 0 && j < n && k < kk) ? v[j * kk + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kMaskPerThread; ++q) {
        const int e = tid + q * kThreads;
        const int t = e / kWin;
        const int wl = e - t * kWin;
        float a = 0.f;
        if (mk[q] != 0) {
          float d = 0.f;
          for (int h = 0; h < heads; ++h) d = fmaf(r_s[t][h], p_s[wl][h], d);
          a = cd((float)mk[q] / fmaxf(d, 1e-12f), bf16);
        }
        a_s[t][wl] = a;
      }
      __syncthreads();
#pragma unroll 8
      for (int wl = 0; wl < kWin; ++wl) {
        float av[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[rg * 4 + i][wl];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = v_s[wl][cg + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) z[i][j] = fmaf(av[i], vv[j], z[i][j]);
      }
    }

    // epilogue of this pass: zr = cd(Z r_h), then fold into the outputs
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 32 * j;
        const int k = k0 + c;
        z_s[t][c] = (k < kk) ? cd(z[i][j] * r_s[t][k / cv], bf16) : 0.f;
      }
    }
    __syncthreads();
    const int kc = min(kCols, kk - k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = cg + 32 * j;
        if (o >= c_out) continue;
        float acc = o_acc[i][j];
        if (tf) {  // head sum over the columns k = h*C_out + o of this pass
          int c = ((o - k0) % c_out + c_out) % c_out;
          for (; c < kc; c += c_out) acc += z_s[t][c];
        } else {
          for (int c = 0; c < kc; ++c) {
            acc = fmaf(cd(w[(long long)(k0 + c) * c_out + o], bf16),
                       z_s[t][c], acc);
          }
        }
        o_acc[i][j] = acc;
      }
    }
    // z_s is next written after the next pass's window loop, whose
    // barriers (one per chunk, skipped or not) order those writes after
    // these reads
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = rg * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = cg + 32 * j;
      if (o < c_out) out[(long long)(row0 + t) * c_out + o] = o_acc[i][j];
    }
  }
}

// Builds V, then runs the window kernel over n / kRows strips.  Returns the
// cudaGetLastError() code after the launches (0 on success).
template <bool kIndexed>
int launch_window_fwd(const float* r, const float* p, const float* x,
                      const float* w, const int8_t* m, float* v, float* out,
                      WindowMap<kIndexed> map, int n, int heads, int c_in,
                      int c_out, int tf, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = tf ? c_out : c_in;
  window_operand_kernel<<<elementwise_blocks((long long)n * heads * cv), 256, 0,
                          s>>>(p, x, w, v, nullptr, n, heads, c_in, c_out, tf,
                               bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  window_aggregate_kernel<kIndexed><<<n / kRows, kThreads, 0, s>>>(
      r, p, v, w, m, out, map, n, heads, cv, c_out, tf, bf16);
  return (int)cudaGetLastError();
}

}  // namespace
