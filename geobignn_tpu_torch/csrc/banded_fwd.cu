// Banded FeaStConv aggregate, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of geobignn_tpu/ops/banded_pallas.py:
//   #1 `_fwd_kernel` (aggregate-first, C_out >= C_in), called via _call_fwd;
//   #2 `_fwd_kernel_tf` / `_fwd_body_tf` (transform-first, C_out < C_in).
//
// Function, for each band block b of T rows and its window of 3T columns
// (global column j = (b-1)T + w; rows outside [0, N) read as zero):
//   D[t,w]  = sum_h r[t,h] p[w,h]                         (f32)
//   A[t,w]  = cd(M[t,w] / max(D[t,w], 1e-12))
//   V[w,k]  = cd(p[w,h] x[w,c])             k = h*C_in + c   (#1)
//           = cd(p[w,h] sum_c cd(w[h,c,o]) cd(x[w,c]))   k = h*C_out + o (#2)
//   Z[t,k]  = sum_w A[t,w] V[w,k]                          (f32 accumulate)
//   zr[t,k] = cd(Z[t,k] r[t,h(k)])
//   out[t,o] = sum_k cd(w[k,o]) zr[t,k]       (#1, w flattened (H*C_in, C_out))
//            = sum_h zr[t, h*C_out + o]       (#2, the head sum)
// where cd() rounds to bf16 when the compute dtype is bf16 (identity for
// f32): the casts sit where the Pallas bodies put them, and every product
// of two bf16 values is exact in f32, so f32 FMAs reproduce the TPU's
// bf16-operand / f32-accumulate products up to summation order.
//
// What bounds it on the H100: as written, the CUDA cores.  The work counted
// densely over the window (2 N 3T (H(C+1) + ...) flops, the TPU wrapper's
// own count) runs as f32 FMAs, while the bytes it must move (the int8 mask
// plus the (N, C) operands) take a few microseconds at 3.35 TB/s.  Design:
//   - the TPU kernel keeps one block's whole (T, 3T) f32 D and mask in VMEM
//     (786 KB at T=256); a Hopper block cannot, so each CTA owns a strip of
//     kRows rows of one band block and streams the window in kWin-column
//     chunks staged in shared memory (p, V, mask), recomputing D and A per
//     chunk (H = 9 makes that cheap);
//   - the H*C accumulator is split into passes of kCols columns; each pass
//     re-streams the window, then folds its columns into the per-thread
//     output registers (the r scaling and the W contraction / head sum are
//     this epilogue), so the kernel writes each output once;
//   - V (p times x, or p times W2 x) is built once per node by a first
//     launch instead of once per window that holds the node (3 times).
// Later work: mma/wgmma tiles and skipping all-zero mask chunks (about 12 of
// 768 window slots are set per facet row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;     // rows of one band block per CTA
constexpr int kWin = 32;      // window columns per staged chunk
constexpr int kCols = 128;    // accumulator columns (of H*C) per pass
constexpr int kThreads = 256;
constexpr int kMaxHeads = 16;
constexpr int kMaxOut = 128;  // 4 column groups of 32

__device__ __forceinline__ float cd(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// V (N, H*cv) row-major: the window operand, built once per node.
__global__ void window_operand_kernel(const float* __restrict__ p,
                                      const float* __restrict__ x,
                                      const float* __restrict__ w,
                                      float* __restrict__ v, int n, int heads,
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
      val = ph * acc;
    } else {
      val = ph * x[node * c_in + k];
    }
    v[e] = cd(val, bf16);
  }
}

__global__ void __launch_bounds__(kThreads)
banded_window_kernel(const float* __restrict__ r, const float* __restrict__ p,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const int8_t* __restrict__ m, float* __restrict__ out,
                     int n, int tile, int heads, int cv, int c_out, int tf,
                     int bf16) {
  __shared__ float r_s[kRows][kMaxHeads];
  __shared__ float p_s[kWin][kMaxHeads];
  __shared__ float a_s[kRows][kWin + 1];
  __shared__ float v_s[kWin][kCols];
  __shared__ float z_s[kRows][kCols + 1];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;  // first global row of this strip
  const int blk = row0 / tile;           // its band block
  const int t0 = row0 - blk * tile;      // strip offset inside the block
  const int win = 3 * tile;
  const long long col_base = (long long)(blk - 1) * tile;
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
      __syncthreads();  // the previous chunk's readers are done
      for (int e = tid; e < kWin * heads; e += kThreads) {
        const int wl = e / heads;
        const int h = e - wl * heads;
        const long long j = col_base + w0 + wl;
        p_s[wl][h] = (j >= 0 && j < n) ? p[j * heads + h] : 0.f;
      }
      for (int e = tid; e < kWin * kCols; e += kThreads) {
        const int wl = e / kCols;
        const int c = e - wl * kCols;
        const long long j = col_base + w0 + wl;
        const int k = k0 + c;
        v_s[wl][c] = (j >= 0 && j < n && k < kk) ? v[j * kk + k] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < kRows * kWin; e += kThreads) {
        const int t = e / kWin;
        const int wl = e - t * kWin;
        const int8_t mk =
            m[((long long)blk * tile + t0 + t) * win + w0 + wl];
        float a = 0.f;
        if (mk != 0) {
          float d = 0.f;
          for (int h = 0; h < heads; ++h) d = fmaf(r_s[t][h], p_s[wl][h], d);
          a = cd((float)mk / fmaxf(d, 1e-12f), bf16);
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
    // __syncthreads order those writes after these reads
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

}  // namespace

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = tf ? c_out : c_in;
  const long long total = (long long)n * heads * cv;
  long long blocks = (total + 255) / 256;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  window_operand_kernel<<<(unsigned)blocks, 256, 0, s>>>(p, x, w, v, n, heads,
                                                         c_in, c_out, tf, bf16);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  banded_window_kernel<<<n / kRows, kThreads, 0, s>>>(r, p, v, w, m, out, n,
                                                      tile, heads, cv, c_out,
                                                      tf, bf16);
  return (int)cudaGetLastError();
}

}  // extern "C"
