// The per-node products of the FeaStConv aggregates, for Hopper (sm_90a):
// one tiled kernel for every (nodes x K) x (K x C) product of the TPU
// kernels' bodies (geobignn_tpu/ops/banded_pallas.py):
//   transform-first  Y = cd(x) cd(W2)            (:125)  -> V = cd(p Y)
//                    x̄ = yb cd(W2)^T             (:208)
//                    W̄2 = sum_j yb[j,:]^T cd(x)[j,:]   (:212)
//   aggregate-first  out = zr cd(W_flat)         (:236)
//                    gy = cd(gout) cd(W_flat)^T  (:263) -> G = cd(gy r)
//                    W̄ = sum_i zr[i,:]^T cd(gout)[i,:] (:268)
// with W2[c, h*C_out + o] = w[h, c, o] read in place from w (H, C_in, C_out).
//
// What bounds them on the H100: operations.  Each is 0.1-0.8 GFLOP of f32
// FMAs (12 us at the 67 TFLOP/s peak for the largest) over a few MB.  The
// operands are f32 sums that must not be rounded again (yb, zr) or cd()
// values whose products are exact in f32, so the CUDA cores do them:
//   - a CTA of 256 threads owns a 64 x 64 output tile and walks the
//     contraction in steps of 16; both operand tiles are staged in shared
//     memory by loads that run along each operand's contiguous axis
//     (whichever of the two it is: an operand may be read transposed), cast
//     once on the way in; where a thread's elements lie is worked out once,
//     a step only moves the pointers on (no division in the loop);
//   - each thread keeps a 4 x 4 register tile and reads its operands from
//     shared memory as two float4 per step; the next step's tiles are
//     fetched into registers while the current one is multiplied;
//   - the W̄ products contract over the nodes: blockIdx.z takes one row block
//     and writes its partial, which the wrapper sums in a fixed order (no
//     atomics), as XLA sums the TPU kernel's W̄ slabs;
//   - the epilogue of the operand products scales by the head's factor and
//     casts (V, G), and can keep the raw product (Y, gy) beside it.

#pragma once

#include "banded_common.cuh"

namespace {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kProductThreads = 256;
constexpr int kPerThread = kTileM * kTileK / kProductThreads;  // 4

// C (m, n) = A (m, k) B (k, n); blockIdx.z offsets a, b, c by za, zb, zc.
struct ProductArgs {
  const float* a;
  const float* b;
  float* c;
  float* raw;          // scaled epilogue: the unscaled product (nullable)
  const float* scale;  // scaled epilogue: (m, heads)
  int m, n, k;
  int lda, ldb, ldc;
  int cast_a, cast_b;  // round the operand to the compute dtype on load
  int bf16;
  int heads, cv;       // scaled epilogue: the head of column j is j / cv
  int c_in, c_out;     // kW2: the shape of w (heads, c_in, c_out)
  long long za, zb, zc;
};

// kTransA: A[i, kk] = a[kk * lda + i] instead of a[i * lda + kk].
// kTransB: B[kk, j] = b[j * ldb + kk] instead of b[kk * ldb + j].
// kW2: b is w (H, C_in, C_out) and the (C_in, H*C_out) matrix W2 stands for
//   the row-major one.
// kScaled: c[i, j] = cd(scale[i, j / cv] * acc) over all ldc columns (zeros
//   in the padding columns j >= n), raw[i, j] = acc; else c[i, j] = acc.
template <bool kTransA, bool kTransB, bool kW2, bool kScaled>
__global__ void __launch_bounds__(kProductThreads)
node_product_kernel(ProductArgs q) {
  __shared__ __align__(16) float a_s[kTileK][kTileM + 4];
  __shared__ __align__(16) float b_s[kTileK][kTileN + 4];

  const int tid = threadIdx.x;
  const int i0 = blockIdx.y * kTileM;
  const int j0 = blockIdx.x * kTileN;
  const float* a = q.a + blockIdx.z * q.za;
  const float* b = q.b + blockIdx.z * q.zb;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;  // columns tx*4 .. tx*4+3

  // this thread's elements of the operand tiles: the index that runs along
  // the operand's contiguous axis is the fastest over the threads.  Where
  // an element lies is worked out once; a step of the contraction only
  // moves the pointers on.
  int ai[kPerThread], ak[kPerThread], bj[kPerThread], bk[kPerThread];
  const float* pa[kPerThread];
  const float* pb[kPerThread];
  bool a_in[kPerThread], b_in[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int f = tid + e * kProductThreads;
    if (kTransA) { ak[e] = f / kTileM; ai[e] = f % kTileM; }
    else         { ai[e] = f / kTileK; ak[e] = f % kTileK; }
    if (kTransB) { bj[e] = f / kTileK; bk[e] = f % kTileK; }
    else         { bk[e] = f / kTileN; bj[e] = f % kTileN; }
    const int i = i0 + ai[e];
    const int j = j0 + bj[e];
    a_in[e] = i < q.m;
    b_in[e] = j < q.n;
    pa[e] = kTransA ? a + (long long)ak[e] * q.lda + i
                    : a + (long long)i * q.lda + ak[e];
    if (kW2 && !kTransB) {  // column j = h * C_out + o is fixed, c = kb moves
      const int h = j / q.c_out;
      pb[e] = b + (long long)h * q.c_in * q.c_out + (j - h * q.c_out) +
              (long long)bk[e] * q.c_out;
    } else if (kW2) {  // c = j is fixed, the column kb moves: see fetch
      pb[e] = b + (long long)j * q.c_out;
    } else {
      pb[e] = kTransB ? b + (long long)j * q.ldb + bk[e]
                      : b + (long long)bk[e] * q.ldb + j;
    }
  }
  const long long a_step = kTransA ? (long long)kTileK * q.lda : kTileK;
  const long long b_step =
      kW2 ? (kTransB ? 0 : (long long)kTileK * q.c_out)
          : (kTransB ? kTileK : (long long)kTileK * q.ldb);

  const unsigned long long c_out_inv =  // ceil(2^32 / C_out)
      kW2 ? ((1ull << 32) + q.c_out - 1) / (unsigned long long)q.c_out : 0ull;
  const int head_stride = q.c_in * q.c_out;

  float ra[kPerThread], rb[kPerThread];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      float va = 0.f;
      if (a_in[e] && k0 + ak[e] < q.k) {
        va = *pa[e];
        if (q.cast_a) va = cd(va, q.bf16);
      }
      pa[e] += a_step;
      ra[e] = va;
      const int kb = k0 + bk[e];
      float vb = 0.f;
      if (b_in[e] && kb < q.k) {
        if (kW2 && kTransB) {  // column kb = h * C_out + o of W2's row c;
          // h = kb / C_out by the reciprocal (exact below 2^16)
          const int h = (int)(((unsigned long long)kb * c_out_inv) >> 32);
          vb = pb[e][h * head_stride + (kb - h * q.c_out)];
        } else {
          vb = *pb[e];
        }
        if (q.cast_b) vb = cd(vb, q.bf16);
      }
      pb[e] += b_step;
      rb[e] = vb;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) {
      a_s[ak[e]][ai[e]] = ra[e];
      b_s[bk[e]][bj[e]] = rb[e];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  for (int k0 = 0; k0 < q.k; k0 += kTileK) {
    const bool more = k0 + kTileK < q.k;
    if (more) fetch(k0 + kTileK);
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
      const float au[4] = {av.x, av.y, av.z, av.w};
      const float bu[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(au[u], bu[v], acc[u][v]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  float* c = q.c + blockIdx.z * q.zc;
  int head_of[4];  // scaled epilogue: the head of each of this thread's columns
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int j = j0 + tx * 4 + v;
    head_of[v] = (kScaled && j < q.n) ? j / q.cv : 0;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty * 4 + u;
    if (i >= q.m) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx * 4 + v;
      if (kScaled) {
        if (j >= q.ldc) continue;
        float val = 0.f, scaled = 0.f;
        if (j < q.n) {
          val = acc[u][v];
          scaled = cd(q.scale[(long long)i * q.heads + head_of[v]] * val, q.bf16);
        }
        if (q.raw != nullptr) q.raw[(long long)i * q.ldc + j] = val;
        c[(long long)i * q.ldc + j] = scaled;
      } else if (j < q.n) {
        c[(long long)i * q.ldc + j] = acc[u][v];
      }
    }
  }
}

// Launches one product over `batches` blockIdx.z slices; returns the
// cudaGetLastError() code.
template <bool kTransA, bool kTransB, bool kW2, bool kScaled>
int launch_node_product(const ProductArgs& q, int batches, cudaStream_t s) {
  const int cols = kScaled ? q.ldc : q.n;
  const dim3 grid((cols + kTileN - 1) / kTileN, (q.m + kTileM - 1) / kTileM,
                  batches);
  node_product_kernel<kTransA, kTransB, kW2, kScaled>
      <<<grid, kProductThreads, 0, s>>>(q);
  return (int)cudaGetLastError();
}

// Y = cd(x) cd(W2), V = cd(p Y): v (n, ldk), y (n, ldk) nullable.
inline int launch_tf_operand(const float* p, const float* x, const float* w,
                             float* v, float* y, int n, int heads, int c_in,
                             int c_out, int ldk, int bf16, cudaStream_t s) {
  ProductArgs q{};
  q.a = x; q.b = w; q.c = v; q.raw = y; q.scale = p;
  q.m = n; q.n = heads * c_out; q.k = c_in;
  q.lda = c_in; q.ldc = ldk;
  q.cast_a = 1; q.cast_b = 1; q.bf16 = bf16;
  q.heads = heads; q.cv = c_out; q.c_in = c_in; q.c_out = c_out;
  return launch_node_product<false, false, true, true>(q, 1, s);
}

// W̄ partials: part[s] (kl, cr) = sum over the rows i of row block s of
// lhs[i, :kl]^T cd(rhs[i, :cr]); lhs (n, ldl), rhs (n, cr).
inline int launch_wbar_partials(const float* lhs, const float* rhs,
                                float* part, int n_blk, int rows, int kl,
                                int ldl, int cr, int bf16, cudaStream_t s) {
  ProductArgs q{};
  q.a = lhs; q.b = rhs; q.c = part;
  q.m = kl; q.n = cr; q.k = rows;
  q.lda = ldl; q.ldb = cr; q.ldc = cr;
  q.cast_a = 0; q.cast_b = 1; q.bf16 = bf16;
  q.za = (long long)rows * ldl; q.zb = (long long)rows * cr;
  q.zc = (long long)kl * cr;
  return launch_node_product<true, false, false, false>(q, n_blk, s);
}

}  // namespace
