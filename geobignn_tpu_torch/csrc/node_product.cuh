// The per-node products of the FeaStConv aggregates, for Hopper (sm_90a):
// two tiled kernels for the (nodes x K) x (K x C) products of the TPU
// kernels' bodies (geobignn_tpu/ops/banded_pallas.py):
//   transform-first  Y = cd(x) cd(W2)            (:125)  -> V = cd(p Y)
//                    x̄ = yb cd(W2)^T             (:208)
//                    W̄2 = sum_j yb[j,:]^T cd(x)[j,:]   (:212)
//   aggregate-first  out = zr cd(W_flat)         (:236)
//                    gy = cd(gout) cd(W_flat)^T  (:263) -> G = cd(gy r)
//                    W̄ = sum_i zr[i,:]^T cd(gout)[i,:] (:268)
// with W2[c, h*C_out + o] = w[h, c, o] read in place from w (H, C_in, C_out).
//
// Two routes, chosen by what the launch can see (mma_route):
//
// The tensor cores (node_product_kernel_mma): Y / V and gy / G, whose two
// operands are both cd() values.  Under the bf16 compute dtype each is a
// bf16 number, and the product of two bf16 numbers is exact in f32, so a
// bf16 mma with f32 accumulators forms the very terms the f32 FMAs form;
// only the order of the sum changes.  On tensor cores these products are
// bound by their bytes on the H100: about 52 operations a byte at
// 128 -> 64 against a ridge of 295, and the bytes are the f32 stores of V
// (and of raw Y or gy) more than the reads of A.  So the design serves the
// stores:
//   - a CTA owns a slab of 128 columns and walks row tiles of 64 rows, a
//     persistent grid of as many CTAs as the SMs hold at once (two an SM;
//     fewer where m has fewer tiles: no second wave runs alone at the end);
//     the slab's B (W2, or W_flat^T) is cast to bf16 once and kept in shared
//     memory for every tile the CTA takes, stored column by column (B^T), so
//     that ldmatrix hands out the mma's B fragments;
//   - the CTAs of one row walker index take the same tiles at about the same
//     time in every slab, so A is read from device memory about once and
//     from L2 by the other slabs;
//   - the next tile's A rows and scale rows are loaded into registers while
//     this tile's mma.sync m16n8k16 steps and its epilogue run, and A is
//     cast to bf16 on its way into shared memory (cd() rounds to nearest
//     even, as __floats2bfloat162_rn does).  K is a template parameter, so
//     every index of a tile is a constant: at these sizes the instructions
//     around the stores cost as much as the reads;
//   - eight warps, 2 x 4 over the 64 x 128 tile, each 32 x 32 of f32
//     accumulators, staged through shared memory so that each row of a
//     warp's 32 columns leaves as 8 lanes x 16 bytes, a whole 128-byte
//     line: c = cd(scale[i, j / cv] acc) (zeros past n) and the raw acc, as
//     streaming stores (V, Y and gy are written once, read once later, and
//     far larger than L2 at whole-mesh sizes).
//
// The CUDA cores (node_product_kernel): everything else — any product under
// the f32 compute dtype, whose operands are not bf16 numbers, and x̄, W̄ and
// out, whose one operand is an f32 sum (yb, zr) that must not be rounded
// again: a bf16 mma would need an exact three-way split of it, a precision
// argument of its own.  Bound by operations: each is 0.1-0.8 GFLOP of f32
// FMAs (12 us at the 67 TFLOP/s peak for the largest) over a few MB.
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

constexpr int kMmaRows = 64;      // rows of a row tile
constexpr int kMmaCols = 128;     // columns of a CTA's slab
constexpr int kMmaMaxK = 128;     // the deepest contraction an A tile holds
constexpr int kMmaThreads = 256;  // 8 warps, 2 x 4 over the tile
constexpr int kMmaPad = 8;        // bf16 after each staged row: the 8 row
                                  // addresses of an ldmatrix hit 8 bank groups
constexpr int kMmaScales = kMmaRows * kMaxHeads / kMmaThreads;
constexpr int kOutStride = 40;    // floats of a row of a warp's staged output:
                                  // its float2 writes hit 32 distinct banks

// c (m, ldc) = cd(scale[i, j / cv] (A B)[i, j]) over all ldc columns (zeros
// in the padding columns j >= n), raw[i, j] = (A B)[i, j], with A (m, k)
// rows contiguous and 16-byte aligned, both operands cast to bf16.
struct MmaArgs {
  const float* a;
  const float* w;      // B's weights, read in place (see the kernel)
  float* c;
  float* raw;          // nullable
  const float* scale;  // (m, heads)
  int m, n, k, ldc;
  int heads, cv;
  int c_in, c_out;     // kW2: the shape of w (heads, c_in, c_out)
};

__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: one bf16 m16n8k16 step with f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// dynamic shared memory of node_product_kernel_mma<kW2, k>: B^T and the A
// tile in bf16, (kMmaCols + kMmaRows) (k + kMmaPad), then the tile's scale
// rows, kMmaRows x kMaxHeads floats, and each warp's staged output, 32 x
// kOutStride floats
inline int mma_smem_bytes(int k) {
  return (kMmaCols + kMmaRows) * (k + kMmaPad) * (int)sizeof(__nv_bfloat16) +
         (kMmaRows * kMaxHeads + (kMmaThreads / 32) * 32 * kOutStride) * (int)sizeof(float);
}

// kW2: B[kk, j] = w[h, kk, o] with j = h * C_out + o (k = C_in): Y.
// else: B[kk, j] = w[j * k + kk], w flattened (H*C_in, C_out) (k = C_out): gy.
// kK = q.k, so that every index of the tiles is a constant.  blockIdx.x: the
// slab of columns; blockIdx.y: the row walker, which takes the row tiles
// blockIdx.y, blockIdx.y + gridDim.y, ...
template <bool kW2, int kK>
__global__ void __launch_bounds__(kMmaThreads, 2)
node_product_kernel_mma(MmaArgs q) {
  constexpr int kS = kK + kMmaPad;  // bf16 stride of a staged row
  constexpr int kQ = kK / 4;        // float4 of an A row
  constexpr int kLoads = kMmaRows * kQ / kMmaThreads;  // float4 a thread stages
  static_assert(kK % 16 == 0 && kK <= kMmaMaxK, "whole m16n8k16 steps");
  extern __shared__ float4 mma_smem4[];
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(mma_smem4);  // [kMmaCols][kS]
  __nv_bfloat16* a_s = b_s + kMmaCols * kS;                         // [kMmaRows][kS]
  float* s_s = reinterpret_cast<float*>(a_s + kMmaRows * kS);       // [kMmaRows][heads]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* o_s = s_s + kMmaRows * kMaxHeads + warp * 32 * kOutStride;  // [32][kOutStride]

  const int wr = warp >> 2;  // rows wr*32 .. wr*32+31 of the tile
  const int wc = warp & 3;   // columns wc*32 .. wc*32+31 of the slab
  const int j0 = blockIdx.x * kMmaCols;
  const int tiles = (q.m + kMmaRows - 1) / kMmaRows;
  const int scales = kMmaRows * q.heads;  // floats of a tile's scale rows

  // the slab's B^T, cast once: b_s[jj][kk] = cd(B[kk, j0 + jj]), zero past n;
  // the threads run along w's contiguous axis (o for W2, kk for W_flat)
  if (kW2) {
    const int jj = tid % kMmaCols;
    const int j = j0 + jj;
    const int h = j < q.n ? j / q.c_out : 0;
    const float* col_w = q.w + (long long)h * q.c_in * q.c_out + (j - h * q.c_out);
#pragma unroll 8
    for (int kk = tid / kMmaCols; kk < kK; kk += kMmaThreads / kMmaCols) {
      b_s[jj * kS + kk] = __float2bfloat16_rn(j < q.n ? col_w[kk * q.c_out] : 0.f);
    }
  } else {
#pragma unroll 8
    for (int f = tid; f < kMmaCols * kK; f += kMmaThreads) {
      const int jj = f / kK, kk = f % kK;
      const int j = j0 + jj;
      b_s[jj * kS + kk] = __float2bfloat16_rn(j < q.n ? q.w[(long long)j * kK + kk] : 0.f);
    }
  }

  // the epilogue's place of this lane, the same for every tile: rows
  // u*4 + lane/8 (u < 8) of its warp's 32, columns jcol .. jcol+3, and
  // their heads, a byte each
  const int jcol = j0 + wc * 32 + (lane & 7) * 4;
  unsigned head_of = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = jcol + e;
    head_of |= (unsigned)(j < q.n ? j / q.cv : 0) << (8 * e);
  }
  // a warp whose 32 columns all lie past ldc has nothing to write
  const bool active = j0 + wc * 32 < q.ldc;
  // ldmatrix rows: A's (m, k) rows lane & 15 at k + (lane >> 4) * 8; B^T's
  // two 8-column steps, k halves in turn, so that r0, r1 are the first
  // step's b0, b1 and r2, r3 the second's
  const __nv_bfloat16* a_row = a_s + (wr * 32 + (lane & 15)) * kS + (lane >> 4) * 8;
  const __nv_bfloat16* b_row =
      b_s + (wc * 32 + (lane & 7) + ((lane >> 4) << 3)) * kS + ((lane >> 3) & 1) * 8;

  float4 pre[kLoads];  // the next tile's A rows and scale rows
  float spre[kMmaScales];
  auto prefetch = [&](int t) {
    const long long first = (long long)t * kMmaRows * kQ;
    const long long left = (long long)q.m * kQ - first;  // float4 of A from there
    const float4* src = reinterpret_cast<const float4*>(q.a) + first;
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int f = tid + e * kMmaThreads;
      pre[e] = f < left ? __ldg(src + f) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const long long sfirst = (long long)t * scales;
    const long long sleft = (long long)q.m * q.heads - sfirst;
#pragma unroll
    for (int e = 0; e < kMmaScales; ++e) {
      const int f = tid + e * kMmaThreads;
      spre[e] = (f < scales && f < sleft) ? __ldg(q.scale + sfirst + f) : 0.f;
    }
  };

  int t = blockIdx.y;
  if (t < tiles) prefetch(t);
  for (; t < tiles; t += gridDim.y) {
    __syncthreads();  // b_s is written; the last tile's a_s and s_s are read
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {  // A, cast on the way in
      const int f = tid + e * kMmaThreads;
      *reinterpret_cast<uint2*>(a_s + (f / kQ) * kS + (f % kQ) * 4) =
          make_uint2(bf16_pair(pre[e].x, pre[e].y), bf16_pair(pre[e].z, pre[e].w));
    }
#pragma unroll
    for (int e = 0; e < kMmaScales; ++e) {
      const int f = tid + e * kMmaThreads;
      if (f < scales) s_s[f] = spre[e];
    }
    __syncthreads();
    if (t + (int)gridDim.y < tiles) prefetch(t + gridDim.y);  // in flight meanwhile
    if (!active) continue;

    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
#pragma unroll
    for (int kb = 0; kb < kK; kb += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[mt], a_row + mt * 16 * kS + kb);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bf[4];
        ldmatrix_x4(bf, b_row + np * 16 * kS + kb);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }

    // the accumulator of an 8-column step holds (row g, columns 2c, 2c+1)
    // and (row g+8, the same columns), g = lane / 4, c = lane % 4: staged
    // in shared memory, each row of the warp's 32 x 32 goes out as 8 lanes
    // x 16 bytes, a whole 128-byte line, streamed past L2 (written once)
    const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* at = o_s + (mt * 16 + g) * kOutStride + nt * 8 + c2;
        *reinterpret_cast<float2*>(at) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(at + 8 * kOutStride) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
    __syncwarp();
    const long long row0 = (long long)t * kMmaRows + wr * 32 + (lane >> 3);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r_in = u * 4 + (lane >> 3);
      const long long i = row0 + u * 4;
      const float4 v = *reinterpret_cast<const float4*>(o_s + r_in * kOutStride + (lane & 7) * 4);
      if (i < q.m && jcol < q.ldc) {
        const float* srow = s_s + (wr * 32 + r_in) * q.heads;
        const float raw[4] = {v.x, v.y, v.z, v.w};
        float o[4], rw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = jcol + e < q.n;
          rw[e] = in ? raw[e] : 0.f;
          o[e] = in ? cd(srow[(head_of >> (8 * e)) & 0xff] * raw[e], 1) : 0.f;
        }
        const long long at = i * q.ldc + jcol;
        __stcs(reinterpret_cast<float4*>(q.c + at), make_float4(o[0], o[1], o[2], o[3]));
        if (q.raw != nullptr) {
          __stcs(reinterpret_cast<float4*>(q.raw + at), make_float4(rw[0], rw[1], rw[2], rw[3]));
        }
      }
    }
    __syncwarp();  // o_s is written again by the next tile
  }
}

// The route of a product whose two operands are cast: the tensor cores when
// they are bf16 numbers, the contraction is whole m16n8k16 steps that an A
// tile holds and A's rows start on 16-byte boundaries; else the CUDA cores.
// ops/banded_cuda.mma_route is the same rule, for the wrappers' counts.
inline bool mma_route(const float* a, int k, int bf16) {
  return bf16 != 0 && k >= 16 && k <= kMmaMaxK && k % 16 == 0 &&
         (reinterpret_cast<uintptr_t>(a) & 15) == 0;
}

inline int multiprocessors() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <bool kW2, int kK>
int launch_node_product_mma_k(const MmaArgs& q, cudaStream_t s) {
  const int smem = mma_smem_bytes(kK);
  auto kernel = node_product_kernel_mma<kW2, kK>;
  if (int err = set_smem((const void*)kernel, smem)) return err;
  int per_sm = 1;
  if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kMmaThreads, smem)) {
    return err;
  }
  // row walkers a slab: as many CTAs as the SMs hold at once (a second wave
  // would run alone at the end), never more walkers than tiles
  const int slabs = (q.ldc + kMmaCols - 1) / kMmaCols;
  const int tiles = (q.m + kMmaRows - 1) / kMmaRows;
  int walkers = (per_sm > 0 ? per_sm : 1) * multiprocessors() / slabs;
  walkers = walkers < tiles ? walkers : tiles;
  const dim3 grid(slabs, walkers > 0 ? walkers : 1);
  kernel<<<grid, kMmaThreads, smem, s>>>(q);
  return (int)cudaGetLastError();
}

template <bool kW2>
int launch_node_product_mma(const MmaArgs& q, cudaStream_t s) {
  switch (q.k) {
    case 16: return launch_node_product_mma_k<kW2, 16>(q, s);
    case 32: return launch_node_product_mma_k<kW2, 32>(q, s);
    case 48: return launch_node_product_mma_k<kW2, 48>(q, s);
    case 64: return launch_node_product_mma_k<kW2, 64>(q, s);
    case 80: return launch_node_product_mma_k<kW2, 80>(q, s);
    case 96: return launch_node_product_mma_k<kW2, 96>(q, s);
    case 112: return launch_node_product_mma_k<kW2, 112>(q, s);
    case 128: return launch_node_product_mma_k<kW2, 128>(q, s);
    default: return (int)cudaErrorInvalidValue;  // mma_route takes no other
  }
}

// Y = cd(x) cd(W2), V = cd(p Y): v (n, ldk), y (n, ldk) nullable.
inline int launch_tf_operand(const float* p, const float* x, const float* w,
                             float* v, float* y, int n, int heads, int c_in,
                             int c_out, int ldk, int bf16, cudaStream_t s) {
  if (mma_route(x, c_in, bf16)) {
    MmaArgs q{};
    q.a = x; q.w = w; q.c = v; q.raw = y; q.scale = p;
    q.m = n; q.n = heads * c_out; q.k = c_in; q.ldc = ldk;
    q.heads = heads; q.cv = c_out; q.c_in = c_in; q.c_out = c_out;
    return launch_node_product_mma<true>(q, s);
  }
  ProductArgs q{};
  q.a = x; q.b = w; q.c = v; q.raw = y; q.scale = p;
  q.m = n; q.n = heads * c_out; q.k = c_in;
  q.lda = c_in; q.ldc = ldk;
  q.cast_a = 1; q.cast_b = 1; q.bf16 = bf16;
  q.heads = heads; q.cv = c_out; q.c_in = c_in; q.c_out = c_out;
  return launch_node_product<false, false, true, true>(q, 1, s);
}

// gy = cd(gout) cd(W_flat)^T, G = cd(gy r): g and gy (n, ldk), with W_flat
// (H*C_in, C_out) the flattened w.
inline int launch_af_row_operand(const float* r, const float* gout,
                                 const float* w, float* g, float* gy, int n,
                                 int heads, int c_in, int c_out, int ldk,
                                 int bf16, cudaStream_t s) {
  if (mma_route(gout, c_out, bf16)) {
    MmaArgs q{};
    q.a = gout; q.w = w; q.c = g; q.raw = gy; q.scale = r;
    q.m = n; q.n = heads * c_in; q.k = c_out; q.ldc = ldk;
    q.heads = heads; q.cv = c_in; q.c_in = c_in; q.c_out = c_out;
    return launch_node_product_mma<false>(q, s);
  }
  ProductArgs q{};
  q.a = gout; q.b = w; q.c = g; q.raw = gy; q.scale = r;
  q.m = n; q.n = heads * c_in; q.k = c_out;
  q.lda = c_out; q.ldb = c_out; q.ldc = ldk;
  q.cast_a = 1; q.cast_b = 1; q.bf16 = bf16;
  q.heads = heads; q.cv = c_in;
  return launch_node_product<false, true, false, true>(q, 1, s);
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
