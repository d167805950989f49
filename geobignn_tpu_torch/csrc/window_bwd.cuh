// FeaStConv window aggregate, backward, for Hopper (sm_90a): the kernels
// that banded_bwd.cu instantiates over the contiguous band (TPU kernels #3
// and #4) and blocksparse_bwd.cu over block-sparse windows (TPU kernel #6);
// WindowMap (banded_common.cuh) says where a row block's window lies.
// "(#3)" below marks the aggregate-first schedule (C_out >= C_in), "(#4)"
// the transform-first one (C_out < C_in), in either instantiation.
//
// Function.  With the forward's D, A = cd(M / max(D, 1e-12)) and window
// operand V (banded_common.cuh), per row i and window column j (a set mask
// slot; K = H*cv, h(k) the head of column k):
//   mdd[i,j] = D > 1e-12 ? -(M/D)/D : 0                (the clamp subgradient)
//   G[i,k]   = cd(gy[i,k] r[i,h])  gy = cd(gout) cd(W_flat)^T     (#3)
//            = cd(gout[i,o] r[i,h])      k = h*C_out + o           (#4)
//   z[i,k]   = sum_j A[i,j] V[j,k]            (the forward's window product)
//   dbar     = mdd[i,j] * sum_k G[i,k] V[j,k]  (the denominator path)
//   r̄[i,h]  = sum_{k in h} cd(gz[i,k] z[i,k]) + sum_j dbar p[j,h]
//             gz = gy (#3), gout tiled over the heads (#4)
//   a[j,k]   = sum_i A[i,j] G[i,k]
//   p̄[j,h]  = sum_i dbar r[i,h] + sum_{k in h} a[j,k] x[j,c]            (#3)
//                                + sum_{k in h} cd(Y[j,k] a[j,k])       (#4)
//   x̄[j,c]  = sum_h p[j,h] a[j, h*C_in + c]                            (#3)
//            = sum_k yb[j,k] cd(w[h,c,o]),  yb = cd(p[j,h] a[j,k])      (#4)
//   W̄       = sum_i cd(z r)[i,:]^T cd(gout)[i,:]                       (#3)
//            = sum_j yb[j,:]^T cd(x)[j,:]                               (#4)
// with cd() where the Pallas bodies cast (banded_pallas.py:241-321 and
// 159-217; blocksparse.py:182-247 and :156-161 reuse them).  The TPU kernel
// works per row block on window slabs that XLA folds into node rows
// (_fold_windows_T, or _fold_blocks_T over blk_idx) and emits per-block W̄
// slabs; #4 casts each block's slab before the fold, so here the
// transform-first column pass applies its casts once per (row block, list
// position) that holds the node and sums the results.
//
// What bounds it on the H100: the bytes it must move (the int8 mask and
// the (N, K) operands) against a little arithmetic — only ~12 of the
// window slots of a row are set.  Design:
//   - the TPU kernel holds a block's whole (T, W) D, mask and K in VMEM; a
//     Hopper CTA cannot, and the backward reduces along both window axes
//     (r̄ over a row's columns, p̄ and x̄ over a column's rows).  So two
//     passes, each owning its output rows and writing them once, with no
//     fold and no atomics:
//       * the row pass (one warp per row i) scans the row's mask window
//         32 slots at a time, and for each set slot recomputes D, A and
//         mdd and accumulates z (in shared memory), the dot product for
//         dbar, and r̄'s denominator part;
//       * the column pass (one warp per node j) scans the mask column of
//         j in every row block whose window holds it — the three
//         neighbours for the band, the CSR transpose of blk_idx for
//         block-sparse windows, where nothing but B bounds their number
//         and a padded list entry is one more (empty) column to scan — and
//         accumulates a and p̄'s denominator part the same way;
//   - the per-node operands (V, Y, gy, G) are built once per node by
//     elementwise launches, the x̄ of #4 by a per-node product, and W̄ as
//     per-band-block partial products (32x32 tiles in shared memory) that
//     the wrapper sums, as XLA sums the TPU kernel's W̄ slabs.
// Every product is an f32 FMA over cd() operands.  Later work: mma/wgmma
// tiles for W̄ and the (N, K) operands, and a coalesced column scan.

#pragma once

#include "banded_common.cuh"

namespace {

constexpr int kWarps = 4;  // rows (row pass) or nodes (column pass) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// A = cd(m / max(D, 1e-12)) and the clamp subgradient mdd of one slot; D is
// summed over the heads in the forward kernel's order.
__device__ __forceinline__ void slot_weights(const float (&ri)[kMaxHeads],
                                             const float (&pj)[kMaxHeads],
                                             int heads, float mf, int bf16,
                                             float& a, float& mdd) {
  float d = 0.f;
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < heads) d = fmaf(ri[h], pj[h], d);
  }
  const float dinv = 1.f / fmaxf(d, 1e-12f);
  const float minv = mf * dinv;
  a = cd(minv, bf16);
  mdd = d > 1e-12f ? -minv * dinv : 0.f;
}

__device__ __forceinline__ void load_heads(float (&dst)[kMaxHeads],
                                           const float* src, int heads) {
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) dst[h] = h < heads ? src[h] : 0.f;
}

// G (and gy for aggregate-first), one thread per (node, column).
__global__ void row_operand_kernel(const float* __restrict__ r,
                                   const float* __restrict__ w,
                                   const float* __restrict__ gout,
                                   float* __restrict__ gy,
                                   float* __restrict__ g, int n, int heads,
                                   int cv, int c_out, int tf, int bf16) {
  const int kk = heads * cv;
  const long long total = (long long)n * kk;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / kk;
    const int k = (int)(e - i * kk);
    const int h = k / cv;
    const float rh = r[i * heads + h];
    const float* gi = gout + i * c_out;
    if (tf) {
      g[e] = cd(gi[k - h * cv] * rh, bf16);
    } else {
      const float* wk = w + (long long)k * c_out;  // W_flat row k
      float acc = 0.f;
      for (int o = 0; o < c_out; ++o) {
        acc = fmaf(cd(wk[o], bf16), cd(gi[o], bf16), acc);
      }
      gy[e] = acc;
      g[e] = cd(acc * rh, bf16);
    }
  }
}

// Row pass: r̄ (N, H), and for aggregate-first zr = cd(z r) (N, K).
template <bool kIndexed>
__global__ void __launch_bounds__(kThreads)
bwd_row_kernel(const float* __restrict__ r, const float* __restrict__ p,
               const float* __restrict__ v, const float* __restrict__ g,
               const float* __restrict__ gz, const int8_t* __restrict__ m,
               float* __restrict__ rbar, float* __restrict__ zr,
               WindowMap<kIndexed> map, int n, int heads, int cv, int tf,
               int bf16) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWarps + warp;
  if (i >= n) return;
  const int kk = heads * cv;
  const int win = map.width();
  float* z = smem + warp * kk;
  for (int k = lane; k < kk; k += 32) z[k] = 0.f;

  float ri[kMaxHeads], rd[kMaxHeads], pj[kMaxHeads];
  load_heads(ri, r + i * heads, heads);
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) rd[h] = 0.f;

  const int blk = (int)(i / map.tile);
  const int8_t* mrow = m + i * win;
  const float* gi = g + i * kk;
  for (int w0 = 0; w0 < win; w0 += 32) {
    const int mk = mrow[w0 + lane];
    unsigned set = __ballot_sync(kFull, mk != 0);
    if (set == 0) continue;
    const long long j0 = map.node(blk, w0);  // the node of slot w0
    while (set) {  // warp-uniform: one set slot at a time
      const int l = __ffs(set) - 1;
      set &= set - 1;
      const float mf = (float)__shfl_sync(kFull, mk, l);
      const long long j = j0 + l;
      if (j < 0 || j >= n) continue;  // zero rows outside [0, N)
      load_heads(pj, p + j * heads, heads);
      float a, mdd;
      slot_weights(ri, pj, heads, mf, bf16, a, mdd);
      const float* vj = v + j * kk;
      float kd = 0.f;
      for (int k = lane; k < kk; k += 32) {
        const float vv = vj[k];
        kd = fmaf(gi[k], vv, kd);
        z[k] = fmaf(a, vv, z[k]);
      }
      const float dbar = mdd * warp_sum(kd);
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) rd[h] = fmaf(dbar, pj[h], rd[h]);
    }
  }
  __syncwarp();

#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < heads) {
      float s = 0.f;
      for (int c = lane; c < cv; c += 32) {
        const int k = h * cv + c;
        const float zk = z[k];
        const float gzk = tf ? gz[i * cv + c] : gz[i * kk + k];
        s += cd(gzk * zk, bf16);
        if (!tf) zr[i * kk + k] = cd(zk * ri[h], bf16);
      }
      s = warp_sum(s);
      if (lane == 0) rbar[i * heads + h] = s + rd[h];
    }
  }
}

// Column pass: p̄ (N, H), and x̄ (N, C_in) for aggregate-first or
// yb (N, K) for transform-first.
template <bool kIndexed>
__global__ void __launch_bounds__(kThreads)
bwd_col_kernel(const float* __restrict__ r, const float* __restrict__ p,
               const float* __restrict__ x, const float* __restrict__ v,
               const float* __restrict__ g, const float* __restrict__ y,
               const int8_t* __restrict__ m, float* __restrict__ pbar,
               float* __restrict__ xbar, float* __restrict__ yb,
               WindowMap<kIndexed> map, int n, int heads, int c_in, int cv,
               int tf, int bf16) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long j = (long long)blockIdx.x * kWarps + warp;
  if (j >= n) return;
  const int kk = heads * cv;
  const int tile = map.tile;
  const int win = map.width();
  float* acc = smem + (long long)warp * kk * (tf ? 2 : 1);  // a[j, :]
  float* ybs = acc + kk;  // transform-first: sum over row blocks of yb
  for (int k = lane; k < kk; k += 32) {
    acc[k] = 0.f;
    if (tf) ybs[k] = 0.f;
  }

  float pj[kMaxHeads], pd[kMaxHeads], pdir[kMaxHeads], ri[kMaxHeads];
  load_heads(pj, p + j * heads, heads);
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    pd[h] = 0.f;
    pdir[h] = 0.f;
  }
  const float* vj = v + j * kk;
  const int bj = (int)(j / tile);
  const int tj = (int)(j - (long long)bj * tile);
  const long long q_end = map.visits_end(bj);
  for (long long q = map.visits_begin(bj); q < q_end; ++q) {
    int bi, pos;
    if (!map.visit(q, bj, bi, pos)) continue;
    const long long wcol = (long long)pos * tile + tj;  // j's window slot
    for (int t0 = 0; t0 < tile; t0 += 32) {
      const long long row0 = (long long)bi * tile + t0;
      const int mk = m[(row0 + lane) * win + wcol];
      unsigned set = __ballot_sync(kFull, mk != 0);
      while (set) {
        const int l = __ffs(set) - 1;
        set &= set - 1;
        const float mf = (float)__shfl_sync(kFull, mk, l);
        const long long i = row0 + l;
        load_heads(ri, r + i * heads, heads);
        float a, mdd;
        slot_weights(ri, pj, heads, mf, bf16, a, mdd);
        const float* gi = g + i * kk;
        float kd = 0.f;
        for (int k = lane; k < kk; k += 32) {
          const float gv = gi[k];
          kd = fmaf(gv, vj[k], kd);
          acc[k] = fmaf(a, gv, acc[k]);
        }
        const float dbar = mdd * warp_sum(kd);
#pragma unroll
        for (int h = 0; h < kMaxHeads; ++h) pd[h] = fmaf(dbar, ri[h], pd[h]);
      }
    }
    if (tf) {  // this visit's slab, cast as _bwd_body_tf casts it
      __syncwarp();
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < heads) {
          float s = 0.f;
          for (int o = lane; o < cv; o += 32) {
            const int k = h * cv + o;
            const float ak = acc[k];
            s += cd(y[j * kk + k] * ak, bf16);
            ybs[k] += cd(pj[h] * ak, bf16);
            acc[k] = 0.f;
          }
          pdir[h] += warp_sum(s);
        }
      }
      __syncwarp();
    }
  }
  __syncwarp();

  if (tf) {
    for (int k = lane; k < kk; k += 32) yb[j * kk + k] = ybs[k];
  } else {
    for (int c = lane; c < c_in; c += 32) {
      float s = 0.f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < heads) s = fmaf(pj[h], acc[h * c_in + c], s);
      }
      xbar[j * c_in + c] = s;
    }
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) {
        float s = 0.f;
        for (int c = lane; c < c_in; c += 32) {
          s = fmaf(acc[h * c_in + c], x[j * c_in + c], s);
        }
        pdir[h] = warp_sum(s);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) pbar[j * heads + h] = pdir[h] + pd[h];
    }
  }
}

// Transform-first x̄[j,c] = sum_{h,o} yb[j, h*C_out + o] cd(w[h,c,o]).
__global__ void xbar_tf_kernel(const float* __restrict__ yb,
                               const float* __restrict__ w,
                               float* __restrict__ xbar, int n, int heads,
                               int c_in, int c_out, int bf16) {
  const long long total = (long long)n * c_in;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long j = e / c_in;
    const int c = (int)(e - j * c_in);
    const float* ybj = yb + j * heads * c_out;
    float acc = 0.f;
    for (int h = 0; h < heads; ++h) {
      const float* wr = w + ((long long)h * c_in + c) * c_out;
      for (int o = 0; o < c_out; ++o) {
        acc = fmaf(ybj[h * c_out + o], cd(wr[o], bf16), acc);
      }
    }
    xbar[e] = acc;
  }
}

// W̄ partials: part[s, k, c] = sum over the rows i of band block s of
// lhs[i, k] * cd(rhs[i, c]); 32x32 output tiles, rows staged 32 at a time.
__global__ void __launch_bounds__(256)
wbar_partial_kernel(const float* __restrict__ lhs,
                    const float* __restrict__ rhs, float* __restrict__ part,
                    int kl, int cr, int rows, int bf16) {
  __shared__ float l_s[32][33];
  __shared__ float r_s[32][33];
  const int k0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const long long s = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 5;  // output rows ty + 8q of the tile
  const int tx = tid & 31;  // output column
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t0 = 0; t0 < rows; t0 += 32) {
    for (int e = tid; e < 32 * 32; e += 256) {
      const int row = e >> 5;
      const int col = e & 31;
      const long long i = s * rows + t0 + row;
      const bool in = t0 + row < rows;
      l_s[row][col] = (in && k0 + col < kl) ? lhs[i * kl + k0 + col] : 0.f;
      r_s[row][col] =
          (in && c0 + col < cr) ? cd(rhs[i * cr + c0 + col], bf16) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int row = 0; row < 32; ++row) {
      const float rv = r_s[row][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(l_s[row][ty + 8 * q], rv, acc[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + ty + 8 * q;
    const int c = c0 + tx;
    if (k < kl && c < cr) part[(s * kl + k) * cr + c] = acc[q];
  }
}

int set_smem(const void* kernel, int bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// v, g, y or gy (the other may be null) and wl are (n, heads*cv) scratch
// with cv = tf ? c_out : c_in; wpart is (n/tile, heads*cv, tf ? c_in :
// c_out); outputs rbar, pbar (n, heads), xbar (n, c_in).  Returns the
// cudaGetLastError() code after the launches (0 on success).
template <bool kIndexed>
int launch_window_bwd(const float* r, const float* p, const float* x,
                      const float* w, const int8_t* m, const float* gout,
                      float* v, float* g, float* y, float* gy, float* wl,
                      float* wpart, float* rbar, float* pbar, float* xbar,
                      WindowMap<kIndexed> map, int n, int heads, int c_in,
                      int c_out, int tf, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = tf ? c_out : c_in;
  const int kk = heads * cv;
  const long long nk = (long long)n * kk;
  int err;

  window_operand_kernel<<<elementwise_blocks(nk), 256, 0, s>>>(
      p, x, w, v, tf ? y : nullptr, n, heads, c_in, c_out, tf, bf16);
  if ((err = (int)cudaGetLastError())) return err;
  row_operand_kernel<<<elementwise_blocks(nk), 256, 0, s>>>(
      r, w, gout, gy, g, n, heads, cv, c_out, tf, bf16);
  if ((err = (int)cudaGetLastError())) return err;

  const int row_smem = kWarps * kk * (int)sizeof(float);
  const int col_smem = row_smem * (tf ? 2 : 1);
  if ((err = set_smem((const void*)bwd_row_kernel<kIndexed>, row_smem)))
    return err;
  if ((err = set_smem((const void*)bwd_col_kernel<kIndexed>, col_smem)))
    return err;
  bwd_row_kernel<kIndexed><<<n / kWarps, kThreads, row_smem, s>>>(
      r, p, v, g, tf ? gout : gy, m, rbar, tf ? nullptr : wl, map, n, heads,
      cv, tf, bf16);
  if ((err = (int)cudaGetLastError())) return err;
  bwd_col_kernel<kIndexed><<<n / kWarps, kThreads, col_smem, s>>>(
      r, p, x, v, g, y, m, pbar, xbar, tf ? wl : nullptr, map, n, heads, c_in,
      cv, tf, bf16);
  if ((err = (int)cudaGetLastError())) return err;

  const int cr = tf ? c_in : c_out;
  if (tf) {
    xbar_tf_kernel<<<elementwise_blocks((long long)n * c_in), 256, 0, s>>>(
        wl, w, xbar, n, heads, c_in, c_out, bf16);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const dim3 grid((kk + 31) / 32, (cr + 31) / 32, n / map.tile);
  wbar_partial_kernel<<<grid, 256, 0, s>>>(wl, tf ? x : gout, wpart, kk, cr,
                                           map.tile, bf16);
  return (int)cudaGetLastError();
}

}  // namespace
