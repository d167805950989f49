// FeaStConv window aggregate, backward, for Hopper (sm_90a): the kernels
// that banded_bwd.cu instantiates over the contiguous band (TPU kernels #3
// and #4) and blocksparse_bwd.cu over block-sparse windows (TPU kernel #6);
// WindowMap (banded_common.cuh) says where a row block's window lies.
// "(#3)" below marks the aggregate-first schedule (C_out >= C_in), "(#4)"
// the transform-first one (C_out < C_in), in either instantiation.
//
// Function.  With the forward's D, A = cd(M / max(D, 1e-12)) and window
// operand V (window_fwd.cuh), per row i and window column j (a set mask
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
// window slots of a row are set — and the per-node products, 0.1-0.8 GFLOP
// each.  Design:
//   - the TPU kernel holds a block's whole (T, W) D, mask and K in VMEM; a
//     Hopper CTA cannot, and the backward reduces along both window axes
//     (r̄ over a row's columns, p̄ and x̄ over a column's rows).  So two
//     passes, each owning its output rows and writing them once, with no
//     fold and no atomics, both over the set slots only and through the
//     same inner loop (window_walk.cuh):
//       * the row pass (row_walk_kernel, one warp per row i) is the
//         forward's walk with the row's G in registers beside z;
//       * the column pass (col_walk_kernel, a CTA per 32 neighbouring
//         nodes j) visits every row block whose window holds its nodes —
//         the three neighbours for the band, the CSR transpose of blk_idx
//         for block-sparse windows, where nothing but B bounds their number
//         and a padded list entry is one more (empty) visit.  A visit's
//         (T rows) x (32 columns) mask panel is copied into shared memory
//         row by row, 32 contiguous bytes each, so the mask moves in whole
//         sectors; each warp then scans its own four columns from there,
//         one after the other.  The band's three panels are loaded once per
//         CTA; transform-first closes every visit with its casts, so a
//         node's slots come in up to three short batches, and that latency,
//         not bytes, is what the pass costs (it is the largest part of a
//         backward call); up to K = 640 the kernel is held to 128 registers
//         so that two CTAs share an SM;
//   - every product over the nodes' K columns — Y (#4), gy (#3), x̄ (#4),
//     W̄ — is a tiled kernel of node_product.cuh (Y and gy, whose operands
//     are both cast, on the tensor cores under bf16); G of #4 and V of #3
//     are elementwise.  W̄ comes as per-row-block partials that the wrapper
//     sums, as XLA sums the TPU kernel's W̄ slabs.
// Every product sums exact products of cd() operands in f32.

#pragma once

#include "node_product.cuh"
#include "window_walk.cuh"

namespace {

constexpr int kColWarps = 8;
constexpr int kColThreads = 32 * kColWarps;
constexpr int kColNodes = 32;  // neighbouring nodes of one CTA: a mask sector
constexpr int kColPerWarp = kColNodes / kColWarps;

// A batch of the column pass: ring entries are (row i << 8 | mask byte).
template <int kChunks>
__device__ __forceinline__ void col_batch(WalkState<kChunks, true>& s,
                                          const int* ring, int head, int cnt,
                                          const float* r, const float* g,
                                          int ldk, int heads, int lane,
                                          int bf16) {
  int other = -1;
  float mf = 0.f;
  if (lane < cnt) {
    const int ent = ring[(head + lane) & (kRing - 1)];
    mf = (float)(int8_t)(ent & 0xff);
    other = ent >> 8;
  }
  __syncwarp();
  walk_batch<kChunks, true>(s, other, mf, r, g, ldk, heads, cnt, lane, bf16);
}

// Column pass: p̄ (N, H), and x̄ (N, C_in) for aggregate-first or yb (N, ldk)
// for transform-first.  v, g, y, yb are (n, ldk).  Dynamic shared memory:
// kColWarps * (tf ? 2 : 1) * ldk floats (a[j,:] and, transform-first, the
// sum over the visits of yb), then vis_cap mask panels of tile * 32 bytes.
template <bool kIndexed, int kChunks>
__global__ void __launch_bounds__(kColThreads, kChunks <= 5 ? 2 : 1)
col_walk_kernel(const float* __restrict__ r, const float* __restrict__ p,
                const float* __restrict__ x, const float* __restrict__ v,
                const float* __restrict__ g, const float* __restrict__ y,
                const int8_t* __restrict__ m, float* __restrict__ pbar,
                float* __restrict__ xbar, float* __restrict__ yb,
                WindowMap<kIndexed> map, int n, int heads, int c_in, int cv,
                int ldk, int tf, int bf16, int vis_cap) {
  extern __shared__ float4 smem4[];
  __shared__ int ring_s[kColWarps][kRing];
  __shared__ float heads_s[kColWarps][kMaxHeads];  // p[j, :], indexed by k / cv
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kk = heads * cv;
  const int tile = map.tile;
  const int win = map.width();
  const int per_warp = (tf ? 2 : 1) * ldk;
  float* accs = reinterpret_cast<float*>(smem4) + warp * per_warp;  // a[j, :]
  float* ybs = accs + ldk;  // transform-first: sum over the visits of yb
  int8_t* panels = reinterpret_cast<int8_t*>(
      reinterpret_cast<float*>(smem4) + kColWarps * per_warp);
  int* ring = ring_s[warp];

  const long long j0 = (long long)blockIdx.x * kColNodes;
  const int bj = (int)(j0 / tile);
  const int tj0 = (int)(j0 - (long long)bj * tile);
  const long long q_begin = map.visits_begin(bj);
  const long long q_end = map.visits_end(bj);
  const bool one_load = q_end - q_begin <= vis_cap;  // the panels stay
  // the heads of this lane's four columns of each chunk, one byte each
  // (worked out once: a division per column and visit would cost more than
  // the visit's arithmetic)
  unsigned head_of[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    head_of[c] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = c * kChunkCols + lane * 4 + e;
      head_of[c] |= (unsigned)(k < kk ? k / cv : 0) << (8 * e);
    }
  }

  for (int cc = 0; cc < kColPerWarp; ++cc) {
    const int col = warp * kColPerWarp + cc;
    const long long j = j0 + col;
    WalkState<kChunks, true> s;
    walk_init<kChunks, true>(s, p + j * heads, v + j * ldk, heads, ldk, lane);
    float pdir = 0.f;  // lane h holds the direct part of p̄[j, h]
    if (tf) {  // ybs holds this lane's columns
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int k0 = c * kChunkCols + lane * 4;
        if (k0 < ldk) *reinterpret_cast<float4*>(ybs + k0) = zero4();
      }
    }
    if (lane < kMaxHeads) heads_s[warp][lane] = lane < heads ? p[j * heads + lane] : 0.f;
    __syncwarp();
    int head = 0, tail = 0;

    for (long long q0 = q_begin; q0 < q_end; q0 += vis_cap) {
      const int visits = (int)min((long long)vis_cap, q_end - q0);
      if (cc == 0 || !one_load) {
        __syncthreads();  // the panels' readers are done
        for (int u = 0; u < visits; ++u) {
          int bi, pos;
          if (!map.visit(q0 + u, bj, bi, pos)) continue;
          const int8_t* src =
              m + ((long long)bi * tile) * win + (long long)pos * tile + tj0;
          int8_t* dst = panels + (long long)u * tile * kColNodes;
          for (int e = threadIdx.x; e < tile * 2; e += kColThreads) {
            const int row = e >> 1;
            const int half = (e & 1) * 16;
            *reinterpret_cast<int4*>(dst + row * kColNodes + half) = __ldg(
                reinterpret_cast<const int4*>(src + (long long)row * win + half));
          }
        }
        __syncthreads();
      }
      for (int u = 0; u < visits; ++u) {
        int bi, pos;
        if (!map.visit(q0 + u, bj, bi, pos)) continue;
        const int8_t* panel = panels + (long long)u * tile * kColNodes + col;
        const int tail0 = tail;
        for (int t0 = 0; t0 < tile; t0 += 32) {
          const int byte = panel[(t0 + lane) * kColNodes] & 0xff;
          tail = ring_push(ring, tail, byte != 0,
                           ((bi * tile + t0 + lane) << 8) | byte, lane);
          if (tail - head >= 32) {
            col_batch<kChunks>(s, ring, head, 32, r, g, ldk, heads, lane, bf16);
            head += 32;
          }
        }
        // transform-first: this visit's slab, cast as _bwd_body_tf casts it
        // (a visit without a set slot adds cd(0) = 0)
        if (tf && tail != tail0) {
          if (tail > head) {
            col_batch<kChunks>(s, ring, head, tail - head, r, g, ldk, heads,
                               lane, bf16);
            head = tail;
          }
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const int k0 = c * kChunkCols + lane * 4;
            if (k0 < ldk) {
              const float ak[4] = {s.acc[c].x, s.acc[c].y, s.acc[c].z, s.acc[c].w};
              const float4 yrow = __ldg(reinterpret_cast<const float4*>(y + j * ldk + k0));
              const float yk[4] = {yrow.x, yrow.y, yrow.z, yrow.w};
              const float4 old = *reinterpret_cast<const float4*>(ybs + k0);
              float ys[4] = {old.x, old.y, old.z, old.w};
              float ya[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                ya[e] = 0.f;
                if (k0 + e < kk) {
                  ya[e] = cd(yk[e] * ak[e], bf16);
                  ys[e] += cd(heads_s[warp][(head_of[c] >> (8 * e)) & 0xff] * ak[e], bf16);
                }
              }
              *reinterpret_cast<float4*>(accs + k0) = make_float4(ya[0], ya[1], ya[2], ya[3]);
              *reinterpret_cast<float4*>(ybs + k0) = make_float4(ys[0], ys[1], ys[2], ys[3]);
            }
            s.acc[c] = zero4();
          }
          __syncwarp();
          pdir += head_sum_of_lane(accs, heads, cv, lane);
          __syncwarp();
        }
      }
    }

    if (tf) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int k0 = c * kChunkCols + lane * 4;
        if (k0 < ldk) {
          *reinterpret_cast<float4*>(yb + j * ldk + k0) =
              *reinterpret_cast<const float4*>(ybs + k0);
        }
      }
    } else {
      if (tail > head) {
        col_batch<kChunks>(s, ring, head, tail - head, r, g, ldk, heads, lane,
                           bf16);
      }
      spill_acc<kChunks>(s.acc, accs, ldk, lane);
      for (int c = lane; c < c_in; c += 32) {
        float sum = 0.f;
#pragma unroll
        for (int h = 0; h < kMaxHeads; ++h) {
          if (h < heads) sum = fmaf(s.hown[h], accs[h * c_in + c], sum);
        }
        xbar[j * c_in + c] = sum;
      }
      float part[kMaxHeads];
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) part[h] = 0.f;
      for (int c = lane; c < c_in; c += 32) {
        const float xv = x[j * c_in + c];
#pragma unroll
        for (int h = 0; h < kMaxHeads; ++h) {
          if (h < heads) part[h] = fmaf(accs[h * c_in + c], xv, part[h]);
        }
      }
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < heads) {
          const float sum = warp_sum(part[h]);
          if (lane == h) pdir = sum;
        }
      }
    }
    float den = 0.f;  // lane h: the denominator part of p̄[j, h]
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) {
        const float sum = warp_sum(s.hacc[h]);
        if (lane == h) den = sum;
      }
    }
    if (lane < heads) pbar[j * heads + lane] = pdir + den;
    __syncwarp();  // accs and ybs are written again for the next node
  }
}

// mask panels the column pass keeps in shared memory at a time: all three
// of the band when they fit in 96 KB, else (and for block-sparse windows,
// whose column blocks have about K visits each) as many as 80 KB hold
inline int visit_capacity(bool indexed, int tile) {
  const int panel = tile * kColNodes;
  if (!indexed && 3 * panel <= 96 * 1024) return 3;
  const int cap = 80 * 1024 / panel;
  return cap > 0 ? cap : 1;
}

template <bool kIndexed>
int launch_col_walk(const float* r, const float* p, const float* x,
                    const float* v, const float* g, const float* y,
                    const int8_t* m, float* pbar, float* xbar, float* yb,
                    WindowMap<kIndexed> map, int n, int heads, int c_in,
                    int cv, int ldk, int tf, int bf16, cudaStream_t s) {
  return dispatch_chunks(ldk, [&](auto chunks) {
    const int vis_cap = visit_capacity(kIndexed, map.tile);
    const int smem = kColWarps * (tf ? 2 : 1) * ldk * (int)sizeof(float) +
                     vis_cap * map.tile * kColNodes;
    auto kernel = col_walk_kernel<kIndexed, decltype(chunks)::value>;
    if (int err = set_smem((const void*)kernel, smem)) return err;
    kernel<<<n / kColNodes, kColThreads, smem, s>>>(
        r, p, x, v, g, y, m, pbar, xbar, yb, map, n, heads, c_in, cv, ldk, tf,
        bf16, vis_cap);
    return (int)cudaGetLastError();
  });
}

// v, g, y or gy (the other may be null) and wl are (n, ldk) scratch with
// ldk = heads*cv rounded up to a multiple of 4, cv = tf ? c_out : c_in;
// wpart is (n/tile, heads*cv, tf ? c_in : c_out); outputs rbar, pbar
// (n, heads), xbar (n, c_in).  part_ms (nullable, kMaxParts floats) receives
// the milliseconds of each launch in order and makes the call synchronise.
// Returns the cudaGetLastError() code after the launches (0 on success).
template <bool kIndexed>
int launch_window_bwd(const float* r, const float* p, const float* x,
                      const float* w, const int8_t* m, const float* gout,
                      float* v, float* g, float* y, float* gy, float* wl,
                      float* wpart, float* rbar, float* pbar, float* xbar,
                      WindowMap<kIndexed> map, int n, int heads, int c_in,
                      int c_out, int ldk, int tf, int bf16, void* stream,
                      float* part_ms) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cv = tf ? c_out : c_in;
  const int kk = heads * cv;
  PartTimer timer(s, part_ms);
  int err;

  // the window operand V (and Y), then the row operand G (and gy)
  if (tf) {
    err = launch_tf_operand(p, x, w, v, y, n, heads, c_in, c_out, ldk, bf16, s);
  } else {
    scaled_operand_kernel<<<elementwise_blocks((long long)n * ldk), 256, 0,
                            s>>>(p, x, v, n, heads, cv, ldk, bf16);
    err = (int)cudaGetLastError();
  }
  if (err) return timer.finish(err);
  timer.mark();
  if (tf) {
    scaled_operand_kernel<<<elementwise_blocks((long long)n * ldk), 256, 0,
                            s>>>(r, gout, g, n, heads, cv, ldk, bf16);
    err = (int)cudaGetLastError();
  } else {  // gy = cd(gout) cd(W_flat)^T, G = cd(gy r)
    err = launch_af_row_operand(r, gout, w, g, gy, n, heads, c_in, c_out, ldk,
                                bf16, s);
  }
  if (err) return timer.finish(err);
  timer.mark();

  err = launch_row_walk<kIndexed, true>(r, p, v, g, tf ? gout : gy, m, nullptr,
                                        rbar, tf ? nullptr : wl, map, n, heads,
                                        cv, ldk, tf, bf16, s);
  if (err) return timer.finish(err);
  timer.mark();
  err = launch_col_walk<kIndexed>(r, p, x, v, g, y, m, pbar, xbar,
                                  tf ? wl : nullptr, map, n, heads, c_in, cv,
                                  ldk, tf, bf16, s);
  if (err) return timer.finish(err);
  timer.mark();

  if (tf) {  // x̄ = yb cd(W2)^T
    ProductArgs q{};
    q.a = wl; q.b = w; q.c = xbar;
    q.m = n; q.n = c_in; q.k = kk;
    q.lda = ldk; q.ldc = c_in;
    q.cast_a = 0; q.cast_b = 1; q.bf16 = bf16;
    q.c_in = c_in; q.c_out = c_out;
    err = launch_node_product<false, true, true, false>(q, 1, s);
    if (err) return timer.finish(err);
    timer.mark();
  }
  err = launch_wbar_partials(wl, tf ? x : gout, wpart, n / map.tile, map.tile,
                             kk, ldk, tf ? c_in : c_out, bf16, s);
  if (err) return timer.finish(err);
  timer.mark();
  return timer.finish(0);
}

}  // namespace
