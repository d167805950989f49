// One warp walks the set mask slots of one node: the inner loop that the
// forward aggregate, the backward's row pass (both in row_walk_kernel, here)
// and the backward's column pass (window_bwd.cuh) share.
//
// A slot joins the warp's own node with the node at its other end (a row i
// and a window node j; the row pass owns i, the column pass j).  Per slot,
// with D = sum_h r[i,h] p[j,h]:
//   A   = cd(M / max(D, 1e-12))
//   acc += A * row[other, :]            (z = sum A V, or a = sum A G)
// and in the backward, with the own node's operand row (G[i,:] or V[j,:]):
//   dbar = (D > 1e-12 ? -(M/D)/D : 0) * sum_k own[k] row[other, k]
//   hacc += dbar * heads[other, :]      (the denominator part of r̄ or p̄)
//
// What bounds it on the H100: the operand rows of the set slots — about 12
// of a facet row's 768 to 2,304 window slots — not the window.  So:
//   - the warp reads the node's mask bytes 16 a lane (512 slots a load in
//     the row pass), and lanes with a set byte put (slot, value) into a ring
//     of 64 entries in shared memory, compacted by ballots; nothing else
//     touches a slot that is not set, and the mask is read once;
//   - whenever 32 entries wait (and at the end), one batch: lane e takes
//     entry e, finds its other node, reads that node's heads vector and
//     computes D, A and the clamp subgradient, all lanes at once; then the
//     warp walks the batch, broadcasting (node, A) by shuffle and reading
//     the other node's operand row as 16 bytes a lane; neighbouring nodes of
//     an RCM-ordered mesh share most of their neighbours, so these rows come
//     from L1/L2.  The loop is unrolled so that several rows are in flight;
//   - the accumulator, all K = H*cv columns of it, lives in K/32 registers
//     a lane (column q*128 + lane*4 + e in register 4q + e; kChunks = K/128
//     rounded up is a template parameter: 1, 3, 5 or 9); a node's row is
//     walked once whatever K is.  The (n, K) operands are stored with their
//     rows padded to a multiple of 4 floats (zeros), so the 16-byte loads
//     are aligned at every K;
//   - the epilogues go through K floats of shared memory per warp.
// Sums run in a fixed order: no atomics.

#pragma once

#include <type_traits>

#include "banded_common.cuh"

namespace {

constexpr int kRing = 64;                 // entries of a warp's slot ring
constexpr int kChunkCols = 128;           // columns of one float4 step
constexpr int kMaxChunks = 9;             // K <= 1152
constexpr int kWalkWarps = 4;             // rows per CTA of row_walk_kernel
constexpr int kWalkThreads = 32 * kWalkWarps;

template <int kChunks, bool kBwd>
struct WalkState {
  float4 acc[kChunks];      // sum of A * row[other]
  float4 own[kChunks];      // kBwd: the own node's operand row
  float hown[kMaxHeads];    // the own node's heads vector (r[i] or p[j])
  float hacc[kMaxHeads];    // kBwd: this lane's part of sum dbar * heads[other]
};

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& v) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// Each head's strip of K floats in shared memory summed (vals[h*cv + c]):
// lane h returns the sum of head h, lanes from `heads` on return 0.
__device__ __forceinline__ float head_sum_of_lane(const float* vals, int heads,
                                                  int cv, int lane) {
  float mine = 0.f;
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < heads) {
      float sum = 0.f;
      for (int c = lane; c < cv; c += 32) sum += vals[h * cv + c];
      sum = warp_sum(sum);
      if (lane == h) mine = sum;
    }
  }
  return mine;
}

template <int kChunks, bool kBwd>
__device__ __forceinline__ void walk_init(WalkState<kChunks, kBwd>& s,
                                          const float* hown, const float* own,
                                          int heads, int ldk, int lane) {
  load_heads(s.hown, hown, heads);
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) s.hacc[h] = 0.f;
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    s.acc[q] = zero4();
    const int col = q * kChunkCols + lane * 4;
    s.own[q] = (kBwd && col < ldk)
                   ? __ldg(reinterpret_cast<const float4*>(own + col))
                   : zero4();
  }
}

// One batch of cnt <= 32 slots: lane e < cnt holds slot e's other node
// (-1 for a node outside [0, N), which reads as zero) and its mask value mf.
// heads_other (n, heads) and rows (n, ldk) are the other nodes' heads
// vectors and operand rows.
template <int kChunks, bool kBwd>
__device__ __forceinline__ void walk_batch(WalkState<kChunks, kBwd>& s,
                                           int other, float mf,
                                           const float* heads_other,
                                           const float* rows, int ldk,
                                           int heads, int cnt, int lane,
                                           int bf16) {
  float a = 0.f, mdd = 0.f;
  const bool mine = lane < cnt && other >= 0;
  if (mine) {
    const float* ho = heads_other + (long long)other * heads;
    float d = 0.f;  // summed over the heads in ascending order
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) d = fmaf(s.hown[h], ho[h], d);
    }
    if (kBwd) {
      const float dinv = 1.f / fmaxf(d, 1e-12f);
      const float minv = mf * dinv;
      a = cd(minv, bf16);
      mdd = d > 1e-12f ? -minv * dinv : 0.f;
    } else {
      a = cd(mf / fmaxf(d, 1e-12f), bf16);
    }
  }

  constexpr int kUnroll = kChunks <= 3 ? 4 : (kChunks <= 5 ? 2 : 1);
  float dbar = 0.f;
#pragma unroll(kUnroll)
  for (int e = 0; e < cnt; ++e) {
    const int j = __shfl_sync(kFull, other, e);
    const float ae = __shfl_sync(kFull, a, e);
    const float4* row =
        reinterpret_cast<const float4*>(rows + (long long)(j < 0 ? 0 : j) * ldk);
    float kd = 0.f;
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int col = q * kChunkCols + lane * 4;
      const float4 vv = (j >= 0 && col < ldk) ? __ldg(row + (col >> 2)) : zero4();
      fma4(s.acc[q], ae, vv);
      if (kBwd) kd = dot4(s.own[q], vv, kd);
    }
    if (kBwd) {
      kd = warp_sum(kd);
      if (lane == e) dbar = mdd * kd;
    }
  }
  if (kBwd && mine) {  // the heads vector again (from L1) rather than 16
                       // registers held across the loop
    const float* ho = heads_other + (long long)other * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) s.hacc[h] = fmaf(dbar, ho[h], s.hacc[h]);
    }
  }
}

// Lanes with `set` put `entry` at the ring's tail, in lane order; returns
// the new tail.  The caller runs a batch when tail - head reaches 32, so the
// ring never holds more than 63 entries.
__device__ __forceinline__ int ring_push(int* ring, int tail, bool set,
                                         int entry, int lane) {
  const unsigned who = __ballot_sync(kFull, set);
  if (who == 0) return tail;
  if (set) {
    ring[(tail + __popc(who & ((1u << lane) - 1u))) & (kRing - 1)] = entry;
  }
  __syncwarp();
  return tail + __popc(who);
}

// the accumulator registers -> K floats of this warp's shared memory
template <int kChunks>
__device__ __forceinline__ void spill_acc(const float4 (&acc)[kChunks],
                                          float* zs, int ldk, int lane) {
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int col = q * kChunkCols + lane * 4;
    if (col < ldk) *reinterpret_cast<float4*>(zs + col) = acc[q];
  }
  __syncwarp();
}

// A batch of the row pass: ring entries are (window slot << 8 | mask byte).
template <bool kIndexed, int kChunks, bool kBwd>
__device__ __forceinline__ void row_batch(WalkState<kChunks, kBwd>& s,
                                          const int* ring, int head, int cnt,
                                          const WindowMap<kIndexed>& map,
                                          int blk, int n, const float* p,
                                          const float* v, int ldk, int heads,
                                          int lane, int bf16) {
  int other = -1;
  float mf = 0.f;
  if (lane < cnt) {
    const int ent = ring[(head + lane) & (kRing - 1)];
    mf = (float)(int8_t)(ent & 0xff);
    const long long j = map.node(blk, ent >> 8);
    if (j >= 0 && j < n) other = (int)j;
  }
  __syncwarp();
  walk_batch<kChunks, kBwd>(s, other, mf, p, v, ldk, heads, cnt, lane, bf16);
}

// Forward aggregate (kBwd = false) and the backward's row pass (kBwd =
// true), one warp per row i.  With z[k] = sum_j A[i,j] V[j,k]:
//   forward, transform-first:  out[i,o] = sum_h cd(z[h*cv + o] r[i,h])
//   forward, aggregate-first:  zr[i,k]  = cd(z[k] r[i,h(k)])   (n, ldk)
//   backward: r̄[i,h] = sum_{k in h} cd(gz[i,k] z[k]) + sum_j dbar p[j,h]
//             (gz = gy (n, ldk), or gout tiled over the heads), and zr for
//             aggregate-first.
// v, g, gz (aggregate-first) and zr are (n, ldk); dynamic shared memory:
// kWalkWarps * ldk floats.  Every launch of an aggregate runs this kernel
// once, so its template arguments — block-sparse, forward or backward,
// transform-first — name the aggregate in a profile.
template <bool kIndexed, int kChunks, bool kBwd, bool kTf>
__global__ void __launch_bounds__(kWalkThreads)
row_walk_kernel(const float* __restrict__ r, const float* __restrict__ p,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ gz, const int8_t* __restrict__ m,
                float* __restrict__ out, float* __restrict__ rbar,
                float* __restrict__ zr, WindowMap<kIndexed> map, int n,
                int heads, int cv, int ldk, int bf16) {
  extern __shared__ float4 smem4[];
  __shared__ int ring_s[kWalkWarps][kRing];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * kWalkWarps + warp;
  if (i >= n) return;  // no block-wide barrier below
  const int kk = heads * cv;
  const int win = map.width();
  const int blk = (int)(i / map.tile);
  float* zs = reinterpret_cast<float*>(smem4) + warp * ldk;
  int* ring = ring_s[warp];

  WalkState<kChunks, kBwd> s;
  walk_init<kChunks, kBwd>(s, r + i * heads, kBwd ? g + i * ldk : nullptr,
                           heads, ldk, lane);

  // the row's mask, 16 bytes a lane; byte e of lane l is slot base + 16 l + e
  const int8_t* mrow = m + i * win;
  int head = 0, tail = 0;
  for (int base = 0; base < win; base += 512) {
    const int off = base + lane * 16;
    int4 mw = make_int4(0, 0, 0, 0);
    if (off < win) mw = __ldg(reinterpret_cast<const int4*>(mrow + off));
    if (!__any_sync(kFull, (mw.x | mw.y | mw.z | mw.w) != 0)) continue;
    const int words[4] = {mw.x, mw.y, mw.z, mw.w};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int byte = (words[e >> 2] >> (8 * (e & 3))) & 0xff;
      tail = ring_push(ring, tail, byte != 0, ((off + e) << 8) | byte, lane);
      if (tail - head >= 32) {
        row_batch<kIndexed, kChunks, kBwd>(s, ring, head, 32, map, blk, n, p,
                                           v, ldk, heads, lane, bf16);
        head += 32;
      }
    }
  }
  if (tail > head) {
    row_batch<kIndexed, kChunks, kBwd>(s, ring, head, tail - head, map, blk,
                                       n, p, v, ldk, heads, lane, bf16);
  }

  if (!kTf) {  // zr = cd(z r), from the registers
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int col = q * kChunkCols + lane * 4;
      if (col < ldk) {
        const float zq[4] = {s.acc[q].x, s.acc[q].y, s.acc[q].z, s.acc[q].w};
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = col + e;
          o[e] = k < kk ? cd(zq[e] * r[i * heads + k / cv], bf16) : 0.f;
        }
        *reinterpret_cast<float4*>(zr + i * ldk + col) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  }
  if (!kBwd && kTf) {  // the head sum
    spill_acc<kChunks>(s.acc, zs, ldk, lane);
    for (int o = lane; o < cv; o += 32) {
      float acc = 0.f;
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < heads) acc += cd(zs[h * cv + o] * s.hown[h], bf16);
      }
      out[i * cv + o] = acc;
    }
  }
  if (kBwd) {  // r̄: cd(gz z) per column, then each head's sum
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int col = q * kChunkCols + lane * 4;
      if (col < ldk) {
        const float zq[4] = {s.acc[q].x, s.acc[q].y, s.acc[q].z, s.acc[q].w};
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = col + e;
          o[e] = 0.f;
          if (k < kk) {
            const float gzk = kTf ? gz[i * cv + k % cv] : gz[i * ldk + k];
            o[e] = cd(gzk * zq[e], bf16);
          }
        }
        *reinterpret_cast<float4*>(zs + col) = make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncwarp();
    const float direct = head_sum_of_lane(zs, heads, cv, lane);
    float den = 0.f;  // lane h: the denominator part of r̄[i, h]
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) {
        const float sum = warp_sum(s.hacc[h]);
        if (lane == h) den = sum;
      }
    }
    if (lane < heads) rbar[i * heads + lane] = direct + den;
  }
}

// Calls f with the chunks of 128 columns that hold ldk as a compile-time
// constant, the template argument of the walk kernels: 1, 3, 5 or 9.
template <class F>
int dispatch_chunks(int ldk, F&& f) {
  if (ldk <= 1 * kChunkCols) return f(std::integral_constant<int, 1>{});
  if (ldk <= 3 * kChunkCols) return f(std::integral_constant<int, 3>{});
  if (ldk <= 5 * kChunkCols) return f(std::integral_constant<int, 5>{});
  if (ldk <= kMaxChunks * kChunkCols) {
    return f(std::integral_constant<int, kMaxChunks>{});
  }
  return (int)cudaErrorInvalidValue;  // wider than the accumulator
}

template <bool kIndexed, bool kBwd>
int launch_row_walk(const float* r, const float* p, const float* v,
                    const float* g, const float* gz, const int8_t* m,
                    float* out, float* rbar, float* zr,
                    WindowMap<kIndexed> map, int n, int heads, int cv,
                    int ldk, int tf, int bf16, cudaStream_t s) {
  return dispatch_chunks(ldk, [&](auto chunks) {
    const int smem = kWalkWarps * ldk * (int)sizeof(float);
    constexpr int kC = decltype(chunks)::value;
    auto kernel = tf ? row_walk_kernel<kIndexed, kC, kBwd, true>
                     : row_walk_kernel<kIndexed, kC, kBwd, false>;
    if (int err = set_smem((const void*)kernel, smem)) return err;
    kernel<<<(n + kWalkWarps - 1) / kWalkWarps, kWalkThreads, smem, s>>>(
        r, p, v, g, gz, m, out, rbar, zr, map, n, heads, cv, ldk, bf16);
    return (int)cudaGetLastError();
  });
}

}  // namespace
