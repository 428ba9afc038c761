// Fused multi-head softmax attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cvnets_tpu/ops/pallas/mha_attn.py:
//   _pallas_fwd (:134, body _fwd_kernel :81)  -> mha_attention_forward
//   _pallas_bwd (:153, body _bwd_kernel :95)  -> mha_attention_backward
// and, for S > 512, those of cvnets_tpu/ops/pallas/mha_attn_long.py:
//   _pallas_fwd (:142)                        -> mha_attention_forward
//   _pallas_dq (:257), _pallas_dkv (:279)     -> mha_attention_backward
// The long-sequence TPU kernels are KV-blocked flash attention with a dq pass
// over kv blocks and a dk/dv pass over q blocks, delta precomputed: the design
// below at every S, so one pair of entry points serves both. Nothing here
// depends on S beyond the grid's ceil(S/64) query or key tiles; offsets that
// scale with S are 64-bit. One difference from mha_attn_long.py: it saves
// lse = m + log(l) (:122), which is m again in float32 on a fully masked row
// (m = -1e30), so its backward gives that row's gradients S times too large;
// the (max, log sum) pair here keeps the 1/S of uniform attention.
// q, k and v are (B, S, H*D) in the layer's projection layout, q already scaled;
// head h is the column range [h*D, (h+1)*D). Each tensor is a pointer with a
// batch stride and a token stride (channel stride 1), so q, k and v may be
// column slices of one fused qkv projection and no copy is made. The optional
// key mask is additive, (B, S) float32; null means no mask.
//
// Design. The TPU kernel holds one batch element's whole (S, H*D) tile and the
// (S, S) float32 logits in VMEM. One Hopper block has at most 227 KB of shared
// memory and at S = 197 the logits alone are 155 KB, so this is the flash
// shape instead: tiles of 64 query rows and 64 key rows, four warps a block,
// each warp owning 16 rows of every tile.
//   * forward: grid (ceil(S/64) query tiles, H, B). A block loops over the key
//     tiles with an online softmax (running max and sum in float32), adds the
//     mask per key, normalises once at the end, and writes O in the input dtype
//     plus per-row statistics (max, log of the sum) for the backward.
//   * backward, two kernels, no atomics (the result is the same on every run):
//     dq: one block per query tile loops over the key tiles; it first computes
//         delta = rowsum(dO * O) for its rows and writes it for the second
//         kernel; then P = exp(S + mask - max - log sum), dS = P (dO V^T - delta),
//         dQ += dS K.
//     dkdv: one block per key tile loops over the query tiles; with the same P
//         and dS, transposed, dV += P^T dO and dK += dS^T Q.
//   This is the math of _bwd_kernel with 1/l taken out through the statistics.
//   The statistics are a (max, log sum) pair, not one log-sum-exp: in a row
//   whose keys are all masked with -1e30 every logit is -1e30 exactly, the row
//   attends uniformly, and -1e30 + log(S) rounds back to -1e30 in float32, which
//   would lose the 1/S.
// bfloat16 (the training path): every product runs on the tensor cores through
// mma.sync m16n8k16 (bf16 x bf16 -> f32). A warp's 16 x 64 logits, P, dP and dS
// and its output accumulators stay in registers in the mma fragment layout, and
// an accumulator of logits is reused as the A operand of the next product (the
// FlashAttention-2 arrangement); only the q, k, v and dO tiles go through shared
// memory. P and dS are rounded to bf16 for their products.
// float32: plain float32 FMAs on shared-memory tiles (no TF32), so that path
// keeps float32 accuracy; it serves float32 evaluation, not training speed.
// Softmax statistics, the mask and every accumulator are float32 on both paths,
// as in the Pallas body. Ragged edges: S need not be a multiple of 64. Tiles are
// zero-filled past S; keys past S get probability 0 exactly, rows past S are
// never written, and in bf16 a warp whose 16 rows all lie past S skips the
// tile's products (the forward also skips the products of padded key columns).
//
// What bounds it: at S = 197 and D = 64 one head does 4 S^2 D ~ 10 MFLOP
// forward on 3 S D 2 ~ 76 KB of bf16 inputs, about 130 flop per byte, so with
// tensor cores it sits near the H100's ridge (~295 flop per byte) and is bound
// by instruction issue and shared-memory traffic, not by HBM bytes.
// What the simple design leaves on the table: no wgmma (Hopper's warpgroup
// products) and no TMA or cp.async pipelining of the next tile, so a block
// waits on each tile's loads; the two backward kernels both recompute P and dP
// (7 products a tile pair where one kernel with atomics would do 5); and at
// S = 197 the padded rows of the last 5-row tiles still cost up to 16 of their
// 64 rows, and in the backward their padded columns too.

#include "attention_tiles.cuh"

namespace {

// The additive mask of keys [k0, k0 + 64) into shared memory; keys past S get
// `pad` (-inf where the probability must come out 0 by itself).
__device__ __forceinline__ void load_kmask(float* kmask, const float* mask, int b, int S, int k0,
                                           int k_rows, float pad) {
  if (threadIdx.x < kTile) {
    const int c = threadIdx.x;
    kmask[c] = c >= k_rows ? pad
                           : (mask != nullptr ? mask[static_cast<long long>(b) * S + k0 + c] : 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) mha_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ stats,
    int S, int H, Strides st, bool vec) {
  constexpr int ld = Bf16Tiles<D>::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kTile * ld;
  bf16* Vs = Ks + kTile * ld;
  float* kmask = reinterpret_cast<float*>(Vs + kTile * ld);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int q_rows = min(kTile, S - q0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(h) * D;

  load_tile<bf16, D>(Qs, ld, q + b * st.b[0] + q0 * st.s[0] + hd, st.s[0], q_rows, vec);
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};              // this lane's part of their running sums

  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int k_rows = min(kTile, S - k0);
    __syncthreads();  // every warp is done with the previous K and V tiles
    load_tile<bf16, D>(Ks, ld, k + b * st.b[1] + k0 * st.s[1] + hd, st.s[1], k_rows, vec);
    load_tile<bf16, D>(Vs, ld, v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2], k_rows, vec);
    load_kmask(kmask, mask, b, S, k0, k_rows, -INFINITY);
    __syncthreads();
    if (r0 >= q_rows) continue;  // this warp's rows are all past S

    float s[8][4];
    mm_abt<D>(s, Qs + r0 * ld, Ks, ld, k_rows, g, t);  // keys past S: 0 - inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] += kmask[8 * j + 2 * t + (e & 1)];
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // a row's 64 columns sit in the 4 lanes of its group
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);  // finite: every tile has a key
      alpha[i] = expf(m[i] - m_new);           // 0 on the first tile
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e / 2]);  // 0 for keys past S
        l[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e / 2];
    }
    mm_pm<D>(o, s, Vs, ld, k_rows, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  store_rows<D>(out + b * st.b[3] + q0 * st.s[3] + hd, st.s[3], r0, q_rows, o, l, g, t);
  if (t == 0) {
    const long long bhs = static_cast<long long>(gridDim.z) * H * S;
    const long long row0 = (static_cast<long long>(b) * H + h) * S + q0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r < q_rows) {
        stats[row0 + r] = m[i];
        stats[bhs + row0 + r] = logf(l[i]);
      }
    }
  }
}

// dQ, one block per query tile. Tensor order in st: q, k, v, o, dO, dq.
template <int D>
__global__ void __launch_bounds__(kThreads) mha_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, const bf16* __restrict__ o, const bf16* __restrict__ dout,
    const float* __restrict__ stats, float* __restrict__ delta, bf16* __restrict__ dq,
    int S, int H, Strides st, bool vec) {
  constexpr int ld = Bf16Tiles<D>::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kTile * ld;
  bf16* Ks = dOs + kTile * ld;
  bf16* Vs = Ks + kTile * ld;
  float* row_delta = reinterpret_cast<float*>(Vs + kTile * ld);
  float* kmask = row_delta + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int q_rows = min(kTile, S - q0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(h) * D;
  const long long bhs = static_cast<long long>(gridDim.z) * H * S;
  const long long row0 = (static_cast<long long>(b) * H + h) * S + q0;

  load_tile<bf16, D>(Qs, ld, q + b * st.b[0] + q0 * st.s[0] + hd, st.s[0], q_rows, vec);
  load_tile<bf16, D>(dOs, ld, dout + b * st.b[4] + q0 * st.s[4] + hd, st.s[4], q_rows, vec);
  __syncthreads();
  // delta = rowsum(dO * O) in float32, written out for the dK/dV kernel
  for (int r = r0; r < r0 + kRows; ++r) {
    float x = 0.f;
    if (r < q_rows) {
      const bf16* orow = o + b * st.b[3] + (q0 + r) * st.s[3] + hd;
      for (int d = lane; d < D; d += 32) x += to_f32(dOs[r * ld + d]) * to_f32(orow[d]);
    }
    x = warp_sum(x);
    if (lane == 0) {
      row_delta[r] = x;
      if (r < q_rows) delta[row0 + r] = x;
    }
  }
  __syncwarp();
  float rm[2], rl[2], rd[2];  // statistics of rows g and g + 8
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    row_ok[i] = r < q_rows;
    rm[i] = row_ok[i] ? stats[row0 + r] : 0.f;
    rl[i] = row_ok[i] ? stats[bhs + row0 + r] : 0.f;
    rd[i] = row_delta[r];
  }

  float acc[D / 8][4] = {};
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int k_rows = min(kTile, S - k0);
    __syncthreads();
    load_tile<bf16, D>(Ks, ld, k + b * st.b[1] + k0 * st.s[1] + hd, st.s[1], k_rows, vec);
    load_tile<bf16, D>(Vs, ld, v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2], k_rows, vec);
    load_kmask(kmask, mask, b, S, k0, k_rows, 0.f);
    __syncthreads();
    if (r0 >= q_rows) continue;  // this warp's rows are all past S

    float s[8][4], dp[8][4];
    // full tiles here: skipping the padded columns measured slower in the
    // backward (it did speed the forward up)
    mm_abt<D>(s, Qs + r0 * ld, Ks, ld, kTile, g, t);    // S
    mm_abt<D>(dp, dOs + r0 * ld, Vs, ld, kTile, g, t);  // dP
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), i = e / 2;
        const float p = (row_ok[i] && col < k_rows)
                            ? expf(s[j][e] + kmask[col] - rm[i] - rl[i]) : 0.f;
        s[j][e] = p * (dp[j][e] - rd[i]);  // dS
      }
    }
    mm_pm<D>(acc, s, Ks, ld, kTile, g, t);  // dQ += dS K
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + b * st.b[5] + q0 * st.s[5] + hd, st.s[5], r0, q_rows, acc, one, g, t);
}

// dK and dV, one block per key tile; a warp's tiles are transposed: rows are
// keys, columns queries. Tensor order in st: q, k, v, o, dO, dq, dk, dv.
template <int D>
__global__ void __launch_bounds__(kThreads) mha_bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, const bf16* __restrict__ dout,
    const float* __restrict__ stats, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, Strides st, bool vec) {
  constexpr int ld = Bf16Tiles<D>::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kTile * ld;
  bf16* Qs = Vs + kTile * ld;
  bf16* dOs = Qs + kTile * ld;
  float* col_m = reinterpret_cast<float*>(dOs + kTile * ld);  // the query tile's statistics
  float* col_logl = col_m + kTile;
  float* col_delta = col_logl + kTile;
  float* kmask = col_delta + kTile;  // this block's keys

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int k_rows = min(kTile, S - k0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(h) * D;
  const long long bhs = static_cast<long long>(gridDim.z) * H * S;
  const long long bh = (static_cast<long long>(b) * H + h) * S;

  load_tile<bf16, D>(Ks, ld, k + b * st.b[1] + k0 * st.s[1] + hd, st.s[1], k_rows, vec);
  load_tile<bf16, D>(Vs, ld, v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2], k_rows, vec);
  load_kmask(kmask, mask, b, S, k0, k_rows, 0.f);
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key_ok[i] = r0 + g + 8 * i < k_rows;

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int q0 = 0; q0 < S; q0 += kTile) {
    const int q_rows = min(kTile, S - q0);
    __syncthreads();
    load_tile<bf16, D>(Qs, ld, q + b * st.b[0] + q0 * st.s[0] + hd, st.s[0], q_rows, vec);
    load_tile<bf16, D>(dOs, ld, dout + b * st.b[4] + q0 * st.s[4] + hd, st.s[4], q_rows, vec);
    if (threadIdx.x < kTile) {
      const int c = threadIdx.x;
      const bool ok = c < q_rows;
      col_m[c] = ok ? stats[bh + q0 + c] : 0.f;
      col_logl[c] = ok ? stats[bhs + bh + q0 + c] : 0.f;
      col_delta[c] = ok ? delta[bh + q0 + c] : 0.f;
    }
    __syncthreads();
    if (r0 >= k_rows) continue;  // this warp's keys are all past S

    float p[8][4], ds[8][4];
    mm_abt<D>(p, Ks + r0 * ld, Qs, ld, kTile, g, t);    // S^T, full tiles as in dq
    mm_abt<D>(ds, Vs + r0 * ld, dOs, ld, kTile, g, t);  // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), i = e / 2;
        const float pe = (key_ok[i] && col < q_rows)
            ? expf(p[j][e] + kmask[r0 + g + 8 * i] - col_m[col] - col_logl[col]) : 0.f;
        p[j][e] = pe;
        ds[j][e] = pe * (ds[j][e] - col_delta[col]);
      }
    }
    mm_pm<D>(dv_acc, p, dOs, ld, kTile, g, t);  // dV += P^T dO
    mm_pm<D>(dk_acc, ds, Qs, ld, kTile, g, t);  // dK += dS^T Q
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + b * st.b[6] + k0 * st.s[6] + hd, st.s[6], r0, k_rows, dk_acc, one, g, t);
  store_rows<D>(dv + b * st.b[7] + k0 * st.s[7] + hd, st.s[7], r0, k_rows, dv_acc, one, g, t);
}

// ============================================================ float32: FMAs
//
// The same tiling on float32 shared-memory tiles; a warp's products are plain
// loops (lanes across columns), its logits and results go through shared memory.

template <int D>
struct F32Tiles {
  static constexpr int kIn = D + 4;      // 64 x D (q, k, v, dO)
  static constexpr int kS = kTile + 4;   // 64 x 64 (S, P, dP, dS)
  static constexpr int kO = D + 4;       // 64 x D (O, results)
  static constexpr int kInBytes = kTile * kIn * 4;
  static constexpr int kSBytes = kTile * kS * 4;
  static constexpr int kOBytes = kTile * kO * 4;
  // the backward writes its results through the S and dP buffers
  static_assert(kOBytes <= 2 * kSBytes, "result tile fits the S and dP buffers");
};

template <int D>
__global__ void __launch_bounds__(kThreads) mha_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ out, float* __restrict__ stats,
    int S, int H, Strides st, bool vec) {
  using L = F32Tiles<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kTile * L::kIn;
  float* Vs = Ks + kTile * L::kIn;
  float* Ps = Vs + kTile * L::kIn;
  float* Ss = Ps + kTile * L::kS;
  float* Os = Ss + kTile * L::kS;
  float* row_m = Os + kTile * L::kO;  // running max of each query row
  float* row_l = row_m + kTile;       // running sum of each query row
  float* kmask = row_l + kTile;       // the key tile's additive mask

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int q_rows = min(kTile, S - q0);
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(h) * D;

  load_tile<float, D>(Qs, L::kIn, q + b * st.b[0] + q0 * st.s[0] + hd, st.s[0], q_rows, vec);
  for (int i = threadIdx.x; i < kTile * L::kO; i += kThreads) Os[i] = 0.f;
  if (threadIdx.x < kTile) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int k_rows = min(kTile, S - k0);
    __syncthreads();
    load_tile<float, D>(Ks, L::kIn, k + b * st.b[1] + k0 * st.s[1] + hd, st.s[1], k_rows, vec);
    load_tile<float, D>(Vs, L::kIn, v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2], k_rows, vec);
    load_kmask(kmask, mask, b, S, k0, k_rows, -INFINITY);
    __syncthreads();

    f32_abt<D>(Ss + r0 * L::kS, L::kS, Qs + r0 * L::kIn, L::kIn, Ks, L::kIn);
    __syncwarp();
    // online softmax, one row at a time, lanes across the 64 keys
    for (int r = r0; r < r0 + kRows; ++r) {
      float s[2];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        s[c] = Ss[r * L::kS + col] + kmask[col];
        mx = fmaxf(mx, s[c]);
      }
      mx = warp_max(mx);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(s[c] - m_new);
        sum += p;
        Ps[r * L::kS + lane + 32 * c] = p;
      }
      sum = warp_sum(sum);
      const float alpha = expf(m_old - m_new);
      for (int d = lane; d < D; d += 32) Os[r * L::kO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
      }
    }
    __syncwarp();
    F32Acc<D> acc;
    acc.load(Os + r0 * L::kO, L::kO);
    acc.mma(Ps + r0 * L::kS, L::kS, Vs, L::kIn);
    acc.store(Os + r0 * L::kO, L::kO);
  }
  __syncwarp();

  const long long bhs = static_cast<long long>(gridDim.z) * H * S;
  for (int r = r0; r < r0 + kRows && r < q_rows; ++r) {
    const float l = row_l[r];
    float* dst = out + b * st.b[3] + (q0 + r) * st.s[3] + hd;
    for (int d = lane; d < D; d += 32) dst[d] = Os[r * L::kO + d] / l;
    if (lane == 0) {
      const long long i = (static_cast<long long>(b) * H + h) * S + q0 + r;
      stats[i] = row_m[r];
      stats[bhs + i] = logf(l);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) mha_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ o, const float* __restrict__ dout,
    const float* __restrict__ stats, float* __restrict__ delta, float* __restrict__ dq,
    int S, int H, Strides st, bool vec) {
  using L = F32Tiles<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kTile * L::kIn;
  float* Ks = dOs + kTile * L::kIn;
  float* Vs = Ks + kTile * L::kIn;
  float* Ss = Vs + kTile * L::kIn;  // P, then dS
  float* DPs = Ss + kTile * L::kS;
  float* row_m = DPs + kTile * L::kS;
  float* row_logl = row_m + kTile;
  float* row_delta = row_logl + kTile;
  float* kmask = row_delta + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;
  const int q_rows = min(kTile, S - q0);
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(h) * D;
  const long long bhs = static_cast<long long>(gridDim.z) * H * S;
  const long long row0 = (static_cast<long long>(b) * H + h) * S + q0;

  load_tile<float, D>(Qs, L::kIn, q + b * st.b[0] + q0 * st.s[0] + hd, st.s[0], q_rows, vec);
  load_tile<float, D>(dOs, L::kIn, dout + b * st.b[4] + q0 * st.s[4] + hd, st.s[4], q_rows, vec);
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    row_m[r] = r < q_rows ? stats[row0 + r] : 0.f;
    row_logl[r] = r < q_rows ? stats[bhs + row0 + r] : 0.f;
  }
  __syncthreads();
  for (int r = r0; r < r0 + kRows; ++r) {
    float x = 0.f;
    if (r < q_rows) {
      const float* orow = o + b * st.b[3] + (q0 + r) * st.s[3] + hd;
      for (int d = lane; d < D; d += 32) x += dOs[r * L::kIn + d] * orow[d];
    }
    x = warp_sum(x);
    if (lane == 0) {
      row_delta[r] = x;
      if (r < q_rows) delta[row0 + r] = x;
    }
  }

  F32Acc<D> acc;
  acc.zero();
  for (int k0 = 0; k0 < S; k0 += kTile) {
    const int k_rows = min(kTile, S - k0);
    __syncthreads();
    load_tile<float, D>(Ks, L::kIn, k + b * st.b[1] + k0 * st.s[1] + hd, st.s[1], k_rows, vec);
    load_tile<float, D>(Vs, L::kIn, v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2], k_rows, vec);
    load_kmask(kmask, mask, b, S, k0, k_rows, 0.f);
    __syncthreads();

    f32_abt<D>(Ss + r0 * L::kS, L::kS, Qs + r0 * L::kIn, L::kIn, Ks, L::kIn);    // S
    f32_abt<D>(DPs + r0 * L::kS, L::kS, dOs + r0 * L::kIn, L::kIn, Vs, L::kIn);  // dP
    __syncwarp();
    for (int r = r0; r < r0 + kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        float ds = 0.f;
        if (r < q_rows && col < k_rows) {
          const float p = expf(Ss[r * L::kS + col] + kmask[col] - row_m[r] - row_logl[r]);
          ds = p * (DPs[r * L::kS + col] - row_delta[r]);
        }
        Ss[r * L::kS + col] = ds;
      }
    }
    __syncwarp();
    acc.mma(Ss + r0 * L::kS, L::kS, Ks, L::kIn);  // dQ += dS K
  }

  __syncthreads();  // the result tile overlays S and dP, which other warps read
  float* Rs = Ss;
  acc.store(Rs + r0 * L::kO, L::kO);
  __syncwarp();
  for (int r = r0; r < r0 + kRows && r < q_rows; ++r) {
    float* dst = dq + b * st.b[5] + (q0 + r) * st.s[5] + hd;
    for (int d = lane; d < D; d += 32) dst[d] = Rs[r * L::kO + d];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) mha_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ dout,
    const float* __restrict__ stats, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int H, Strides st, bool vec) {
  using L = F32Tiles<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kTile * L::kIn;
  float* Qs = Vs + kTile * L::kIn;
  float* dOs = Qs + kTile * L::kIn;
  float* PTs = dOs + kTile * L::kIn;  // P^T
  float* DPTs = PTs + kTile * L::kS;  // dP^T, then dS^T
  float* col_m = DPTs + kTile * L::kS;
  float* col_logl = col_m + kTile;
  float* col_delta = col_logl + kTile;
  float* kmask = col_delta + kTile;

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kTile;
  const int k_rows = min(kTile, S - k0);
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(h) * D;
  const long long bhs = static_cast<long long>(gridDim.z) * H * S;
  const long long bh = (static_cast<long long>(b) * H + h) * S;

  load_tile<float, D>(Ks, L::kIn, k + b * st.b[1] + k0 * st.s[1] + hd, st.s[1], k_rows, vec);
  load_tile<float, D>(Vs, L::kIn, v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2], k_rows, vec);
  load_kmask(kmask, mask, b, S, k0, k_rows, 0.f);

  F32Acc<D> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int q0 = 0; q0 < S; q0 += kTile) {
    const int q_rows = min(kTile, S - q0);
    __syncthreads();
    load_tile<float, D>(Qs, L::kIn, q + b * st.b[0] + q0 * st.s[0] + hd, st.s[0], q_rows, vec);
    load_tile<float, D>(dOs, L::kIn, dout + b * st.b[4] + q0 * st.s[4] + hd, st.s[4], q_rows,
                        vec);
    if (threadIdx.x < kTile) {
      const int c = threadIdx.x;
      const bool ok = c < q_rows;
      col_m[c] = ok ? stats[bh + q0 + c] : 0.f;
      col_logl[c] = ok ? stats[bhs + bh + q0 + c] : 0.f;
      col_delta[c] = ok ? delta[bh + q0 + c] : 0.f;
    }
    __syncthreads();

    f32_abt<D>(PTs + r0 * L::kS, L::kS, Ks + r0 * L::kIn, L::kIn, Qs, L::kIn);    // S^T
    f32_abt<D>(DPTs + r0 * L::kS, L::kS, Vs + r0 * L::kIn, L::kIn, dOs, L::kIn);  // dP^T
    __syncwarp();
    for (int r = r0; r < r0 + kRows; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        float p = 0.f, ds = 0.f;
        if (r < k_rows && col < q_rows) {
          p = expf(PTs[r * L::kS + col] + kmask[r] - col_m[col] - col_logl[col]);
          ds = p * (DPTs[r * L::kS + col] - col_delta[col]);
        }
        PTs[r * L::kS + col] = p;
        DPTs[r * L::kS + col] = ds;
      }
    }
    __syncwarp();
    dv_acc.mma(PTs + r0 * L::kS, L::kS, dOs, L::kIn);   // dV += P^T dO
    dk_acc.mma(DPTs + r0 * L::kS, L::kS, Qs, L::kIn);   // dK += dS^T Q
  }

  __syncthreads();  // the result tile overlays P^T and dP^T, which other warps read
  float* Rs = PTs;
  dk_acc.store(Rs + r0 * L::kO, L::kO);
  __syncwarp();
  for (int r = r0; r < r0 + kRows && r < k_rows; ++r) {
    float* dst = dk + b * st.b[6] + (k0 + r) * st.s[6] + hd;
    for (int d = lane; d < D; d += 32) dst[d] = Rs[r * L::kO + d];
  }
  __syncwarp();
  dv_acc.store(Rs + r0 * L::kO, L::kO);
  __syncwarp();
  for (int r = r0; r < r0 + kRows && r < k_rows; ++r) {
    float* dst = dv + b * st.b[7] + (k0 + r) * st.s[7] + hd;
    for (int d = lane; d < D; d += 32) dst[d] = Rs[r * L::kO + d];
  }
}

// ------------------------------------------------------------------ launch

// Shared memory of each kernel, in bytes.
template <typename T, int D>
struct Smem;
template <int D>
struct Smem<bf16, D> {
  static constexpr int kFwd = 3 * Bf16Tiles<D>::kBytes + kTile * 4;
  static constexpr int kBwd = 4 * Bf16Tiles<D>::kBytes + 4 * kTile * 4;
};
template <int D>
struct Smem<float, D> {
  using L = F32Tiles<D>;
  static constexpr int kFwd = 3 * L::kInBytes + 2 * L::kSBytes + L::kOBytes + 3 * kTile * 4;
  static constexpr int kBwd = 4 * L::kInBytes + 2 * L::kSBytes + 4 * kTile * 4;
};

template <typename T, int D>
struct Kernels;
template <int D>
struct Kernels<bf16, D> {
  static constexpr auto fwd = mha_fwd_bf16_kernel<D>;
  static constexpr auto dq = mha_bwd_dq_bf16_kernel<D>;
  static constexpr auto dkdv = mha_bwd_dkdv_bf16_kernel<D>;
};
template <int D>
struct Kernels<float, D> {
  static constexpr auto fwd = mha_fwd_f32_kernel<D>;
  static constexpr auto dq = mha_bwd_dq_f32_kernel<D>;
  static constexpr auto dkdv = mha_bwd_dkdv_f32_kernel<D>;
};

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* mask, void* out,
               float* stats, int B, int S, int H, const long long* strides,
               cudaStream_t stream) {
  const Strides st = read_strides(strides, 4);
  const void* ptrs[4] = {q, k, v, out};
  const bool vec = aligned<T>(ptrs, st, 4);
  constexpr int smem = Smem<T, D>::kFwd;
  cudaError_t err = cudaFuncSetAttribute(Kernels<T, D>::fwd,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const auto fwd = Kernels<T, D>::fwd;
  fwd<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<T*>(out), stats, S, H, st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const float* mask,
               const void* o, const void* dout, const float* stats, float* delta, void* dq,
               void* dk, void* dv, int B, int S, int H, const long long* strides,
               cudaStream_t stream) {
  const Strides st = read_strides(strides, 8);
  const void* ptrs[8] = {q, k, v, o, dout, dq, dk, dv};
  const bool vec = aligned<T>(ptrs, st, 8);
  constexpr int smem = Smem<T, D>::kBwd;
  cudaError_t err = cudaFuncSetAttribute(Kernels<T, D>::dq,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(Kernels<T, D>::dkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  // delta is written by the first kernel and read by the second, in stream order
  const auto dq_kernel = Kernels<T, D>::dq;
  const auto dkdv_kernel = Kernels<T, D>::dkdv;
  dq_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(o), static_cast<const T*>(dout), stats, delta,
      static_cast<T*>(dq), S, H, st, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
      static_cast<const T*>(dout), stats, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      S, H, st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(int D, const void* q, const void* k, const void* v, const float* mask,
                 void* out, float* stats, int B, int S, int H, const long long* strides,
                 cudaStream_t st) {
  switch (D) {
    case 16: return launch_fwd<T, 16>(q, k, v, mask, out, stats, B, S, H, strides, st);
    case 32: return launch_fwd<T, 32>(q, k, v, mask, out, stats, B, S, H, strides, st);
    case 64: return launch_fwd<T, 64>(q, k, v, mask, out, stats, B, S, H, strides, st);
    case 128: return launch_fwd<T, 128>(q, k, v, mask, out, stats, B, S, H, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_bwd(int D, const void* q, const void* k, const void* v, const float* mask,
                 const void* o, const void* dout, const float* stats, float* delta,
                 void* dq, void* dk, void* dv, int B, int S, int H,
                 const long long* strides, cudaStream_t st) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv, B, S, H, strides, st);
    case 32: return launch_bwd<T, 32>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv, B, S, H, strides, st);
    case 64: return launch_bwd<T, 64>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv, B, S, H, strides, st);
    case 128: return launch_bwd<T, 128>(q, k, v, mask, o, dout, stats, delta, dq, dk, dv, B, S, H, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// strides: (batch, token) pairs in elements, one pair per tensor in the order
// of the tensor arguments. stats is (2, B, H, S) float32: row max, then log of
// the row sum. Launch on `stream` without synchronising; return cudaError_t.
extern "C" int mha_attention_forward(const void* q, const void* k, const void* v,
                                     const void* mask, void* out, void* stats, int B,
                                     int S, int H, int D, const long long* strides,
                                     int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  float* s = static_cast<float*>(stats);
  if (dtype == 1) return dispatch_fwd<bf16>(D, q, k, v, m, out, s, B, S, H, strides, st);
  if (dtype == 0) return dispatch_fwd<float>(D, q, k, v, m, out, s, B, S, H, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta is (B, H, S) float32 scratch. strides order: q, k, v, o, dout, dq, dk, dv.
extern "C" int mha_attention_backward(const void* q, const void* k, const void* v,
                                      const void* mask, const void* o, const void* dout,
                                      const void* stats, void* delta, void* dq, void* dk,
                                      void* dv, int B, int S, int H, int D,
                                      const long long* strides, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  const float* s = static_cast<const float*>(stats);
  float* dl = static_cast<float*>(delta);
  if (dtype == 1)
    return dispatch_bwd<bf16>(D, q, k, v, m, o, dout, s, dl, dq, dk, dv, B, S, H, strides, st);
  if (dtype == 0)
    return dispatch_bwd<float>(D, q, k, v, m, o, dout, s, dl, dq, dk, dv, B, S, H, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
