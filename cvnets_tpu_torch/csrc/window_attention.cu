// Swin window attention with an additive bias, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cvnets_tpu/ops/pallas/window_attn.py:
//   _pallas_fwd (:279, body _fwd_kernel :205)  -> window_attention_forward
//   _pallas_bwd (:300, body _bwd_kernel :224)  -> window_attention_backward
// q, k and v are (B*nW, S, H*D) in the layer's projection layout (windows of
// one image consecutive, q already scaled); head h is the column range
// [h*D, (h+1)*D), and each tensor is a pointer with a window stride and a token
// stride, so q, k and v may be column thirds of one qkv tensor. The logits of
// head h in window w get bias[h] (the gathered relative-position table,
// (H, S, S) float32) plus, for shifted windows, mask[w % nW] (the shift mask,
// (nW, S, S) float32, -100 where two tokens come from different regions; null
// when unshifted). Both are finite: the float32 kernels keep a weight of e^-100
// in the softmax exactly as the einsum reference does; the bf16 kernels'
// ex2.approx.ftz, forward and backward, flushes such a weight (3.7e-44, under
// float32's 2^-126) to 0, far under every tolerance, as rounding P to bf16 for
// the tensor cores would leave it.
//
// Design. A window has S = ws^2 = 49 tokens at Swin's window 7: one tile of 64
// rows padded with zeros (S <= 64 is what these kernels take). The TPU kernels
// pack several windows into one tile and softmax a band of it to fill the
// 128-wide lanes; on Hopper a lone window pads to 64 rows for mma.sync instead,
// and the packing and the banded softmax are left out. A block is four warps,
// each owning 16 query rows of the tile, and it owns one head h and one window
// position p and loops over a chunk of images: windows b*nW + p for b in its
// chunk. So the bias (bias[h] + mask[p], keys past S at -inf) is gathered
// once per block, and the block's share of dbias stays in registers across its
// windows.
//   * forward: per window, S = Q K^T + bias, a whole-row softmax (every key of
//     the window is in the tile, so no online rescaling), O = P V / l.
//   * backward: per window, the forward's P is recomputed and dP = dO V^T;
//     delta = rowsum(P * dP) (equal to rowsum(dO * O), without reading O);
//     dS = P (dP - delta); dQ = dS K from the warp's own rows; then P and dS go
//     through shared memory so that each warp takes 16 keys for dV = P^T dO
//     and dK = dS^T Q: 5 products a window, none recomputed.
//   * dbias = sum of dS over every window of every image (the mask takes no
//     gradient). Without atomics: each block writes its chunk's sum as one
//     partial (chunk, position, head, S, S) float32, and a second kernel sums
//     the partials of each element in a fixed order, so dbias is the same bit
//     for bit on every run with the same shapes.
// bfloat16 (the training path): every product on the tensor cores through
// mma.sync m16n8k16 with float32 accumulators; P and dS are rounded to bf16 for
// their products. float32: FMAs on shared-memory tiles (no TF32), for float32
// evaluation. Softmax, bias, delta and every accumulator are float32 on both.
//
// What bounds them: per window and head, 4 S^2 D ~ 0.3 MFLOP forward on
// 3 S D 2 ~ 9.4 KB of bf16 inputs, ~33 flop per byte, far under the H100's
// ridge (~295): HBM bytes bound both kernels, the backward at 7 (B*nW, S, H*D)
// tensors moved once, 0.766 ms a Swin-T step at 3.35 TB/s. The padding of 49
// rows and keys to 64 costs products (and one warp of four works on a single
// row), not bytes. The first backward (3.33 ms a step; NVIDIA H100 80GB HBM3,
// 700.00 W, cvnets_tpu_torch/tools/time_window_backward.py, every step below
// timed in one process) was bound by latency: four blocks of four warps an SM,
// each loading its window through registers between two barriers with nothing
// in flight while it computed, fragments built by 32- and 16-bit loads, expf.
// The bf16 backward now, step by step (ms a Swin-T step, 12 launches):
//   1. The next window's Q, K, V and dO are copied by 16-byte cp.async into a
//      second stage while this window computes (zero fill past S through the
//      src-size operand, so every refill zeroes the padded rows again; no copy
//      past the chunk's last image; loaded through registers when a stride is
//      not 16-byte aligned). One barrier opens each window, a second one
//      publishes P and dS. Two stages cost 20 KB more: with the bias tile in
//      shared memory that leaves two blocks an SM (2.84); with it in
//      registers, three (2.37).
//   2. Every fragment by ldmatrix.x4 on the D + 8 pitch: S = Q K^T and
//      dP = dO V^T (mm_abt_ldsm), dQ = dS K (mm_pm_ldsm), and dV, dK from P and
//      dS stored row-major by 32-bit stores and read back transposed by
//      ldmatrix.trans (mm_atm_ldsm), where P^T and dS^T took 16-bit stores and
//      pairs of 16-bit loads: 2.05.
//   3. exp2 on the SFU, log2 e folded into the bias once a block, so a logit
//      is one FMA and one ex2: 1.90. The bias fragments then move from
//      registers (168 under __launch_bounds__'s three blocks an SM, 20-80
//      bytes spilled) to shared memory in each lane's fragment order (16 KB,
//      no padding; three blocks an SM still, 164 registers): 1.80.
//   4. The wrapper gives a block the fewest images that fit the launch into
//      one wave (ops/window_attention.py _bwd_chunk: 384 blocks at every
//      Swin-T stage, where the forward's chunk rule gave 576 to 1,536), so each
//      block's bias gather, first copy and partial dbias serve 8-64 windows:
//      1.62, 2.1 times the bound (1.49 by chip_smoke.py's timing).
// What it leaves: 15 padded rows of 64 in every product, a one-window
// prefetch (a third stage would cost a block an SM), and the partials' write
// and second pass.
// The bf16 forward had the same first design (1.50 ms a step, 3.4 times its
// bound of 4 tensors moved once, 0.438 ms; the same timer with --forward, the
// same card) and took the same steps, each timed against the parent in one
// process:
//   1. The next window's Q, K and V by cp.async into a second stage, one
//      barrier a window (the float bias tile, expf and the scalar fragment
//      loads kept; 49 KB a block at D = 32): 1.23.
//   2. Every fragment by ldmatrix (mm_abt_ldsm, mm_pm_ldsm): 1.10.
//   3. exp2 with log2 e folded into the bias, the bias in shared memory in
//      fragment order (store_bias_frag, softmax_rows_exp2; the 18 KB float tile
//      and its element-by-element gather go, 46 KB a block): 0.93.
//   4. The fewest images a block that fit the launch into one wave
//      (ops/window_attention.py _fwd_chunk: 384 to 528 blocks, where _chunk
//      gave 576 to 1,536), __launch_bounds__ holding four blocks an SM (three
//      at D = 64, as the shared memory allows; 128 registers at D = 32, no
//      spill): 0.85, 1.9 times the bound (0.71 of device time a Swin-T step
//      by torch.profiler in chip_smoke.py, 1.6 times).
// Storing O through the warp's own Q rows for 16-byte stores moved it by
// -1.4% (0.8805 -> 0.8682, inside the noise of the timer) and was left out.
// What it leaves: the same 15 padded rows; at Swin-T's stage 1 one wave holds
// 384 blocks of 528 slots (two blocks a position and head).

#include "attention_tiles.cuh"

namespace {

constexpr int kBiasLd = kTile + 8;  // float32 bias tile of the float32 kernels
constexpr int kTLd = kTile + 8;     // bf16 P and dS tiles of the backward
constexpr int kSLd = kTile + 4;     // float32 logit tiles

// Which head, window position and chunk of images this block owns.
struct WinBlock {
  int h, p, c;
};

__device__ __forceinline__ WinBlock win_block(int H, int nW) {
  const int i = blockIdx.x;
  return {i % H, (i / H) % nW, i / (H * nW)};
}

// bias[h] + mask[p] into a 64 x 64 tile: keys past S at -inf (probability 0
// exactly), query rows past S at 0 (finite, never written out).
__device__ void load_bias(float* Bs, const float* bias, const float* mask, int S, int h,
                          int p) {
  const long long ss = static_cast<long long>(S) * S;
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    float x = -INFINITY;
    if (c < S) {
      x = 0.f;
      if (r < S) {
        x = bias[h * ss + r * S + c];
        if (mask != nullptr) x += mask[p * ss + r * S + c];
      }
    }
    Bs[r * kBiasLd + c] = x;
  }
}

// acc (16 x D) += A^T . M by ldmatrix.trans on both operands. At is a 64 x 16
// column slice of a row-major bf16 tile (pitch lda; A's rows are its columns),
// M is 64 x D, row-major (pitch ld): dV = P^T dO and dK = dS^T Q from P and dS
// as the first half of the backward wrote them, rows queries. The 16-wide
// steps from k_valid on (queries past S, whose dO, Q and dS rows are 0) are
// skipped.
template <int D>
__device__ __forceinline__ void mm_atm_ldsm(float (&acc)[D / 8][4], const bf16* At, int lda,
                                            const bf16* M, int ld, int lane, int k_valid) {
  // A's matrices (rows 0-7, 8-15) x (cols 0-7, 8-15) are At's (rows 0-7, cols
  // 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 0-7), (rows 8-15, cols 8-15)
  // transposed
  const bf16* a_src = At + ((lane / 16) * 8 + lane % 8) * lda + ((lane / 8) % 2) * 8;
  const bf16* m_src = M + (lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    if (16 * kk >= k_valid) break;
    uint32_t a[4];
    ldsm_x4_trans(a, a_src + 16 * kk * lda);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4_trans(b, m_src + 16 * kk * ld + 8 * j);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma(acc[j], a, b0);
      mma(acc[j + 1], a, b1);
    }
  }
}

// ============================================================ bfloat16: mma.sync

// (bias[h] + mask[p]) * log2 e in the C-fragment order of one lane: frag[32 j]
// holds element e of c[j] as component e (rows r0 + g + 8 (e / 2), columns
// 8j + 2t + e % 2), keys past S at -inf, query rows past S at 0. Gathered once
// a block from device memory into shared memory (in registers, beside dsum, it
// left the kernel spilling at the 168 registers of three blocks an SM). Each
// lane writes and reads only its own 8 float4, 32 lanes side by side, so the
// 16-byte accesses are free of bank conflicts and need no barrier.
__device__ __forceinline__ void store_bias_frag(float4* frag, const float* bias,
                                                const float* mask, int S, int h, int p, int r0,
                                                int g, int t) {
  const long long ss = static_cast<long long>(S) * S;
  const float* bh = bias + h * ss;
  const float* mp = mask == nullptr ? nullptr : mask + p * ss;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float b2[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e / 2), col = 8 * j + 2 * t + (e & 1);
      float x = -INFINITY;
      if (col < S) {
        x = 0.f;
        if (row < S) {
          x = bh[row * S + col];
          if (mp != nullptr) x += mp[row * S + col];
        }
      }
      b2[e] = x * kLog2e;
    }
    frag[32 * j] = make_float4(b2[0], b2[1], b2[2], b2[3]);
  }
}

// In place: s (16 x 64 logits in C fragments) -> softmax rows, with the bias
// in log2 units (store_bias_frag): 2^(s log2 e + b2 - max), one FMA and one
// ex2 a logit.
__device__ __forceinline__ void softmax_rows_exp2(float (&s)[8][4], const float4* frag) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 b = frag[32 * j];
    const float b2[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fmaf(s[j][e], kLog2e, b2[e]);
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  }
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fast_exp2(s[j][e] - mx[e / 2]);  // +0 for keys past S (-inf)
      l[e / 2] += s[j][e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / l[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= l[e / 2];
  }
}

template <int D>
struct WinFwdBf16 {
  static constexpr int kLd = Bf16Tiles<D>::kLd;
  static constexpr int kStage = 3 * kTile * kLd;  // elements of Q, K and V of one window
  // two stages and the bias fragments: 46 KB at D = 32, so four blocks an SM
  // (228 KB), as many as the registers of __launch_bounds__ allow
  static constexpr int kSmem = 2 * kStage * 2 + kThreads * 32 * 4;
  static constexpr int kMinBlocks = D == 64 ? 3 : 4;
};

// Tensor order in st: q, k, v, out.
template <int D>
__global__ void __launch_bounds__(kThreads, WinFwdBf16<D>::kMinBlocks) win_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, bf16* __restrict__ out,
    int S, int H, int nW, int n_img, int chunk, Strides st, bool vec) {
  using L = WinFwdBf16<D>;
  constexpr int ld = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // two of: Q, K, V

  const WinBlock wb = win_block(H, nW);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(wb.h) * D;
  const float one[2] = {1.f, 1.f};
  float4* b2 = reinterpret_cast<float4*>(stages + 2 * L::kStage) + threadIdx.x / 32 * 8 * 32 + lane;
  if (r0 < S) store_bias_frag(b2, bias, mask, S, wb.h, wb.p, r0, g, t);

  // Q, K and V of image b's window into a stage, zero-filled past S, as one
  // cp.async group
  const auto fetch = [&](int b, bf16* dst) {
    const long long w = static_cast<long long>(b) * nW + wb.p;
    const bf16* src[3] = {q + w * st.b[0], k + w * st.b[1], v + w * st.b[2]};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      load_rows_async<D, kTile, kThreads>(dst + i * kTile * ld, ld, src[i] + hd, st.s[i], S,
                                          vec);
    cp_async_commit();
  };
  const int b_first = wb.c * chunk, b_end = min(n_img, b_first + chunk);
  fetch(b_first, stages);
  for (int b = b_first; b < b_end; ++b) {
    const bf16* Qs = stages + ((b - b_first) & 1) * L::kStage;
    const bf16* Ks = Qs + kTile * ld;
    const bf16* Vs = Ks + kTile * ld;
    cp_async_wait<0>();
    __syncthreads();  // window b's tiles are in; window b - 1 is done with the other stage
    if (b + 1 < b_end) fetch(b + 1, stages + ((b + 1 - b_first) & 1) * L::kStage);
    if (r0 >= S) continue;  // this warp's rows are all past S

    float s[8][4];
    mm_abt_ldsm<D>(s, Qs + r0 * ld, Ks, ld, lane);  // keys past S: 0, then -inf from b2
    softmax_rows_exp2(s, b2);
    float o[D / 8][4] = {};
    mm_pm_ldsm<D>(o, s, Vs, ld, lane, S);
    const long long w = static_cast<long long>(b) * nW + wb.p;
    store_rows<D>(out + w * st.b[3] + hd, st.s[3], r0, S, o, one, g, t);
  }
}

// Write a warp's 16 x 64 tile (C fragments) to rows r0.. of a row-major bf16
// tile of pitch kTLd, two columns a 32-bit store.
__device__ __forceinline__ void store_frag_rows(bf16* dst, const float (&x)[8][4], int r0, int g,
                                                int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8 * i) * kTLd + 8 * j + 2 * t) =
          pack_bf16(x[j][2 * i], x[j][2 * i + 1]);
  }
}

template <int D>
struct WinBwdBf16 {
  static constexpr int kLd = Bf16Tiles<D>::kLd;
  static constexpr int kStage = 4 * kTile * kLd;  // elements of Q, K, V and dO of one window
  // two stages, the P and dS tiles and the bias fragments: 74 KB at D = 32, so
  // three blocks an SM (228 KB), as many as the 168 registers of
  // __launch_bounds__ allow
  static constexpr int kSmem = 2 * kStage * 2 + 2 * kTile * kTLd * 2 + kThreads * 32 * 4;
  static constexpr int kMinBlocks = D == 64 ? 2 : 3;
};

// Tensor order in st: q, k, v, dO, dq, dk, dv. partial is (chunks, nW, H, S, S).
template <int D>
__global__ void __launch_bounds__(kThreads, WinBwdBf16<D>::kMinBlocks) win_bwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ partial, int S, int H, int nW, int n_img,
    int chunk, Strides st, bool vec) {
  using L = WinBwdBf16<D>;
  constexpr int ld = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // two of: Q, K, V, dO
  bf16* Ps = stages + 2 * L::kStage;             // P, rows queries, columns keys
  bf16* dSs = Ps + kTile * kTLd;                 // dS, the same

  const WinBlock wb = win_block(H, nW);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(wb.h) * D;
  const float one[2] = {1.f, 1.f};
  float4* b2 = reinterpret_cast<float4*>(dSs + kTile * kTLd) + threadIdx.x / 32 * 8 * 32 + lane;
  store_bias_frag(b2, bias, mask, S, wb.h, wb.p, r0, g, t);
  float dsum[8][4] = {};  // this block's sum of dS, in the warp's C fragments

  // Q, K, V and dO of image b's window into a stage, zero-filled past S (so
  // every refill zeroes the padded rows again: dO's must be 0 for dS to
  // vanish there), as one cp.async group
  const auto fetch = [&](int b, bf16* dst) {
    const long long w = static_cast<long long>(b) * nW + wb.p;
    const bf16* src[4] = {q + w * st.b[0], k + w * st.b[1], v + w * st.b[2],
                          dout + w * st.b[3]};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_rows_async<D, kTile, kThreads>(dst + i * kTile * ld, ld, src[i] + hd, st.s[i], S,
                                          vec);
    cp_async_commit();
  };
  const int b_first = wb.c * chunk, b_end = min(n_img, b_first + chunk);
  fetch(b_first, stages);
  for (int b = b_first; b < b_end; ++b) {
    const bf16* Qs = stages + ((b - b_first) & 1) * L::kStage;
    const bf16* Ks = Qs + kTile * ld;
    const bf16* Vs = Ks + kTile * ld;
    const bf16* dOs = Vs + kTile * ld;
    const long long w = static_cast<long long>(b) * nW + wb.p;
    cp_async_wait<0>();
    __syncthreads();  // window b's tiles are in; window b - 1 is done with the other stage, P, dS
    if (b + 1 < b_end) fetch(b + 1, stages + ((b + 1 - b_first) & 1) * L::kStage);

    // Every warp works, rows past S included: they give P finite and dS = 0
    // (their dO rows are 0), and their P and dS rows feed dK and dV.
    float s[8][4], ds[8][4];
    mm_abt_ldsm<D>(s, Qs + r0 * ld, Ks, ld, lane);    // keys past S: 0, then -inf from b2
    mm_abt_ldsm<D>(ds, dOs + r0 * ld, Vs, ld, lane);  // dP
    softmax_rows_exp2(s, b2);                         // P
    float delta[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) delta[e / 2] += s[j][e] * ds[j][e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
      delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[j][e] = s[j][e] * (ds[j][e] - delta[e / 2]);  // 0 for keys past S
        dsum[j][e] += ds[j][e];
      }
    }
    store_frag_rows(Ps, s, r0, g, t);
    store_frag_rows(dSs, ds, r0, g, t);
    float acc[D / 8][4] = {};
    mm_pm_ldsm<D>(acc, ds, Ks, ld, lane, S);  // dQ = dS K
    store_rows<D>(dq + w * st.b[4] + hd, st.s[4], r0, S, acc, one, g, t);
    __syncthreads();  // P and dS complete
    // each warp takes 16 keys: dV = P^T dO, dK = dS^T Q
    float dva[D / 8][4] = {};
    mm_atm_ldsm<D>(dva, Ps + r0, kTLd, dOs, ld, lane, S);
    store_rows<D>(dv + w * st.b[6] + hd, st.s[6], r0, S, dva, one, g, t);
    float dka[D / 8][4] = {};
    mm_atm_ldsm<D>(dka, dSs + r0, kTLd, Qs, ld, lane, S);
    store_rows<D>(dk + w * st.b[5] + hd, st.s[5], r0, S, dka, one, g, t);
  }

  const long long ss = static_cast<long long>(S) * S;
  float* part = partial + ((static_cast<long long>(wb.c) * nW + wb.p) * H + wb.h) * ss;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e / 2), col = 8 * j + 2 * t + (e & 1);
      if (row < S && col < S) part[row * S + col] = dsum[j][e];
    }
  }
}

// ============================================================ float32: FMAs

template <int D>
struct WinF32 {
  static constexpr int kLd = D + 4;  // 64 x D tiles (q, k, v, dO)
  static constexpr int kInBytes = kTile * kLd * 4;
  static constexpr int kSBytes = kTile * kSLd * 4;
};

// Row r of the warp's logits in Ss (lanes on columns lane and lane + 32) plus
// the bias, softmaxed in place; returns the two probabilities of this lane.
__device__ __forceinline__ float2 f32_softmax_row(float* Ss, const float* Bs, int r, int lane) {
  const float x0 = Ss[r * kSLd + lane] + Bs[r * kBiasLd + lane];
  const float x1 = Ss[r * kSLd + lane + 32] + Bs[r * kBiasLd + lane + 32];
  const float m = warp_max(fmaxf(x0, x1));
  const float e0 = expf(x0 - m), e1 = expf(x1 - m);
  const float inv = 1.f / warp_sum(e0 + e1);
  return make_float2(e0 * inv, e1 * inv);
}

// Write a warp's F32Acc (rows r0 + e / D) to a (B*nW, S, H*D) tensor; rows at
// or past S are skipped.
template <int D>
__device__ __forceinline__ void f32_store_rows(float* dst, long long ss, int r0, int S,
                                               const F32Acc<D>& acc) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < kRows * D / 32; ++i) {
    const int e = 32 * i + lane, r = r0 + e / D;
    if (r < S) dst[r * ss + e % D] = acc.v[i];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) win_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ out,
    int S, int H, int nW, int n_img, int chunk, Strides st, bool vec) {
  using L = WinF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  float* Qs = Bs + kTile * kBiasLd;
  float* Ks = Qs + kTile * L::kLd;
  float* Vs = Ks + kTile * L::kLd;
  float* Ss = Vs + kTile * L::kLd;  // logits, then P

  const WinBlock wb = win_block(H, nW);
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(wb.h) * D;
  load_bias(Bs, bias, mask, S, wb.h, wb.p);

  const int b_end = min(n_img, (wb.c + 1) * chunk);
  for (int b = wb.c * chunk; b < b_end; ++b) {
    const long long w = static_cast<long long>(b) * nW + wb.p;
    __syncthreads();
    load_tile<float, D>(Qs, L::kLd, q + w * st.b[0] + hd, st.s[0], S, vec);
    load_tile<float, D>(Ks, L::kLd, k + w * st.b[1] + hd, st.s[1], S, vec);
    load_tile<float, D>(Vs, L::kLd, v + w * st.b[2] + hd, st.s[2], S, vec);
    __syncthreads();
    if (r0 >= S) continue;

    f32_abt<D>(Ss + r0 * kSLd, kSLd, Qs + r0 * L::kLd, L::kLd, Ks, L::kLd);
    __syncwarp();
    for (int r = r0; r < r0 + kRows; ++r) {
      const float2 p = f32_softmax_row(Ss, Bs, r, lane);
      Ss[r * kSLd + lane] = p.x;
      Ss[r * kSLd + lane + 32] = p.y;
    }
    __syncwarp();
    F32Acc<D> o;
    o.zero();
    o.mma(Ss + r0 * kSLd, kSLd, Vs, L::kLd);
    f32_store_rows<D>(out + w * st.b[3] + hd, st.s[3], r0, S, o);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) win_bwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ partial, int S, int H, int nW, int n_img,
    int chunk, Strides st, bool vec) {
  using L = WinF32<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  float* Qs = Bs + kTile * kBiasLd;
  float* Ks = Qs + kTile * L::kLd;
  float* Vs = Ks + kTile * L::kLd;
  float* dOs = Vs + kTile * L::kLd;
  float* Ps = dOs + kTile * L::kLd;  // logits, then P
  float* DSs = Ps + kTile * kSLd;    // dP, then dS

  const WinBlock wb = win_block(H, nW);
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(wb.h) * D;
  load_bias(Bs, bias, mask, S, wb.h, wb.p);
  float dsum[kRows][2] = {};  // rows r0 + i, columns lane and lane + 32

  const int b_end = min(n_img, (wb.c + 1) * chunk);
  for (int b = wb.c * chunk; b < b_end; ++b) {
    const long long w = static_cast<long long>(b) * nW + wb.p;
    __syncthreads();
    load_tile<float, D>(Qs, L::kLd, q + w * st.b[0] + hd, st.s[0], S, vec);
    load_tile<float, D>(Ks, L::kLd, k + w * st.b[1] + hd, st.s[1], S, vec);
    load_tile<float, D>(Vs, L::kLd, v + w * st.b[2] + hd, st.s[2], S, vec);
    load_tile<float, D>(dOs, L::kLd, dout + w * st.b[3] + hd, st.s[3], S, vec);
    __syncthreads();
    // every warp works, rows past S included (see the bf16 kernel)
    f32_abt<D>(Ps + r0 * kSLd, kSLd, Qs + r0 * L::kLd, L::kLd, Ks, L::kLd);
    f32_abt<D>(DSs + r0 * kSLd, kSLd, dOs + r0 * L::kLd, L::kLd, Vs, L::kLd);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + i;
      const float2 p = f32_softmax_row(Ps, Bs, r, lane);
      const float dp0 = DSs[r * kSLd + lane], dp1 = DSs[r * kSLd + lane + 32];
      const float delta = warp_sum(p.x * dp0 + p.y * dp1);
      const float ds0 = p.x * (dp0 - delta), ds1 = p.y * (dp1 - delta);
      dsum[i][0] += ds0;
      dsum[i][1] += ds1;
      Ps[r * kSLd + lane] = p.x;
      Ps[r * kSLd + lane + 32] = p.y;
      DSs[r * kSLd + lane] = ds0;
      DSs[r * kSLd + lane + 32] = ds1;
    }
    __syncwarp();
    F32Acc<D> acc;
    acc.zero();
    acc.mma(DSs + r0 * kSLd, kSLd, Ks, L::kLd);  // dQ = dS K
    f32_store_rows<D>(dq + w * st.b[4] + hd, st.s[4], r0, S, acc);
    __syncthreads();  // every warp's P and dS rows are written
    acc.zero();
    acc.mma_at(DSs + r0, kSLd, Qs, L::kLd);  // dK = dS^T Q for keys r0..
    f32_store_rows<D>(dk + w * st.b[5] + hd, st.s[5], r0, S, acc);
    acc.zero();
    acc.mma_at(Ps + r0, kSLd, dOs, L::kLd);  // dV = P^T dO
    f32_store_rows<D>(dv + w * st.b[6] + hd, st.s[6], r0, S, acc);
  }

  const long long ss = static_cast<long long>(S) * S;
  float* part = partial + ((static_cast<long long>(wb.c) * nW + wb.p) * H + wb.h) * ss;
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    if (r >= S) break;
    if (lane < S) part[r * S + lane] = dsum[i][0];
    if (lane + 32 < S) part[r * S + lane + 32] = dsum[i][1];
  }
}

// ------------------------------------------------------------------ dbias

constexpr int kSplit = 8;  // slices of the partials a dbias element is summed in

// dbias[i] = sum over n_part partials of partial[k * n + i], k in a fixed
// order: 8 warps each take every 8th partial, then one sums the 8 in turn.
__global__ void __launch_bounds__(32 * kSplit) win_dbias_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dbias, int n_part, int n) {
  __shared__ float sums[kSplit][32];
  const int e = threadIdx.x % 32, s = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + e;
  float acc = 0.f;
  if (i < n) {
    for (int k = s; k < n_part; k += kSplit) acc += partial[static_cast<long long>(k) * n + i];
  }
  sums[s][e] = acc;
  __syncthreads();
  if (s == 0 && i < n) {
    float total = 0.f;
    for (int j = 0; j < kSplit; ++j) total += sums[j][e];
    dbias[i] = total;
  }
}

// ------------------------------------------------------------------ launch

template <typename T, int D>
struct WinSmem;
template <int D>
struct WinSmem<bf16, D> {
  static constexpr int kFwd = WinFwdBf16<D>::kSmem;
  static constexpr int kBwd = WinBwdBf16<D>::kSmem;
};
template <int D>
struct WinSmem<float, D> {
  static constexpr int kBias = kTile * kBiasLd * 4;
  static constexpr int kFwd = kBias + 3 * WinF32<D>::kInBytes + WinF32<D>::kSBytes;
  static constexpr int kBwd = kBias + 4 * WinF32<D>::kInBytes + 2 * WinF32<D>::kSBytes;
};

template <typename T, int D>
struct WinKernels;
template <int D>
struct WinKernels<bf16, D> {
  static constexpr auto fwd = win_fwd_bf16_kernel<D>;
  static constexpr auto bwd = win_bwd_bf16_kernel<D>;
};
template <int D>
struct WinKernels<float, D> {
  static constexpr auto fwd = win_fwd_f32_kernel<D>;
  static constexpr auto bwd = win_bwd_f32_kernel<D>;
};

inline int n_blocks(int BW, int H, int nW, int chunk) {
  const int n_img = BW / nW;
  return (n_img + chunk - 1) / chunk * nW * H;
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias,
               const float* mask, void* out, int BW, int S, int H, int nW, int chunk,
               const long long* strides, cudaStream_t stream) {
  const Strides st = read_strides(strides, 4);
  const void* ptrs[4] = {q, k, v, out};
  const bool vec = aligned<T>(ptrs, st, 4);
  constexpr int smem = WinSmem<T, D>::kFwd;
  const auto kernel = WinKernels<T, D>::fwd;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<n_blocks(BW, H, nW, chunk), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(out), S, H, nW, BW / nW, chunk, st, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const float* bias,
               const float* mask, const void* dout, void* dq, void* dk, void* dv,
               float* partial, float* dbias, int BW, int S, int H, int nW, int chunk,
               const long long* strides, cudaStream_t stream) {
  const Strides st = read_strides(strides, 7);
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  const bool vec = aligned<T>(ptrs, st, 7);
  constexpr int smem = WinSmem<T, D>::kBwd;
  const auto kernel = WinKernels<T, D>::bwd;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_blocks(BW, H, nW, chunk);
  // the partials are written by the first kernel and read by the second, in stream order
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<const T*>(dout), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), partial, S, H, nW, BW / nW, chunk, st, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = H * S * S;
  win_dbias_reduce_kernel<<<(n + 31) / 32, 32 * kSplit, 0, stream>>>(partial, dbias,
                                                                      blocks / H, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(int D, const void* q, const void* k, const void* v, const float* bias,
                 const float* mask, void* out, int BW, int S, int H, int nW, int chunk,
                 const long long* strides, cudaStream_t st) {
  switch (D) {
    case 16: return launch_fwd<T, 16>(q, k, v, bias, mask, out, BW, S, H, nW, chunk, strides, st);
    case 32: return launch_fwd<T, 32>(q, k, v, bias, mask, out, BW, S, H, nW, chunk, strides, st);
    case 64: return launch_fwd<T, 64>(q, k, v, bias, mask, out, BW, S, H, nW, chunk, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_bwd(int D, const void* q, const void* k, const void* v, const float* bias,
                 const float* mask, const void* dout, void* dq, void* dk, void* dv,
                 float* partial, float* dbias, int BW, int S, int H, int nW, int chunk,
                 const long long* strides, cudaStream_t st) {
  switch (D) {
    case 16: return launch_bwd<T, 16>(q, k, v, bias, mask, dout, dq, dk, dv, partial, dbias, BW, S, H, nW, chunk, strides, st);
    case 32: return launch_bwd<T, 32>(q, k, v, bias, mask, dout, dq, dk, dv, partial, dbias, BW, S, H, nW, chunk, strides, st);
    case 64: return launch_bwd<T, 64>(q, k, v, bias, mask, dout, dq, dk, dv, partial, dbias, BW, S, H, nW, chunk, strides, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// BW windows of S <= 64 tokens, H heads of D in {16, 32, 64}; nW windows an
// image (1 and a null mask when unshifted; BW a multiple of nW); a block takes
// `chunk` images of one window position. strides: (window, token) pairs in
// elements, one pair per tensor in the order of the tensor arguments. Launch
// on `stream` without synchronising; return cudaError_t.
extern "C" int window_attention_forward(const void* q, const void* k, const void* v,
                                        const void* bias, const void* mask, void* out,
                                        int BW, int S, int H, int D, int nW, int chunk,
                                        const long long* strides, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  if (dtype == 1) return dispatch_fwd<bf16>(D, q, k, v, b, m, out, BW, S, H, nW, chunk, strides, st);
  if (dtype == 0) return dispatch_fwd<float>(D, q, k, v, b, m, out, BW, S, H, nW, chunk, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// partial: float32 scratch of (BW / nW / chunk rounded up) * nW * H * S * S;
// dbias: (H, S, S) float32. strides order: q, k, v, dout, dq, dk, dv.
extern "C" int window_attention_backward(const void* q, const void* k, const void* v,
                                         const void* bias, const void* mask, const void* dout,
                                         void* dq, void* dk, void* dv, void* partial,
                                         void* dbias, int BW, int S, int H, int D, int nW,
                                         int chunk, const long long* strides, int dtype,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  float* pt = static_cast<float*>(partial);
  float* db = static_cast<float*>(dbias);
  if (dtype == 1)
    return dispatch_bwd<bf16>(D, q, k, v, b, m, dout, dq, dk, dv, pt, db, BW, S, H, nW, chunk, strides, st);
  if (dtype == 0)
    return dispatch_bwd<float>(D, q, k, v, b, m, dout, dq, dk, dv, pt, db, BW, S, H, nW, chunk, strides, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
