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
// when unshifted). Both are finite: -100 keeps a weight of e^-100 in the
// softmax and its gradient, exactly as in the einsum reference.
//
// Design. A window has S = ws^2 = 49 tokens at Swin's window 7: one tile of 64
// rows padded with zeros (S <= 64 is what these kernels take). The TPU kernels
// pack several windows into one tile and softmax a band of it to fill the
// 128-wide lanes; on Hopper a lone window pads to 64 rows for mma.sync instead,
// and the packing and the banded softmax are left out. A block is four warps,
// each owning 16 query rows of the tile, and it owns one head h and one window
// position p and loops over a chunk of images: windows b*nW + p for b in its
// chunk. So the bias tile (bias[h] + mask[p], keys past S at -inf) is built in
// shared memory once per block, and the block's share of dbias stays in
// registers across its windows.
//   * forward: per window, S = Q K^T + bias, a whole-row softmax (every key of
//     the window is in the tile, so no online rescaling), O = P V / l.
//   * backward: per window, the forward's P is recomputed and dP = dO V^T;
//     delta = rowsum(P * dP) (equal to rowsum(dO * O), without reading O);
//     dS = P (dP - delta); dQ = dS K from the warp's own rows; then P^T and
//     dS^T go through shared memory so that each warp takes 16 keys for
//     dV = P^T dO and dK = dS^T Q.
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
// What bounds it: per window and head, 4 S^2 D ~ 0.3 MFLOP forward on
// 3 S D 2 ~ 9.4 KB of bf16 inputs, ~33 flop per byte, far under the H100's
// ridge (~295): HBM bytes bound both kernels. The padding of 49 rows and keys to
// 64 costs products (and one warp of four works on a single row), not bytes.
// What the simple design leaves on the table: no cp.async or TMA prefetch of the
// next window's tiles while this one computes, and 4 warps a block.

#include "attention_tiles.cuh"

namespace {

constexpr int kBiasLd = kTile + 8;  // float32 bias tile; even, so rows take float2 loads
constexpr int kTLd = kTile + 8;     // bf16 P^T and dS^T tiles
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

// acc (16 x D) += A . M: A is 16 x 64 and M is 64 x D, both row-major bf16 in
// shared memory (leading dimensions lda and ld).
template <int D>
__device__ __forceinline__ void mm_am(float (&acc)[D / 8][4], const bf16* A, int lda,
                                      const bf16* M, int ld, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* a_row = A + g * lda + 16 * kk + 2 * t;
    const uint32_t a[4] = {ld32(a_row), ld32(a_row + 8 * lda), ld32(a_row + 8),
                           ld32(a_row + 8 * lda + 8)};
    const bf16* m_col = M + (16 * kk + 2 * t) * ld + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const bf16* p0 = m_col + 8 * j;
      const uint32_t b[2] = {ld_pair(p0, p0 + ld), ld_pair(p0 + 8 * ld, p0 + 9 * ld)};
      mma(acc[j], a, b);
    }
  }
}

// In place: s (16 x 64 logits in C fragments) + the bias tile -> softmax rows;
// returns nothing, the rows are normalised. Rows g and g + 8 of the warp's 16
// sit in the 4 lanes of one group.
__device__ __forceinline__ void softmax_rows(float (&s)[8][4], const float* Bs, int r0, int g,
                                             int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 b = *reinterpret_cast<const float2*>(
          Bs + (r0 + g + 8 * i) * kBiasLd + 8 * j + 2 * t);
      s[j][2 * i] += b.x;
      s[j][2 * i + 1] += b.y;
      mx[i] = fmaxf(mx[i], fmaxf(s[j][2 * i], s[j][2 * i + 1]));
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
      s[j][e] = expf(s[j][e] - mx[e / 2]);  // 0 for keys past S
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

// ============================================================ bfloat16: mma.sync

// Tensor order in st: q, k, v, out.
template <int D>
__global__ void __launch_bounds__(kThreads) win_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask, bf16* __restrict__ out,
    int S, int H, int nW, int n_img, int chunk, Strides st, bool vec) {
  constexpr int ld = Bf16Tiles<D>::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(Bs + kTile * kBiasLd);
  bf16* Ks = Qs + kTile * ld;
  bf16* Vs = Ks + kTile * ld;

  const WinBlock wb = win_block(H, nW);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(wb.h) * D;
  load_bias(Bs, bias, mask, S, wb.h, wb.p);
  const float one[2] = {1.f, 1.f};

  const int b_end = min(n_img, (wb.c + 1) * chunk);
  for (int b = wb.c * chunk; b < b_end; ++b) {
    const long long w = static_cast<long long>(b) * nW + wb.p;
    __syncthreads();  // the bias tile is built, the previous window's tiles are used
    load_tile<bf16, D>(Qs, ld, q + w * st.b[0] + hd, st.s[0], S, vec);
    load_tile<bf16, D>(Ks, ld, k + w * st.b[1] + hd, st.s[1], S, vec);
    load_tile<bf16, D>(Vs, ld, v + w * st.b[2] + hd, st.s[2], S, vec);
    __syncthreads();
    if (r0 >= S) continue;  // this warp's rows are all past S

    float s[8][4];
    mm_abt<D>(s, Qs + r0 * ld, Ks, ld, S, g, t);  // keys past S: 0, then -inf from the bias
    softmax_rows(s, Bs, r0, g, t);
    float o[D / 8][4] = {};
    mm_pm<D>(o, s, Vs, ld, S, g, t);
    store_rows<D>(out + w * st.b[3] + hd, st.s[3], r0, S, o, one, g, t);
  }
}

// Tensor order in st: q, k, v, dO, dq, dk, dv. partial is (chunks, nW, H, S, S).
template <int D>
__global__ void __launch_bounds__(kThreads) win_bwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ mask,
    const bf16* __restrict__ dout, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ partial, int S, int H, int nW, int n_img,
    int chunk, Strides st, bool vec) {
  constexpr int ld = Bf16Tiles<D>::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Bs = reinterpret_cast<float*>(smem);
  bf16* Qs = reinterpret_cast<bf16*>(Bs + kTile * kBiasLd);
  bf16* Ks = Qs + kTile * ld;
  bf16* Vs = Ks + kTile * ld;
  bf16* dOs = Vs + kTile * ld;
  bf16* PT = dOs + kTile * ld;   // P^T: rows keys, columns queries
  bf16* dST = PT + kTile * kTLd;  // dS^T

  const WinBlock wb = win_block(H, nW);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * kRows;
  const long long hd = static_cast<long long>(wb.h) * D;
  load_bias(Bs, bias, mask, S, wb.h, wb.p);
  const float one[2] = {1.f, 1.f};
  float dsum[8][4] = {};  // this block's sum of dS, in the warp's C fragments

  const int b_end = min(n_img, (wb.c + 1) * chunk);
  for (int b = wb.c * chunk; b < b_end; ++b) {
    const long long w = static_cast<long long>(b) * nW + wb.p;
    __syncthreads();  // the previous window's tiles and P^T, dS^T are used
    load_tile<bf16, D>(Qs, ld, q + w * st.b[0] + hd, st.s[0], S, vec);
    load_tile<bf16, D>(Ks, ld, k + w * st.b[1] + hd, st.s[1], S, vec);
    load_tile<bf16, D>(Vs, ld, v + w * st.b[2] + hd, st.s[2], S, vec);
    load_tile<bf16, D>(dOs, ld, dout + w * st.b[3] + hd, st.s[3], S, vec);
    __syncthreads();
    // Every warp works, rows past S included: they give P finite and dS = 0
    // (their dO rows are 0), and their P^T and dS^T columns feed dK and dV.
    float s[8][4], ds[8][4];
    mm_abt<D>(s, Qs + r0 * ld, Ks, ld, S, g, t);
    softmax_rows(s, Bs, r0, g, t);                  // P
    mm_abt<D>(ds, dOs + r0 * ld, Vs, ld, S, g, t);  // dP; keys past S: 0
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
        const int row = r0 + g + 8 * (e / 2), col = 8 * j + 2 * t + (e & 1);
        ds[j][e] = s[j][e] * (ds[j][e] - delta[e / 2]);  // 0 for keys past S
        dsum[j][e] += ds[j][e];
        PT[col * kTLd + row] = __float2bfloat16(s[j][e]);
        dST[col * kTLd + row] = __float2bfloat16(ds[j][e]);
      }
    }
    float acc[D / 8][4] = {};
    mm_pm<D>(acc, ds, Ks, ld, S, g, t);  // dQ = dS K
    store_rows<D>(dq + w * st.b[4] + hd, st.s[4], r0, S, acc, one, g, t);
    __syncthreads();  // P^T and dS^T complete
    float dka[D / 8][4] = {}, dva[D / 8][4] = {};
    mm_am<D>(dva, PT + r0 * kTLd, kTLd, dOs, ld, g, t);  // dV = P^T dO for keys r0..
    mm_am<D>(dka, dST + r0 * kTLd, kTLd, Qs, ld, g, t);  // dK = dS^T Q
    store_rows<D>(dk + w * st.b[5] + hd, st.s[5], r0, S, dka, one, g, t);
    store_rows<D>(dv + w * st.b[6] + hd, st.s[6], r0, S, dva, one, g, t);
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
  static constexpr int kBias = kTile * kBiasLd * 4;
  static constexpr int kFwd = kBias + 3 * Bf16Tiles<D>::kBytes;
  static constexpr int kBwd = kBias + 4 * Bf16Tiles<D>::kBytes + 2 * kTile * kTLd * 2;
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
