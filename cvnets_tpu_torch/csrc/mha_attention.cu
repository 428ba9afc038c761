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
// depends on S beyond the grid's tile counts; offsets that scale with S are
// 64-bit. One difference from mha_attn_long.py: it saves lse = m + log(l)
// (:122), which is m again in float32 on a fully masked row (m = -1e30), so its
// backward gives that row's gradients S times too large; the (max, log sum)
// pair here keeps the 1/S of uniform attention.
// q, k and v are (B, S, H*D) in the layer's projection layout, q already scaled;
// head h is the column range [h*D, (h+1)*D). Each tensor is a pointer with a
// batch stride and a token stride (channel stride 1), so q, k and v may be
// column slices of one fused qkv projection and no copy is made. The optional
// key mask is additive, (B, S) float32; null means no mask.
//
// Forward. The TPU kernel holds one batch element's whole (S, H*D) tile and the
// (S, S) float32 logits in VMEM; a Hopper block has at most 227 KB of shared
// memory and at S = 197 the logits alone are 155 KB, so this is the flash shape:
// grid (ceil(S/128) query blocks, H, B), a loop over 64-key tiles of K, V and
// the mask with an online softmax (running max and sum in float32), one
// normalisation at the end; it writes O in the input dtype and per-row
// statistics (max, log of the sum) for the backward. The statistics are a
// pair, not one log-sum-exp: in a row whose keys are all masked with -1e30
// every logit is -1e30 exactly, the row attends uniformly, and -1e30 + log(S)
// rounds back to -1e30 in float32, which would lose the 1/S.
//
// What bounds the bf16 forward (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's
// mha phases and cvnets_tpu_torch/tools/time_mha_forward.py). The function
// needs 2 products of 2 S^2 D a head and one exponential a logit, and reads q,
// k, v once and writes O and the statistics once: at ViT-B/16 224^2 (B 128,
// S 197, H 12, D 64) that is bytes, 0.047 ms at 3.35 TB/s; at 512^2 (B 32,
// S 1024) the tensor cores, 0.104 ms at 989 TFLOP/s, with the exponentials
// close behind (0.096 ms on the SFU). The first design (64-row blocks in four
// warps, 32- and 16-bit fragment loads, tiles loaded synchronously between two
// barriers, expf twice a logit, mma.sync) took 0.21 and 0.83 ms a call. The
// redesign, step by step (ms a call at the two shapes):
//   1. Q's A fragments by ldmatrix once a block, kept in registers (D/16 x 4),
//      K by ldmatrix.x4 and V by ldmatrix.x4.trans on the D + 8 pitch, and
//      no products for keys past S: 0.20 / 0.73.
//   2. K, V and the mask through a two-stage ring of 16-byte cp.async (zero
//      fill past S through the src-size operand), one barrier a tile; the
//      scalar path stays for unaligned strides: 0.20 / 0.74, the loads being
//      hidden already by the other resident blocks.
//   3. exp2 in log2 units (softmax_tile: the backward's own rounding, a fully
//      masked row kept exact) and 128 query rows in eight warps, so that K and
//      V stream from L2 half as often: 0.16 / 0.60.
//   4. D = 64 and 128 on wgmma (mha_fwd_wgmma_kernel): two warpgroups of 64
//      rows; S = Q K^T as m64n64k16 with Q's fragments from registers and K
//      from shared memory in the 128-byte swizzle, O += P V as m64nDk16 with P
//      packed to bf16 in registers and V read transposed: 0.15 / 0.50. ptxas
//      serialized every product (C7520, a warpgroup arrive it inserted on a
//      divergent path) until the loop lost its branches: warpgroups past S,
//      P V steps past S and exponentials past S are computed, on zero rows and
//      -inf masks, instead of skipped: 0.13 / 0.38 (1.4 / 1.6 times cuDNN's
//      SDPA, about flash's).
// D = 16 and 32 keep the step-3 kernel (mha_fwd_bf16_kernel): S = Q K^T is a
// 64-key product whatever D is, and those head dims serve only the micro
// models. What the design leaves: a warpgroup's softmax does not overlap its
// own products and both warpgroups meet at one barrier a tile. Issuing the
// next tile's S before the softmax (three stages) was slower for registers,
// one warpgroup a block and 128-key tiles for occupancy; a TMA ring with
// mbarriers and a producer warp is untried.
//
// bfloat16 backward (the training path): three launches on one stream, no
// atomics, so dq, dk and dv are the same bit for bit on every run.
//   pre-pass: delta = rowsum(dO * O) and the statistics times log2(e), one
//     vectorised pass into a (3, B, H, S) float32 scratch;
//   dQ: one block per 128 query rows (eight warps of 16) streams 64-key tiles of
//     K, V and the mask: P = 2^(S log2 e + mask log2 e - m log2 e - log(l) log2 e),
//     dS = P (dO V^T - delta), dQ += dS K;
//   dK/dV: one block per 128 keys streams 64-query tiles of Q, dO and the
//     pre-pass rows; with the same P and dS, transposed, dV += P^T dO and
//     dK += dS^T Q.
// This is the math of _bwd_kernel with 1/l taken out through the statistics.
// Every product runs on the tensor cores through mma.sync m16n8k16 (bf16 x bf16
// -> f32). A warp's logits, P and dS stay in registers in the mma fragment
// layout, and an accumulator of logits is reused as the A operand of the next
// product (the FlashAttention-2 arrangement); P and dS are rounded to bf16 for
// their products. A warp takes a streamed tile in chunks of columns (64 in dQ,
// 32 in dK/dV) so that the logits beside the D-wide accumulators fit its
// registers at two blocks an SM.
//
// What bounds the backward (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's
// mha phases). The function
// needs 5 products of 2 S^2 D a head and one exponential a logit, and reads
// q, k, v, O, dO once and writes dq, dk, dv once: at ViT-B/16 224^2 (B 128,
// S 197, H 12, D 64) that is bytes, 0.09 ms at 3.35 TB/s; at 512^2 (B 32,
// S 1024) it is the tensor cores, 0.26 ms at 989 TFLOP/s. The design pays 7
// products (dQ and dK/dV each recompute S and dP^T), and with mma.sync every
// operand goes through shared memory and registers: each warp reads the whole
// streamed tile for its own 16 rows (per warp and 64-row tile, 80 ldmatrix.x4
// for 128 mma.sync in dK/dV, 56 for 96 in dQ); at 128 bytes a clock an SM
// those reads alone come to nearly 60% of the 0.40 and 1.44 ms a call (a count,
// not a measurement). The earlier design (64-row tiles, four warps, 32-bit and
// 16-bit fragment loads, synchronous tile loads between two barriers, expf,
// delta computed serially inside dQ) took 0.81 and 2.92 ms a call. The
// redesign, step by step:
//   1. ldmatrix.x4 (.trans for the B operand of P.M) builds each fragment in one
//      instruction per four 8 x 8 matrices, where 32-bit and 16-bit loads took
//      four to sixteen; the D + 8 pitch keeps them free of bank conflicts.
//   2. The streamed tiles go through two stages of 16-byte cp.async.cg (zero
//      fill past S through the src-size operand), the next tile's copy in
//      flight while the current one's products run, one barrier a tile; the
//      scalar path stays for unaligned strides.
//   3. exp2 on the SFU with log2(e) folded into one FMA a logit and the
//      statistics pre-scaled once a row; delta in its own pre-pass, so neither
//      kernel waits on a serial row walk.
//   4. 128 resident rows a block (eight warps; D = 128 keeps 64 rows and four
//      warps) halve the re-streaming of the other side from global memory; the
//      streamed tile stays at 64 rows. It left the time as it was: the
//      shared-memory reads a warp makes do not depend on the rows a block holds.
// What it leaves: wgmma and TMA (warpgroup products from shared memory and a
// copy engine ring), and the 7 products of the split design against the 5 of a
// one-pass backward whose dQ would need atomics or a deterministic reduction.
//
// float32 (evaluation, not training speed): the same tiling, 64-row tiles and
// four warps, plain FMAs on shared-memory tiles (no TF32) so the path keeps
// float32 accuracy; its dQ kernel computes delta and writes it for its dK/dV
// kernel. Softmax statistics, the mask and every accumulator are float32 on
// both paths, as in the Pallas body.
// Ragged edges: S need not be a multiple of the tiles. Tiles are zero-filled
// past S; keys past S get probability 0 exactly, rows past S are never written,
// and a warp whose 16 rows all lie past S skips the tile's products (the wgmma
// forward computes them on the zero rows instead).

#include <type_traits>

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

// load_kmask with pad -inf, the mask copied by cp.async into the open group.
__device__ __forceinline__ void load_kmask_async(float* kmask, const float* mask, int b, int S,
                                                 int k0, int k_rows) {
  if (threadIdx.x < kTile) {
    const int c = threadIdx.x;
    if (mask != nullptr && c < k_rows)
      cp_async_4(kmask + c, mask + static_cast<long long>(b) * S + k0 + c);
    else
      kmask[c] = c < k_rows ? 0.f : -INFINITY;
  }
}

// One key tile of the bf16 forward's online softmax for a warp's 16 rows (rows
// g and g + 8 of its lane): s holds their logits in C fragments and leaves
// with P; km is the tile's additive mask, -inf past S, so those keys get 0
// with no test (a branch here made ptxas serialize the wgmma kernel's
// products). In log2 units: x = fma(S, log2 e, mask log2 e), the backward's
// own rounding, the running max m of x, and 2^(x - m), the difference taken
// first so that a fully masked row (every x = m = -1e30 log2 e) gets exactly
// 1 a key and keeps its 1/S. The running sum l and the output o are rescaled
// to the new max.
template <int D>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&o)[D / 8][4], const float* km, int t) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __fmaf_rn(s[j][e], kLog2e, km[8 * j + 2 * t + (e & 1)] * kLog2e);
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  }
  float alpha[2], m_sub[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // a row's 64 columns sit in the 4 lanes of its group
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    // -inf only while every key so far had a mask of -inf: keep those at 0
    m_sub[i] = mx[i] == -INFINITY ? 0.f : mx[i];
    alpha[i] = fast_exp2(m[i] - m_sub[i]);  // 0 on the first tile
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = fast_exp2(s[j][e] - m_sub[e / 2]);
      l[e / 2] += s[j][e];
    }
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e / 2];
  }
}

// The bf16 forward's end for a warp's 16 rows: O = o / l in bf16 and the
// statistics in natural units: the max by a division that the pre-pass's
// multiply by log2(e) undoes bit for bit, the log of the sum.
template <int D>
__device__ __forceinline__ void store_fwd_rows(bf16* out, float* stats, float (&o)[D / 8][4],
                                               const float (&m)[2], float (&l)[2], int b, int h,
                                               int H, int S, int q0, int q_rows, int r0,
                                               long long ss, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  store_rows<D>(out, ss, r0, q_rows, o, l, g, t);
  if (t == 0) {
    const long long bhs = static_cast<long long>(gridDim.z) * H * S;
    const long long row0 = (static_cast<long long>(b) * H + h) * S + q0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r < q_rows) {
        stats[row0 + r] = __fdiv_rn(m[i], kLog2e);
        stats[bhs + row0 + r] = logf(l[i]);
      }
    }
  }
}

// The mma.sync forward's blocks (D = 16 and 32): kRows query rows in kWarps
// warps of 16 rows, against 64-key tiles of K, V and the mask in a ring of
// kStages stages. ptxas -v (CUDA 12.8): 94 registers at D = 16, 110 at
// D = 32, two blocks an SM.
template <int D>
struct FwdTiles {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kStages = 2;
  static constexpr int kLd = Bf16Tiles<D>::kLd;
  // the Q tile, then each stage's K and V tiles, then each stage's mask
  static constexpr int kSmem = (kRows + 2 * kStages * kTile) * kLd * 2 + kStages * kTile * 4;
};

template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 2) mha_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ stats,
    int S, int H, Strides st, bool vec) {
  using L = FwdTiles<D>;
  constexpr int ld = L::kLd;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* KVs = Qs + L::kRows * ld;  // stage i: K at KVs + 2i tiles, V after it
  float* kmask = reinterpret_cast<float*>(KVs + 2 * L::kStages * kTile * ld);  // stage i at + i * kTile

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * L::kRows;
  const int q_rows = min(L::kRows, S - q0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const long long hd = static_cast<long long>(h) * D;
  const int n_tiles = (S + kTile - 1) / kTile;

  // one commit group a tile: its K, V and mask (keys past S: zero rows, mask -inf)
  auto prefetch = [&](int it) {
    if (it < n_tiles) {
      const int k0 = it * kTile, k_rows = min(kTile, S - k0), stage = it % L::kStages;
      bf16* Ks = KVs + 2 * stage * kTile * ld;
      load_rows_async<D, kTile, L::kThreads>(Ks, ld, k + b * st.b[1] + k0 * st.s[1] + hd,
                                             st.s[1], k_rows, vec);
      load_rows_async<D, kTile, L::kThreads>(Ks + kTile * ld, ld,
                                             v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2],
                                             k_rows, vec);
      load_kmask_async(kmask + stage * kTile, mask, b, S, k0, k_rows);
    }
    cp_async_commit();  // empty past the last tile, so the group count stays fixed
  };

  // Q joins the first tile's group
  load_rows_async<D, L::kRows, L::kThreads>(Qs, ld, q + b * st.b[0] + q0 * st.s[0] + hd,
                                            st.s[0], q_rows, vec);
#pragma unroll
  for (int it = 0; it < L::kStages - 1; ++it) prefetch(it);
  uint32_t qf[D / 16][4];  // this warp's rows of Q, kept for the whole key loop
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this lane's part of their running sums

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<L::kStages - 2>();  // tile it (and Q) has arrived
    __syncthreads();  // for every thread; every warp is done with tile it - 1's stage
    prefetch(it + L::kStages - 1);  // into tile it - 1's stage
    if (it == 0) ldsm_rows<D>(qf, Qs + r0 * ld, ld, lane);
    if (r0 >= q_rows) continue;  // this warp's rows are all past S
    const int k_rows = min(kTile, S - it * kTile);
    const bf16* Ks = KVs + 2 * (it % L::kStages) * kTile * ld;
    float s[8][4];
    mm_abt_regs<D>(s, qf, Ks, ld, lane, k_rows);  // keys past S: 0, their mask -inf
    softmax_tile<D>(s, m, l, o, kmask + (it % L::kStages) * kTile, t);
    mm_pm_ldsm<D>(o, s, Ks + kTile * ld, ld, lane, k_rows);
  }
  store_fwd_rows<D>(out + b * st.b[3] + q0 * st.s[3] + hd, stats, o, m, l, b, h, H, S, q0,
                    q_rows, r0, st.s[3], g, t);
}

// ============================================================ bfloat16: wgmma
//
// The forward for D = 64 and 128 on warpgroup products: four warps issue one
// asynchronous m64nNk16 product for 64 rows. Its float32 accumulator gives
// warp w of the warpgroup rows 16w + g and 16w + g + 8 in exactly the
// mma.sync C layout (element 4j + e of the N/8 x 4 array), and its A operand
// from registers takes exactly the mma.sync A fragments; so Q's fragments,
// the softmax and the P packing are the mma.sync kernel's. B comes from
// shared memory through a descriptor: K and V tiles are stored in the 128-byte
// swizzle, a row of 64 bf16 in 128 bytes with its 16-byte chunk c at chunk
// c ^ (row % 8), 8 rows to a 1024-byte atom; D = 128 is two 64-column halves
// of 64 rows, one after the other.

// element offset of chunk c (8 bf16) of row r of a swizzled 64-row tile
__device__ __forceinline__ int sw128(int r, int c) {
  return (c / 8) * kTile * 64 + r * 64 + ((c % 8) ^ (r % 8)) * 8;
}

// load_rows_async into the swizzled layout (dst 1024-byte aligned), 64 rows.
template <int D, int kN>
__device__ __forceinline__ void load_rows_sw128(bf16* dst, const bf16* src, long long ss,
                                                int rows, bool vec) {
  if (vec) {
    constexpr int kPerRow = D / 8;
    for (int i = threadIdx.x; i < kTile * kPerRow; i += kN) {
      const int r = i / kPerRow, c = i % kPerRow;
      const bool ok = r < rows;
      cp_async_16(dst + sw128(r, c), src + (ok ? r : 0) * ss + 8 * c, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kN) {
      const int r = i / D, c = i % D;
      dst[sw128(r, c / 8) + c % 8] = r < rows ? src[r * ss + c] : from_f32<bf16>(0.f);
    }
  }
}

// A shared-memory matrix descriptor in the 128-byte swizzle: the start
// address, the leading and the stride byte offsets (each in 16-byte units).
// K-major (K for S = Q K^T, rows of D): the stride offset steps 8 rows
// (1024 bytes), the leading one is unused. MN-major (V for P V, read
// transposed): the stride offset steps 8 keys, the leading one from the
// first 64 columns of D to the next.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of the generic proxy (stores, cp.async) made visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from touching registers that an issued wgmma still
// reads or writes: each is an operand of an empty asm, here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// d (64 x N, this thread's part) (+)= A (64 x 16, registers) . B (16 x N, shared
// memory through desc; kTransB: MN-major); scale_d 0 overwrites d.
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
  }
}

// The wgmma forward's blocks: two warpgroups of 64 query rows, against 64-key
// tiles of K and V (swizzled) and the mask in a ring of kStages stages. ptxas
// -v (CUDA 12.8): 128 registers at D = 64, no spills, two blocks (four
// warpgroups) an SM; 164 at D = 128, one block. Three stages were no faster.
template <int D>
struct WgTiles {
  static constexpr int kThreads = 256;
  static constexpr int kRows = 128;
  static constexpr int kStages = 2;
  static constexpr int kQLd = Bf16Tiles<D>::kLd;  // Q is read by ldmatrix
  static constexpr int kKvElems = kTile * D;      // one swizzled K or V tile
  // alignment slack, each stage's K and V (1024-byte aligned), Q, each stage's mask
  static constexpr int kSmem =
      1024 + (2 * kStages * kKvElems + kRows * kQLd) * 2 + kStages * kTile * 4;
};

template <int D>
__global__ void __launch_bounds__(WgTiles<D>::kThreads, D == 64 ? 2 : 1) mha_fwd_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, bf16* __restrict__ out, float* __restrict__ stats,
    int S, int H, Strides st, bool vec) {
  using L = WgTiles<D>;
  constexpr int qld = L::kQLd;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  bf16* KVs = reinterpret_cast<bf16*>(smem);  // stage i: K at KVs + 2i tiles, V after it
  bf16* Qs = KVs + 2 * L::kStages * L::kKvElems;
  float* kmask = reinterpret_cast<float*>(Qs + L::kRows * qld);  // stage i at + i * kTile

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * L::kRows;
  const int q_rows = min(L::kRows, S - q0);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // this warp's rows; a warpgroup whose rows all lie past S computes on the
  // zero rows of Q anyway (a skip would be a branch around the products)
  const int r0 = (threadIdx.x / 32) * 16;
  const long long hd = static_cast<long long>(h) * D;
  const int n_tiles = (S + kTile - 1) / kTile;

  auto prefetch = [&](int it) {
    if (it < n_tiles) {
      const int k0 = it * kTile, k_rows = min(kTile, S - k0), stage = it % L::kStages;
      bf16* Ks = KVs + 2 * stage * L::kKvElems;
      load_rows_sw128<D, L::kThreads>(Ks, k + b * st.b[1] + k0 * st.s[1] + hd, st.s[1], k_rows,
                                      vec);
      load_rows_sw128<D, L::kThreads>(Ks + L::kKvElems, v + b * st.b[2] + k0 * st.s[2] + hd,
                                      st.s[2], k_rows, vec);
      load_kmask_async(kmask + stage * kTile, mask, b, S, k0, k_rows);
    }
    cp_async_commit();
  };

  load_rows_async<D, L::kRows, L::kThreads>(Qs, qld, q + b * st.b[0] + q0 * st.s[0] + hd,
                                            st.s[0], q_rows, vec);
#pragma unroll
  for (int it = 0; it < L::kStages - 1; ++it) prefetch(it);
  uint32_t qf[D / 16][4];
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<L::kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // tile it has arrived; every wgmma on tile it - 1's stage is done
    prefetch(it + L::kStages - 1);
    // Q's fragments, read again each tile: held in registers across the loop
    // as the A operand of an asynchronous product they came out wrong at D = 64
    ldsm_rows<D>(qf, Qs + r0 * qld, qld, lane);
    const bf16* Ks = KVs + 2 * (it % L::kStages) * L::kKvElems;
    const bf16* Vs = Ks + L::kKvElems;

    float s[8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // 16 columns of D: 32 bytes into a row, or the next half
      wgmma_rs<kTile, 0>(s, qf[kk], sw128_desc(Ks + sw128(0, 2 * kk), 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    softmax_tile<D>(s, m, l, o, kmask + (it % L::kStages) * kTile, t);

    uint32_t pa[kTile / 16][4];  // P in bf16 as the A operand, 16 keys each
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)  // 16 keys: 8 rows of 128 bytes each twice
      wgmma_rs<D, 1>(o, pa[kk], sw128_desc(Vs + 16 * kk * 64, kTile * 64 * 2, 1024), 1);
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);
    fence_regs(pa);
  }
  store_fwd_rows<D>(out + b * st.b[3] + q0 * st.s[3] + hd, stats, o, m, l, b, h, H, S, q0,
                    q_rows, r0, st.s[3], g, t);
}

// The backward's pre-pass: for every (b, h, query row) the row statistics
// pre-scaled by log2(e) and delta = rowsum(dO * O) in float32, into `rows`
// (3, B, H, S): m log2(e), log(l) log2(e), delta. D / 8 consecutive threads
// take one row, 8 elements each (16-byte loads when vec), and sum by shuffles.
// Tensor order in st: q, k, v, o, dO.
template <int D>
__global__ void __launch_bounds__(256) mha_bwd_prep_bf16_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ stats,
    float* __restrict__ rows, int B, int S, int H, Strides st, bool vec) {
  constexpr int kPer = D / 8;  // threads a row: 2 to 16, a divisor of 32
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n = static_cast<long long>(B) * S * H * kPer;
  const int c = static_cast<int>(i % kPer) * 8;
  const long long bsh = i / kPer;
  const int h = static_cast<int>(bsh % H);
  const long long bs = bsh / H;
  const int s = static_cast<int>(bs % S), b = static_cast<int>(bs / S);
  float x = 0.f;
  if (i < n) {
    const bf16* orow = o + b * st.b[3] + s * st.s[3] + h * D + c;
    const bf16* drow = dout + b * st.b[4] + s * st.s[4] + h * D + c;
    if (vec) {
      const uint4 ov = *reinterpret_cast<const uint4*>(orow);
      const uint4 dv = *reinterpret_cast<const uint4*>(drow);
      const bf16* oe = reinterpret_cast<const bf16*>(&ov);
      const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) x += to_f32(oe[e]) * to_f32(de[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x += to_f32(orow[e]) * to_f32(drow[e]);
    }
  }
#pragma unroll
  for (int off = kPer / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (i < n && c == 0) {
    const long long bhs = static_cast<long long>(B) * H * S;
    const long long row = (static_cast<long long>(b) * H + h) * S + s;
    rows[row] = stats[row] * kLog2e;
    rows[bhs + row] = stats[bhs + row] * kLog2e;
    rows[2 * bhs + row] = x;
  }
}

// The bf16 backward's blocks: kRes resident rows (queries in dQ, keys in
// dK/dV) in kWarps warps of 16 rows, against streamed tiles of kTile = 64 rows
// of the other side in two stages; a warp takes a streamed tile kChunk columns
// at a time, so that of the logits only a 16 x kChunk piece is live in its
// registers beside its accumulators. kKeys: the dK/dV kernel's blocks.
// At D = 64 (ptxas -v, CUDA 12.8): dQ 74,240 bytes of shared memory and 127
// registers a thread, dK/dV 75,264 bytes and 128 registers (20 bytes spilled);
// __launch_bounds__ asks for two blocks (16 warps) an SM, which both hold.
// Eight warps with chunks of 64 in dQ and 32 in dK/dV were the fastest of the
// four- and eight-warp, 16- to 64-column choices timed on the card.
template <int D, bool kKeys>
struct BwdTiles {
  static constexpr int kWarps = D <= 64 ? 8 : 4;
  static constexpr int kChunk = kKeys ? 32 : 64;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRes = 16 * kWarps;
  static constexpr int kLd = Bf16Tiles<D>::kLd;
  // two resident tiles, two stages of two streamed tiles, then float32 rows:
  // dQ the keys' mask, dK/dV three values of each query, two stages each
  static constexpr int kSmem =
      2 * kRes * kLd * 2 + 4 * kTile * kLd * 2 + (kKeys ? 6 : 2) * kTile * 4;
};

// dQ, one block per kRes query rows. Tensor order in st: q, k, v, o, dO, dq.
// The K and V tiles (and their mask) stream through two stages of shared
// memory: the copy of the next tile is in flight while the current one's
// products run, and one barrier a tile both publishes the arrived stage and
// frees the other. P = 2^((S + mask) log2(e) - m log2(e) - log(l) log2(e)),
// in that order: on a fully masked row S + mask and m are the same -1e30
// (times log2(e)), their difference is 0 and P keeps the 1/S that log(l)
// carries. A key past S has mask -inf and a row past S a max of +inf, so
// both give P = 0 without a test.
template <int D>
__global__ void __launch_bounds__(BwdTiles<D, false>::kThreads, 2) mha_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, const bf16* __restrict__ dout,
    const float* __restrict__ rows, bf16* __restrict__ dq, int S, int H, Strides st, bool vec) {
  using L = BwdTiles<D, false>;
  constexpr int ld = L::kLd, kC = L::kChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + L::kRes * ld;
  bf16* KVs = dOs + L::kRes * ld;  // stage i: K at KVs + 2i tiles, V after it
  float* kmask = reinterpret_cast<float*>(KVs + 4 * kTile * ld);  // stage i at + i * kTile

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * L::kRes;
  const int q_rows = min(L::kRes, S - q0);
  const int lane = threadIdx.x % 32, g = lane / 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const long long hd = static_cast<long long>(h) * D;
  const long long bhs = static_cast<long long>(gridDim.z) * H * S;
  const long long row0 = (static_cast<long long>(b) * H + h) * S + q0;

  auto prefetch = [&](int stage, int k0) {  // the K, V and mask tile of keys [k0, k0 + 64)
    const int k_rows = min(kTile, S - k0);
    bf16* Ks = KVs + 2 * stage * kTile * ld;
    load_rows_async<D, kTile, L::kThreads>(Ks, ld, k + b * st.b[1] + k0 * st.s[1] + hd,
                                           st.s[1], k_rows, vec);
    load_rows_async<D, kTile, L::kThreads>(Ks + kTile * ld, ld,
                                           v + b * st.b[2] + k0 * st.s[2] + hd, st.s[2],
                                           k_rows, vec);
    if (threadIdx.x < kTile) {
      const int c = threadIdx.x;
      float* dst = kmask + stage * kTile + c;
      if (mask != nullptr && c < k_rows)
        cp_async_4(dst, mask + static_cast<long long>(b) * S + k0 + c);
      else
        *dst = c < k_rows ? 0.f : -INFINITY;
    }
    cp_async_commit();
  };

  load_rows_async<D, L::kRes, L::kThreads>(Qs, ld, q + b * st.b[0] + q0 * st.s[0] + hd,
                                           st.s[0], q_rows, vec);
  load_rows_async<D, L::kRes, L::kThreads>(dOs, ld, dout + b * st.b[4] + q0 * st.s[4] + hd,
                                           st.s[4], q_rows, vec);
  prefetch(0, 0);
  float rm[2], rl[2], rd[2];  // rows g and g + 8: m log2(e), log(l) log2(e), delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    const bool ok = r < q_rows;
    rm[i] = ok ? rows[row0 + r] : INFINITY;
    rl[i] = ok ? rows[bhs + row0 + r] : 0.f;
    rd[i] = ok ? rows[2 * bhs + row0 + r] : 0.f;
  }

  float acc[D / 8][4] = {};
  for (int it = 0, k0 = 0; k0 < S; ++it, k0 += kTile) {
    cp_async_wait();
    __syncthreads();  // this tile has arrived; every warp is done with the other stage
    if (k0 + kTile < S) prefetch((it + 1) % 2, k0 + kTile);
    if (r0 >= q_rows) continue;  // this warp's rows are all past S
    const bf16* Ks = KVs + 2 * (it % 2) * kTile * ld;
    const bf16* Vs = Ks + kTile * ld;
    const float* km = kmask + (it % 2) * kTile;
    const int k_rows = min(kTile, S - k0);
#pragma unroll 1
    for (int c0 = 0; c0 < k_rows; c0 += kC) {  // keys [c0, c0 + kC) of the tile
      float s[kC / 8][4], dp[kC / 8][4];
      mm_abt_ldsm<D, kC>(s, Qs + r0 * ld, Ks + c0 * ld, ld, lane);    // S
      mm_abt_ldsm<D, kC>(dp, dOs + r0 * ld, Vs + c0 * ld, ld, lane);  // dP
#pragma unroll
      for (int j = 0; j < kC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * (lane % 4) + (e & 1), i = e / 2;
          const float x = __fmaf_rn(s[j][e], kLog2e, km[col] * kLog2e) - rm[i];
          s[j][e] = fast_exp2(x - rl[i]) * (dp[j][e] - rd[i]);  // dS
        }
      }
      mm_pm_ldsm<D, kC>(acc, s, Ks + c0 * ld, ld, lane);  // dQ += dS K
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + b * st.b[5] + q0 * st.s[5] + hd, st.s[5], r0, q_rows, acc, one, g,
                lane % 4);
}

// dK and dV, one block per kRes keys; a warp's tiles are transposed: rows are
// keys, columns queries. Tensor order in st: q, k, v, o, dO, dq, dk, dv. The
// Q and dO tiles and the query rows' pre-pass values stream as K and V do in
// dQ; P as there, a query past S having a max of +inf.
template <int D>
__global__ void __launch_bounds__(BwdTiles<D, true>::kThreads, 2) mha_bwd_dkdv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, const bf16* __restrict__ dout,
    const float* __restrict__ rows, bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
    Strides st, bool vec) {
  using L = BwdTiles<D, true>;
  constexpr int ld = L::kLd, kC = L::kChunk;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + L::kRes * ld;
  bf16* QdOs = Vs + L::kRes * ld;  // stage i: Q at QdOs + 2i tiles, dO after it
  // stage i's query rows: m log2(e), log(l) log2(e), delta, each kTile wide
  float* cols = reinterpret_cast<float*>(QdOs + 4 * kTile * ld);

  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * L::kRes;
  const int k_rows = min(L::kRes, S - k0);
  const int lane = threadIdx.x % 32, g = lane / 4;
  const int r0 = (threadIdx.x / 32) * 16;
  const long long hd = static_cast<long long>(h) * D;
  const long long bhs = static_cast<long long>(gridDim.z) * H * S;
  const long long bh = (static_cast<long long>(b) * H + h) * S;

  auto prefetch = [&](int stage, int q0) {  // queries [q0, q0 + 64)
    const int q_rows = min(kTile, S - q0);
    bf16* Qs = QdOs + 2 * stage * kTile * ld;
    load_rows_async<D, kTile, L::kThreads>(Qs, ld, q + b * st.b[0] + q0 * st.s[0] + hd,
                                           st.s[0], q_rows, vec);
    load_rows_async<D, kTile, L::kThreads>(Qs + kTile * ld, ld,
                                           dout + b * st.b[4] + q0 * st.s[4] + hd, st.s[4],
                                           q_rows, vec);
    if (threadIdx.x < kTile) {
      const int c = threadIdx.x;
      float* dst = cols + 3 * stage * kTile + c;
      if (c < q_rows) {
#pragma unroll
        for (int w = 0; w < 3; ++w) cp_async_4(dst + w * kTile, rows + w * bhs + bh + q0 + c);
      } else {
        dst[0] = INFINITY;
        dst[kTile] = dst[2 * kTile] = 0.f;
      }
    }
    cp_async_commit();
  };

  load_rows_async<D, L::kRes, L::kThreads>(Ks, ld, k + b * st.b[1] + k0 * st.s[1] + hd,
                                           st.s[1], k_rows, vec);
  load_rows_async<D, L::kRes, L::kThreads>(Vs, ld, v + b * st.b[2] + k0 * st.s[2] + hd,
                                           st.s[2], k_rows, vec);
  prefetch(0, 0);
  float km[2];  // the mask of keys g and g + 8, times log2(e)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    km[i] = (mask != nullptr && r < k_rows)
                ? mask[static_cast<long long>(b) * S + k0 + r] * kLog2e : 0.f;
  }

  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  for (int it = 0, q0 = 0; q0 < S; ++it, q0 += kTile) {
    cp_async_wait();
    __syncthreads();  // this tile has arrived; every warp is done with the other stage
    if (q0 + kTile < S) prefetch((it + 1) % 2, q0 + kTile);
    if (r0 >= k_rows) continue;  // this warp's keys are all past S
    const bf16* Qs = QdOs + 2 * (it % 2) * kTile * ld;
    const bf16* dOs = Qs + kTile * ld;
    const float* col_m = cols + 3 * (it % 2) * kTile;
    const float* col_l = col_m + kTile;
    const float* col_delta = col_l + kTile;
    const int q_rows = min(kTile, S - q0);
#pragma unroll 1
    for (int c0 = 0; c0 < q_rows; c0 += kC) {  // queries [c0, c0 + kC) of the tile
      float p[kC / 8][4], ds[kC / 8][4];
      mm_abt_ldsm<D, kC>(p, Ks + r0 * ld, Qs + c0 * ld, ld, lane);    // S^T
      mm_abt_ldsm<D, kC>(ds, Vs + r0 * ld, dOs + c0 * ld, ld, lane);  // dP^T
#pragma unroll
      for (int j = 0; j < kC / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * (lane % 4) + (e & 1), i = e / 2;
          const float x = __fmaf_rn(p[j][e], kLog2e, km[i]) - col_m[col];
          const float pe = fast_exp2(x - col_l[col]);
          p[j][e] = pe;
          ds[j][e] = pe * (ds[j][e] - col_delta[col]);
        }
      }
      mm_pm_ldsm<D, kC>(dv_acc, p, dOs + c0 * ld, ld, lane);  // dV += P^T dO
      mm_pm_ldsm<D, kC>(dk_acc, ds, Qs + c0 * ld, ld, lane);  // dK += dS^T Q
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + b * st.b[6] + k0 * st.s[6] + hd, st.s[6], r0, k_rows, dk_acc, one, g,
                lane % 4);
  store_rows<D>(dv + b * st.b[7] + k0 * st.s[7] + hd, st.s[7], r0, k_rows, dv_acc, one, g,
                lane % 4);
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
  static constexpr int kDq = BwdTiles<D, false>::kSmem;
  static constexpr int kDkdv = BwdTiles<D, true>::kSmem;
};
template <int D>
struct Smem<float, D> {
  using L = F32Tiles<D>;
  static constexpr int kFwd = 3 * L::kInBytes + 2 * L::kSBytes + L::kOBytes + 3 * kTile * 4;
  static constexpr int kDq = 4 * L::kInBytes + 2 * L::kSBytes + 4 * kTile * 4;
  static constexpr int kDkdv = kDq;
};

template <typename T, int D>
struct Kernels;
template <int D>
struct Kernels<bf16, D> {
  static constexpr auto dq = mha_bwd_dq_bf16_kernel<D>;
  static constexpr auto dkdv = mha_bwd_dkdv_bf16_kernel<D>;
};
template <int D>
struct Kernels<float, D> {
  static constexpr auto dq = mha_bwd_dq_f32_kernel<D>;
  static constexpr auto dkdv = mha_bwd_dkdv_f32_kernel<D>;
};

// The forward's kernel and block for each type and head dim: bf16 at D = 64
// and 128 the wgmma kernel, at D = 16 and 32 the mma.sync one (a warpgroup
// product is at least 64 x 64 x 16); float32 the FMA one.
template <int D>
struct MmaFwd {
  static constexpr auto fn = mha_fwd_bf16_kernel<D>;
  static constexpr int kSmem = FwdTiles<D>::kSmem, kRows = FwdTiles<D>::kRows,
                       kThreads = FwdTiles<D>::kThreads;
};
template <int D>
struct WgFwd {
  static constexpr auto fn = mha_fwd_wgmma_kernel<D>;
  static constexpr int kSmem = WgTiles<D>::kSmem, kRows = WgTiles<D>::kRows,
                       kThreads = WgTiles<D>::kThreads;
};
template <int D>
struct F32Fwd {
  static constexpr auto fn = mha_fwd_f32_kernel<D>;
  static constexpr int kSmem = Smem<float, D>::kFwd, kRows = kTile, kThreads = ::kThreads;
};
template <typename T, int D>
using Fwd = std::conditional_t<std::is_same<T, float>::value, F32Fwd<D>,
                               std::conditional_t<(D >= 64), WgFwd<D>, MmaFwd<D>>>;

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* mask, void* out,
               float* stats, int B, int S, int H, const long long* strides,
               cudaStream_t stream) {
  using F = Fwd<T, D>;
  const Strides st = read_strides(strides, 4);
  const void* ptrs[4] = {q, k, v, out};
  const bool vec = aligned<T>(ptrs, st, 4);
  cudaError_t err = cudaFuncSetAttribute(F::fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + F::kRows - 1) / F::kRows, H, B);
  const auto fwd = F::fn;
  fwd<<<grid, F::kThreads, F::kSmem, stream>>>(
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
  constexpr int smem_dq = Smem<T, D>::kDq, smem_dkdv = Smem<T, D>::kDkdv;
  cudaError_t err = cudaFuncSetAttribute(Kernels<T, D>::dq,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(Kernels<T, D>::dkdv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto dq_kernel = Kernels<T, D>::dq;
  const auto dkdv_kernel = Kernels<T, D>::dkdv;
  if constexpr (std::is_same<T, bf16>::value) {
    using Q = BwdTiles<D, false>;
    using K = BwdTiles<D, true>;
    // the pre-pass writes `delta` (3, B, H, S); both kernels read it
    const long long threads = static_cast<long long>(B) * S * H * (D / 8);
    mha_bwd_prep_bf16_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), stats, delta, B, S, H, st,
        vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_kernel<<<dim3((S + Q::kRes - 1) / Q::kRes, H, B), Q::kThreads, smem_dq, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), delta, static_cast<bf16*>(dq), S, H, st, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_kernel<<<dim3((S + K::kRes - 1) / K::kRes, H, B), K::kThreads, smem_dkdv, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        mask, static_cast<const bf16*>(dout), delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, H, st, vec);
  } else {
    const dim3 grid((S + kTile - 1) / kTile, H, B);
    // delta (B, H, S) is written by the first kernel and read by the second
    dq_kernel<<<grid, kThreads, smem_dq, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<const T*>(o), static_cast<const T*>(dout), stats, delta,
        static_cast<T*>(dq), S, H, st, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv_kernel<<<grid, kThreads, smem_dkdv, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), mask,
        static_cast<const T*>(dout), stats, delta, static_cast<T*>(dk), static_cast<T*>(dv),
        S, H, st, vec);
  }
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

// delta is (3, B, H, S) float32 scratch. strides order: q, k, v, o, dout, dq, dk, dv.
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
