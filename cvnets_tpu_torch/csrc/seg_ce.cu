// Fused bilinear-resize-along-W + pixel cross-entropy, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cvnets_tpu/ops/pallas/seg_ce_kernel.py:
// _fwd_kernel (launched by _run_fwd) and _bwd_kernel (launched by _run_bwd).
// The row interpolation hmid = A_h @ logits, (B, H, w, C) float32, which the
// JAX package leaves to XLA, is formed a row at a time inside the forward, and
// computed outside for the backward (a torch matmul). For each
// full-resolution row (b, i) and column j:
//   col[c] = sum_t a[j, t] * hmid[b, i, k[j, t], c]     (A_w @ hmid row)
//   lse    = max_c col + log sum_c exp(col - max)
//   loss   = (1 - ls) * (lse - col[target]) + ls * (lse - mean_c col)
//   loss  *= class_wt[target] * (target != ignore)
// The forward writes only (loss_sum, n_valid); the backward writes
//   dhm[b, i, k, :] = sum_j A_w[j, k] * G[j, :],
//   G[j, c] = (softmax(col)[c] - (1 - ls) * [c == target] - ls / C)
//             * class_wt * valid * scale,   scale = dloss / n_valid.
//
// A_h and A_w come as tables the host builds from the dense matrices
// (ops/seg_ce_kernel.py interp_taps). The forward reads, per output row i and
// column j, up to kTaps (index, weight) pairs (a bilinear upsample has 2, so
// a logit costs 2 FMAs instead of the dense product's w). The backward reads
// A_w as a band: output column j's weights sit on the input columns k0[j] ..
// k0[j] + kTaps - 1, and k0 never decreases with j (the triangle filter of
// resize_matrix_weights is such a band, up- or downsampling); and a plan of
// how the warps of a block split the row (below). Any band computes the same
// function exactly.
//
// What bounds them: at the DeepLabv3 shape (B=8, H=W=512, w=32, C=150) the
// forward reads the head logits (4.9 MB) and the targets (16.8 MB int64), but
// takes B*H*W*C = 315 M exponentials, ~0.075 ms at the SFU's 16 a clock per
// SM; the backward reads hmid (78.6 MB) and writes dhm (78.6 MB), and the
// same exponentials bound it. The forward takes one exponential a logit in
// one pass, and one launch:
//   * one block per full-resolution row, which forms its row of hmid (w*C
//     floats) in shared memory from the kTaps rows of head logits that A_h
//     names (read from L2 as the loss passes them, a permuted view of NCHW
//     logits, and transposed into the row; 16 output rows share a pair of
//     head rows at DeepLabv3's shape); every output pixel of the row reads
//     its taps there, two classes a load where C is even;
//   * the block takes the largest logit of each of the row's w input columns
//     (a warp a column); A_w's weights are nonnegative, so a pixel's
//     mb = sum_t a_t colmax[k_t] is at least each of its logits, and stands
//     in for the max: one pass over C, one thread per output pixel, forms
//     sum exp2((col - mb) log2 e) (one ex2.approx a logit) and sum col, with
//     no shuffles and no recomputed taps. Where mb lies so far above the max
//     that the sum underflows (wide-spread logits), the pixel takes two more
//     passes with its true max;
//   * no float atomics anywhere: each block writes its row's partial; the
//     last block to take a ticket (an int atomic after a fence) sums the
//     partials in row order in double, so the loss is the same bit for bit
//     from run to run, and resets the ticket.
// The backward takes one exponential a logit and keeps the A_w^T product in
// registers:
//   * one block per row of 8 warps; the row of hmid comes into shared memory
//     by 16-byte cp.async (a grid of one wave that prefetched the next row
//     into a second buffer measured slower, PERF.md);
//   * the plan gives each warp a run of output columns; a warp takes its
//     pixels in order, kGroup at a time, kLanes = 32 / kGroup lanes a pixel
//     over classes (lane li owns c = li + kLanes i): each lane evaluates its
//     logits once from the shared row, the group takes the row max and the
//     sum of exp2 by shuffles, and forms G from the kept exponentials; a
//     pixel with no gradient (ignored, or of class weight 0) costs nothing.
//     Four pixels of 8 lanes (C <= 24, 2 taps) quarter the shuffles, the
//     division and the bookkeeping a pixel, and leave 3 lanes idle at C 21
//     where one pixel of 32 lanes idles 11 (two pixels of 16 lanes at C 150
//     took 80 registers, 3 blocks an SM, and measured slower than one);
//   * each lane keeps, per class it owns, kTaps accumulators for the input
//     columns from k0 on (the pixels of a step share k0); when k0 moves past
//     a column, its dhm is complete: the groups' partial sums are added by
//     shuffles and the column stored straight to global memory (the C floats
//     of a column are contiguous, so the stores coalesce);
//   * an input column that two warps' runs touch is stored, by each, to a slot
//     of shared memory; after a barrier the block sums every such column's
//     slots in warp order, so dhm is the same bit for bit from run to run,
//     with no atomics; a column no pixel touches is written as 0;
//   * C past 32 * 5 walks the run once per group of 160 classes, each pixel's
//     softmax statistics recomputed over all C in every group.
// Targets are int64 (torch's label dtype); a target outside [0, C) that is not
// the ignore index picks no logit and weighs 0 with class weights, as the
// Pallas kernel's one-hot does. Everything is float32.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
// warps of a backward block; the host's plan splits a row among as many
// (_BWD_WARPS in seg_ce_kernel.py)
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kWarp * kBwdWarps;
// ints of the plan per active warp: its output columns [j_lo, j_hi), its input
// columns [k_lo, k_hi), the offset of its slot map (seg_ce_kernel.py _WALK)
constexpr int kWalk = 5;
constexpr float kLog2e = 1.4426950408889634f;
// a forward pixel whose sum of exponentials under its bound falls below this
// recomputes with its true max
constexpr float kTiny = 0x1p-60f;
// floats of a forward block's shared memory past the row and its column
// maxima never fall under this: the last block's sum reuses them
constexpr int kFwdMinSmem = 32;
// classes a forward tap load reads at once where C is a multiple of it (the
// loads then stay aligned); else a class at a time
constexpr int kVec = 2;

struct alignas(4 * kVec) Vec {
  float x[kVec];
};

// 2^x on the SFU, one instruction (exp2f without fast math adds a denormal
// guard); -inf gives +0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int kTaps>
struct Taps {
  int k[kTaps];
  float a[kTaps];
  __device__ __forceinline__ void load(const int* idx, const float* wt, int j) {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      k[t] = idx[j * kTaps + t];
      a[t] = wt[j * kTaps + t];
    }
  }
  // col[c] from the shared row h (w, C)
  __device__ __forceinline__ float col(const float* h, int c, int C) const {
    float v = a[0] * h[k[0] * C + c];
#pragma unroll
    for (int t = 1; t < kTaps; ++t) v = fmaf(a[t], h[k[t] * C + c], v);
    return v;
  }
  // col[c .. c + kVec) for C and c multiples of kVec: one vector load a tap
  __device__ __forceinline__ void cols(const float* h, int c, int C, float (&v)[kVec]) const {
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const Vec x = *reinterpret_cast<const Vec*>(h + k[t] * C + c);
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[i] = t == 0 ? a[0] * x.x[i] : fmaf(a[t], x.x[i], v[i]);
    }
  }
  // sum_t a_t colmax[k_t]: at least every logit of the pixel, as the weights
  // are nonnegative (interp_taps refuses others)
  __device__ __forceinline__ float bound(const float* colmax) const {
    float m = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) m = fmaf(a[t], colmax[k[t]], m);
    return m;
  }
  // ln sum_c exp(col[c]) and, with kSmooth, sum_c col[c]: one pass and one
  // exponential a logit, shifted by mb >= max_c col[c]. Where the sum falls
  // under kTiny (mb far above the max: the exponentials lose their low bits
  // to the flush of subnormals, then all of them), the pixel takes two
  // passes with its true max.
  template <bool kSmooth>
  __device__ __forceinline__ float lse(const float* h, int C, float mb, float& sum) const {
    float s = 0.f, total = 0.f;
    const float shift = mb * kLog2e;
    const int c_vec = C % kVec == 0 ? C : 0;
    for (int c = 0; c < c_vec; c += kVec) {
      float v[kVec];
      cols(h, c, C, v);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s += fast_exp2(fmaf(v[i], kLog2e, -shift));
        if (kSmooth) total += v[i];
      }
    }
    for (int c = c_vec; c < C; ++c) {
      const float v = col(h, c, C);
      s += fast_exp2(fmaf(v, kLog2e, -shift));
      if (kSmooth) total += v;
    }
    sum = total;
    if (s < kTiny) {
      float m = -INFINITY;
      for (int c = 0; c < C; ++c) m = fmaxf(m, col(h, c, C));
      const float exact = m * kLog2e;
      s = 0.f;
      for (int c = 0; c < C; ++c) s += fast_exp2(fmaf(col(h, c, C), kLog2e, -exact));
      mb = m;
    }
    return mb + logf(s);
  }
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// copy a row of n floats into shared memory and wait for it: 16 bytes a copy
// when the row starts on 16 bytes and n is a multiple of 4, else 4
__device__ __forceinline__ void load_row_async(float* dst, const float* src, int n) {
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * kBwdThreads) cp_async_16(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += kBwdThreads) cp_async_4(dst + e, src + e);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The row hmid[b, i] = sum_t A_h[i, t] logits[b, rows.k[t]] into shared
// memory as (w, C), from the image's logits (h, w, C) at element strides
// (sy, sx, sc). The threads walk the image along its contiguous axis: along
// the pixels where sx is 1 (a permuted view of NCHW logits, as the loss
// passes them), so the reads coalesce and the writes transpose into the
// row; else along the classes.
template <int kTaps>
__device__ __forceinline__ void h_row(float* h, const float* __restrict__ img, int sy, int sx,
                                      int sc, const Taps<kTaps>& rows, int w, int C) {
  int off[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) off[t] = rows.k[t] * sy;
  const bool pixels = sx == 1;
  const int n_fast = pixels ? w : C, s_fast = pixels ? sx : sc, s_slow = pixels ? sc : sx;
  const int h_fast = pixels ? C : 1, h_slow = pixels ? 1 : C;
  const int d_slow = kThreads / n_fast, d_fast = kThreads - d_slow * n_fast;
  int slow = threadIdx.x / n_fast, fast = threadIdx.x - slow * n_fast;
#pragma unroll 4
  for (int e = threadIdx.x; e < w * C; e += kThreads) {
    const int at = fast * s_fast + slow * s_slow;
    float v = rows.a[0] * img[off[0] + at];
#pragma unroll
    for (int t = 1; t < kTaps; ++t) v = fmaf(rows.a[t], img[off[t] + at], v);
    h[fast * h_fast + slow * h_slow] = v;
    fast += d_fast;
    slow += d_slow;
    if (fast >= n_fast) {
      fast -= n_fast;
      ++slow;
    }
  }
}

// colmax[k] = max_c h[k, c] of the shared row h (w, C), a warp a column
__device__ __forceinline__ void column_max(const float* h, float* colmax, int w, int C) {
  const int lane = threadIdx.x % kWarp;
  for (int k = threadIdx.x / kWarp; k < w; k += kThreads / kWarp) {
    float m = -INFINITY;
    for (int c = lane; c < C; c += kWarp) m = fmaxf(m, h[k * C + c]);
    m = warp_max(m);
    if (lane == 0) colmax[k] = m;
  }
}

// The last block of a forward launch: the per-row partials summed in row
// order (a strided run a thread, the warp's shuffles, then the warps in
// order, in double), so the loss has the same bits whichever block comes
// last; then the ticket goes back to 0 for the next launch.
__device__ __forceinline__ void sum_partials(const float* partial_loss, const int* partial_cnt,
                                             int rows, float* smem, float* out, int* ticket) {
  __threadfence();  // read the partials after the ticket that said they are all in
  double l = 0.0;
  long long n = 0;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    l += __ldcg(partial_loss + r);
    n += __ldcg(partial_cnt + r);
  }
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
    n += __shfl_xor_sync(0xffffffffu, n, o);
  }
  double* red_l = reinterpret_cast<double*>(smem);  // kFwdMinSmem floats
  long long* red_n = reinterpret_cast<long long*>(red_l + kThreads / kWarp);
  if (threadIdx.x % kWarp == 0) {
    red_l[threadIdx.x / kWarp] = l;
    red_n[threadIdx.x / kWarp] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / kWarp; ++i) {
      red_l[0] += red_l[i];
      red_n[0] += red_n[i];
    }
    out[0] = static_cast<float>(red_l[0]);
    out[1] = static_cast<float>(red_n[0]);
    *ticket = 0;
  }
}

template <int kTaps, bool kSmooth>
__global__ void __launch_bounds__(kThreads) seg_ce_fwd_kernel(
    const float* __restrict__ logits, long long sb, int sy, int sx, int sc,
    const int* __restrict__ row_idx, const float* __restrict__ row_wt,
    const long long* __restrict__ target, const int* __restrict__ tap_idx,
    const float* __restrict__ tap_wt, const float* __restrict__ class_wts,
    float* __restrict__ partial_loss, int* __restrict__ partial_cnt, int* __restrict__ ticket,
    float* __restrict__ out, int H, int w, int W, int C, int ignore_idx, float ls) {
  extern __shared__ __align__(16) float smem[];
  float* h = smem;               // w*C
  float* colmax = smem + w * C;  // w
  const long long row = blockIdx.x, b = row / H;
  Taps<kTaps> rows;
  rows.load(row_idx, row_wt, static_cast<int>(row - b * H));
  h_row(h, logits + b * sb, sy, sx, sc, rows, w, C);
  __syncthreads();
  column_max(h, colmax, w, C);
  __syncthreads();

  const long long* trow = target + row * W;
  const float inv_c = 1.f / static_cast<float>(C);
  float loss = 0.f;
  int cnt = 0;
  for (int j = threadIdx.x; j < W; j += kThreads) {
    const long long t = trow[j];
    if (t == ignore_idx) continue;
    ++cnt;
    Taps<kTaps> taps;
    taps.load(tap_idx, tap_wt, j);
    float sum;
    const float lse = taps.template lse<kSmooth>(h, C, taps.bound(colmax), sum);
    const bool in_range = t >= 0 && t < C;
    const float picked = in_range ? taps.col(h, static_cast<int>(t), C) : 0.f;
    float l = lse - picked;
    if (kSmooth) l = (1.f - ls) * l + ls * (lse - sum * inv_c);
    if (class_wts != nullptr) l *= in_range ? class_wts[t] : 0.f;
    loss += l;
  }

  // the row's partial in a fixed order: shuffles within a warp, then warps in
  // order, in the row's shared memory, which nothing reads any more
  loss = warp_sum(loss);
  for (int o = kWarp / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  float* red_loss = smem;
  int* red_cnt = reinterpret_cast<int*>(smem + kThreads / kWarp);
  __syncthreads();
  if (lane == 0) {
    red_loss[warp] = loss;
    red_cnt[warp] = cnt;
  }
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    float l = 0.f;
    int n = 0;
    for (int i = 0; i < kThreads / kWarp; ++i) {
      l += red_loss[i];
      n += red_cnt[i];
    }
    partial_loss[row] = l;
    partial_cnt[row] = n;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  if (__syncthreads_or(last)) sum_partials(partial_loss, partial_cnt, gridDim.x, smem, out, ticket);
}

// ------------------------------------------------------------------ backward

// The max and the sum over the kLanes lanes of a pixel's group (lanes l and
// l ^ o, o < kLanes, serve the same pixel).
template <int kLanes>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int kLanes>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Store input column k (acc[0], summed over the warp's groups, which hold
// partial sums of the same classes) to dhm's row, or to slot `slot` of shared
// memory when another warp also touches the column, and shift the
// accumulators down one column. The group sums run in one butterfly order on
// every lane, so dhm does not depend on the run.
template <int kTaps, int kNC, int kGroup>
__device__ __forceinline__ void flush_column(float (&acc)[kTaps][kNC], int k, int slot,
                                             float* drow, float* edge, int c0, bool writer,
                                             int C) {
  constexpr int kLanes = kWarp / kGroup;
  float* dst = slot < 0 ? drow + static_cast<long long>(k) * C : edge + slot * C;
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    float v = acc[0][i];
#pragma unroll
    for (int o = kLanes; o < kWarp; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (writer && c0 + kLanes * i < C) dst[c0 + kLanes * i] = v;
#pragma unroll
    for (int t = 0; t + 1 < kTaps; ++t) acc[t][i] = acc[t + 1][i];
    acc[kTaps - 1][i] = 0.f;
  }
}

// G of the group's pixel for the lane's classes c0 + kLanes i: its logits
// from the taps (rows of the shared hmid row) once, the max and the sum of the
// exponentials over the group, then g = e * factor / s - (ls / C + (1 - ls)
// [c == tgt]) * factor. Where the classes do not all fit (C > kLanes kNC, only
// with kGroup 1), the max and sum come from a pass over every class first.
template <int kTaps, int kNC, int kLanes>
__device__ __forceinline__ void pixel_grad(const float* const (&tap)[kTaps],
                                           const float (&a)[kTaps], int c0, int li, int C,
                                           int tgt, float factor, float smooth, float onehot,
                                           float (&g)[kNC]) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    const int c = c0 + kLanes * i;
    float v = -INFINITY;
    if (c < C) {
      v = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) v = fmaf(a[t], tap[t][c], v);
    }
    g[i] = v;  // the logit, then its exponential, then G
    mx = fmaxf(mx, v);
  }
  float m, s = 0.f;
  if (C <= kLanes * kNC) {
    m = group_max<kLanes>(mx) * kLog2e;
#pragma unroll
    for (int i = 0; i < kNC; ++i) {
      g[i] = fast_exp2(fmaf(g[i], kLog2e, -m));
      s += g[i];
    }
  } else {
    // every class of the pixel: the lane's running max and sum, in log2 units
    float ml = -INFINITY;
    for (int c = li; c < C; c += kLanes) {
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) v = fmaf(a[t], tap[t][c], v);
      v *= kLog2e;
      if (v > ml) {
        s = fmaf(s, fast_exp2(ml - v), 1.f);
        ml = v;
      } else {
        s += fast_exp2(v - ml);
      }
    }
    m = group_max<kLanes>(ml);
    s *= fast_exp2(ml - m);
#pragma unroll
    for (int i = 0; i < kNC; ++i) g[i] = fast_exp2(fmaf(g[i], kLog2e, -m));
  }
  s = group_sum<kLanes>(s);
  const float p = factor / s, shift = smooth * factor;
  const int t_rel = tgt - c0;  // the lane's i with c == tgt is t_rel / kLanes
#pragma unroll
  for (int i = 0; i < kNC; ++i) {
    float gi = fmaf(g[i], p, -shift);
    if (t_rel == kLanes * i) gi -= onehot * factor;
    g[i] = gi;
  }
}

// One warp's run of output columns [walk[0], walk[1]) of a row: dhm of the
// input columns [walk[2], walk[3]) it touches, each stored once complete.
// The pixels with a gradient are taken in order, kGroup at a time, kLanes =
// 32 / kGroup lanes each (a lane owns classes c = cg + li + kLanes i, li its
// lane within the group); the pixels of a step share their first input
// column k0, so that the groups' accumulators hold the same columns.
template <int kTaps, int kNC, int kGroup>
__device__ __forceinline__ void bwd_walk(const float* h, const long long* trow,
                                         const int* __restrict__ band_k0,
                                         const float* __restrict__ band_wt,
                                         const int* __restrict__ walk,
                                         const int* __restrict__ slots,
                                         const float* __restrict__ class_wts, float scale,
                                         float smooth, float onehot, float* drow, float* edge,
                                         int w, int C, int ignore_idx) {
  constexpr int kLanes = kWarp / kGroup;
  const int lane = threadIdx.x % kWarp, li = lane % kLanes, sub = lane / kLanes;
  const int j_lo = walk[0], j_hi = walk[1], k_lo = walk[2], k_hi = walk[3];
  const int* slot = slots + walk[4] - k_lo;  // slot[k] for k in [k_lo, k_hi); -1: dhm
  for (int cg = 0; cg < C; cg += kLanes * kNC) {
    const int c0 = cg + li;
    float acc[kTaps][kNC];
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
#pragma unroll
      for (int i = 0; i < kNC; ++i) acc[t][i] = 0.f;
    }
    int base = k_lo;  // acc[t] holds input column base + t
    for (int jb = j_lo; jb < j_hi; jb += kWarp) {
      // lane p holds pixel jb + p's factor, target, k0 and weights
      const int jj = jb + lane;
      float my_f = 0.f, my_a[kTaps];
      int my_t = -1, my_k0 = 0;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) my_a[t] = 0.f;
      if (jj < j_hi) {
        const long long t = trow[jj];
        const bool in_range = t >= 0 && t < C;
        my_f = t == ignore_idx ? 0.f : scale;
        if (class_wts != nullptr) my_f *= in_range ? class_wts[t] : 0.f;
        my_t = in_range ? static_cast<int>(t) : -1;
        my_k0 = band_k0[jj];
#pragma unroll
        for (int t = 0; t < kTaps; ++t) my_a[t] = band_wt[jj * kTaps + t];
      }
      // the pixels with a gradient (not ignored, class weight not 0), in order
      unsigned todo = __ballot_sync(0xffffffffu, my_f != 0.f);
      while (todo != 0u) {
        const int k_first = __shfl_sync(0xffffffffu, my_k0, __ffs(todo) - 1);
        // this step's pixels: the first kGroup of todo with the first one's
        // k0 (k0 never decreases, so they are a prefix of todo)
        unsigned cand = todo;
        if (kGroup > 1) cand &= __ballot_sync(0xffffffffu, my_k0 == k_first);
        int p = -1;  // the group's pixel; -1: none this step
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (cand != 0u) {
            if (q == sub) p = __ffs(cand) - 1;
            todo &= todo - 1u;  // the first pixel left is this one
            cand &= cand - 1u;
          }
        }
        for (; base < k_first; ++base) {
          flush_column<kTaps, kNC, kGroup>(acc, base, slot[base], drow, edge, c0, sub == 0, C);
        }
        const int src = p < 0 ? 0 : p;  // every lane takes part in each shuffle
        const float f_src = __shfl_sync(0xffffffffu, my_f, src);
        const float factor = p < 0 ? 0.f : f_src;
        const int tgt = __shfl_sync(0xffffffffu, my_t, src);
        float a[kTaps];
        const float* tap[kTaps];
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
          const float a_src = __shfl_sync(0xffffffffu, my_a[t], src);
          a[t] = p < 0 ? 0.f : a_src;  // a group with no pixel adds nothing
          tap[t] = h + min(k_first + t, w - 1) * C;  // past w the weight is 0
        }
        float g[kNC];
        pixel_grad<kTaps, kNC, kLanes>(tap, a, c0, li, C, tgt, factor, smooth, onehot, g);
#pragma unroll
        for (int t = 0; t < kTaps; ++t) {
#pragma unroll
          for (int i = 0; i < kNC; ++i) acc[t][i] = fmaf(a[t], g[i], acc[t][i]);
        }
      }
    }
    for (; base < k_hi; ++base) {
      flush_column<kTaps, kNC, kGroup>(acc, base, slot[base], drow, edge, c0, sub == 0, C);
    }
  }
}

template <int kTaps, int kNC, int kGroup>
__global__ void __launch_bounds__(kBwdThreads) seg_ce_bwd_kernel(
    const float* __restrict__ hmid, const long long* __restrict__ target,
    const int* __restrict__ band_k0, const float* __restrict__ band_wt,
    const int* __restrict__ plan, int n_warps, int n_slot_map, int n_shared,
    const float* __restrict__ class_wts, const float* __restrict__ scale_ptr,
    float* __restrict__ dhm, int w, int W, int C, int ignore_idx, float ls) {
  extern __shared__ __align__(16) float smem[];
  const int n = w * C;
  float* edge = smem + ((n + 3) & ~3);  // slots of the columns two warps touch
  // the plan: per active warp its walk, then the slot map, then the shared
  // columns' indices and the first of their slots (shared_ptr[r] ..
  // shared_ptr[r + 1] - 1, one a warp, in warp order)
  const int* slots = plan + kWalk * n_warps;
  const int* shared_k = slots + n_slot_map;
  const int* shared_ptr = shared_k + n_shared;
  const int warp = threadIdx.x / kWarp;
  const long long row = blockIdx.x;
  float* drow = dhm + row * n;
  load_row_async(smem, hmid + row * n, n);
  __syncthreads();
  if (warp < n_warps) {
    bwd_walk<kTaps, kNC, kGroup>(smem, target + row * W, band_k0, band_wt, plan + kWalk * warp,
                                 slots, class_wts, *scale_ptr,
                                 ls > 0.f ? ls / static_cast<float>(C) : 0.f, 1.f - ls, drow,
                                 edge, w, C, ignore_idx);
  }
  __syncthreads();
  // the shared columns: their slots summed in warp order
  for (int e = threadIdx.x; e < n_shared * C; e += kBwdThreads) {
    const int r = e / C, c = e - r * C;
    float v = 0.f;
    for (int q = shared_ptr[r]; q < shared_ptr[r + 1]; ++q) v += edge[q * C + c];
    drow[static_cast<long long>(shared_k[r]) * C + c] = v;
  }
}

// bytes of a forward block's shared memory: the row of hmid and its column
// maxima (_fwd_smem in seg_ce_kernel.py)
size_t fwd_smem(int w, int C) {
  return std::max<size_t>(static_cast<size_t>(w) * (C + 1), kFwdMinSmem) * sizeof(float);
}

template <int kTaps, bool kSmooth>
int launch_fwd(const float* logits, long long sb, int sy, int sx, int sc, const int* row_idx,
               const float* row_wt, const long long* target, const int* tap_idx,
               const float* tap_wt, const float* class_wts, float* partial_loss,
               int* partial_cnt, int* ticket, float* out, int rows, int H, int w, int W, int C,
               int ignore_idx, float ls, cudaStream_t stream) {
  const auto kernel = seg_ce_fwd_kernel<kTaps, kSmooth>;
  const size_t smem = fwd_smem(w, C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, kThreads, smem, stream>>>(logits, sb, sy, sx, sc, row_idx, row_wt, target,
                                           tap_idx, tap_wt, class_wts, partial_loss,
                                           partial_cnt, ticket, out, H, w, W, C, ignore_idx,
                                           ls);
  return static_cast<int>(cudaGetLastError());
}


size_t bwd_smem(int w, int C, int n_slots) {
  const size_t ld = (static_cast<size_t>(w) * C + 3) & ~static_cast<size_t>(3);
  return (ld + static_cast<size_t>(n_slots) * C) * sizeof(float);
}

template <int kTaps, int kNC, int kGroup>
int launch_bwd(const float* hmid, const long long* target, const int* band_k0,
               const float* band_wt, const int* plan, int n_warps, int n_slot_map,
               int n_shared, int n_slots, const float* class_wts, const float* scale,
               float* dhm, int rows, int w, int W, int C, int ignore_idx, float ls,
               cudaStream_t stream) {
  const auto kernel = seg_ce_bwd_kernel<kTaps, kNC, kGroup>;
  const size_t smem = bwd_smem(w, C, n_slots);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, kBwdThreads, smem, stream>>>(hmid, target, band_k0, band_wt, plan, n_warps,
                                              n_slot_map, n_shared, class_wts, scale, dhm, w,
                                              W, C, ignore_idx, ls);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. `taps` is 2, 4, 8 or 16; class_wts
// may be null. They launch on `stream` without synchronising and return
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported `taps` or
// `classes`).
//
// The forward: logits (B, h, w, C) float32 at element strides (sb, sy, sx,
// sc), an image's offsets under 2^31; row_idx, row_wt (H, taps) A_h's
// table and tap_idx, tap_wt (W, taps) A_w's, at one tap count; target (B, H,
// W) int64; partial_loss, partial_cnt `rows` = B * H floats and ints of
// scratch; ticket one int, 0 before the launch and after it; out two floats,
// (loss_sum, n_valid).
extern "C" int seg_ce_forward(const void* logits, long long sb, int sy, int sx, int sc,
                              const void* row_idx, const void* row_wt, const void* target,
                              const void* tap_idx, const void* tap_wt, int taps,
                              const void* class_wts, void* partial_loss, void* partial_cnt,
                              void* ticket, void* out, int rows, int H, int w, int W, int C,
                              int ignore_idx, float ls, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(static_cast<const float*>(logits), sb, sy, sx, sc,
                  static_cast<const int*>(row_idx), static_cast<const float*>(row_wt),
                  static_cast<const long long*>(target), static_cast<const int*>(tap_idx),
                  static_cast<const float*>(tap_wt), static_cast<const float*>(class_wts),
                  static_cast<float*>(partial_loss), static_cast<int*>(partial_cnt),
                  static_cast<int*>(ticket), static_cast<float*>(out), rows, H, w, W, C,
                  ignore_idx, ls, st);
  };
  auto smooth = [&](auto taps_c) -> int {
    constexpr int kT = decltype(taps_c)::value;
    return ls > 0.f ? args(launch_fwd<kT, true>) : args(launch_fwd<kT, false>);
  };
  switch (taps) {
    case 2: return smooth(std::integral_constant<int, 2>());
    case 4: return smooth(std::integral_constant<int, 4>());
    case 8: return smooth(std::integral_constant<int, 8>());
    case 16: return smooth(std::integral_constant<int, 16>());
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward. band_k0 (W,) and band_wt (W, taps) are A_w as a band; plan
// holds `warps` walks, the slot map (n_slot_map ints) and the n_shared
// columns two warps touch (seg_ce_kernel.py BandPlan); n_slots is the
// shared-memory slots of C floats. A lane keeps `classes` classes in
// registers; a warp takes `group` pixels at a time: (group, classes) is one of
// (1; 1, 2, 3, 5) and, with 2 taps, (4; 1, 2, 3).
extern "C" int seg_ce_backward(const void* hmid, const void* target, const void* band_k0,
                               const void* band_wt, int taps, const void* plan, int warps,
                               int n_slot_map, int n_shared, int n_slots, int group,
                               int classes, const void* class_wts, const void* scale,
                               void* dhm, int rows, int w, int W, int C, int ignore_idx,
                               float ls, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(static_cast<const float*>(hmid), static_cast<const long long*>(target),
                  static_cast<const int*>(band_k0), static_cast<const float*>(band_wt),
                  static_cast<const int*>(plan), warps, n_slot_map, n_shared, n_slots,
                  static_cast<const float*>(class_wts), static_cast<const float*>(scale),
                  static_cast<float*>(dhm), rows, w, W, C, ignore_idx, ls, st);
  };
  auto single = [&](auto taps_c) -> int {  // a pixel a warp
    constexpr int kT = decltype(taps_c)::value;
    switch (classes) {
      case 1: return args(launch_bwd<kT, 1, 1>);
      case 2: return args(launch_bwd<kT, 2, 1>);
      case 3: return args(launch_bwd<kT, 3, 1>);
      case 5: return args(launch_bwd<kT, 5, 1>);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  };
  if (warps < 1 || warps > kBwdWarps) return static_cast<int>(cudaErrorInvalidValue);
  if (group == 1) {
    switch (taps) {
      case 2: return single(std::integral_constant<int, 2>());
      case 4: return single(std::integral_constant<int, 4>());
      case 8: return single(std::integral_constant<int, 8>());
      case 16: return single(std::integral_constant<int, 16>());
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (group != 4 || taps != 2) return static_cast<int>(cudaErrorInvalidValue);
  switch (classes) {
    case 1: return args(launch_bwd<2, 1, 4>);
    case 2: return args(launch_bwd<2, 2, 4>);
    case 3: return args(launch_bwd<2, 3, 4>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
