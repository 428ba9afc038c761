// Fused bilinear-resize-along-W + pixel cross-entropy, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of cvnets_tpu/ops/pallas/seg_ce_kernel.py:
// _fwd_kernel (launched by _run_fwd) and _bwd_kernel (launched by _run_bwd).
// The row interpolation hmid = A_h @ logits, (B, H, w, C) float32, is computed
// outside (a torch matmul, as the JAX package leaves it to XLA). For each
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
// A_w comes as lists of its nonzeros: for the forward, per output column j up
// to kTaps (index, weight) pairs (a bilinear upsample has 2, so a logit costs 2
// FMAs instead of the dense product's w); for the backward, per chunk of
// output columns and input column k, the (j, weight) pairs of A_w's column k
// (a transposed CSR). The host builds both from the dense matrix, so any A_w
// computes the same function exactly.
//
// What bounds it: at the DeepLabv3 shape (B=8, H=W=512, w=32, C=150) the
// forward reads hmid once (78.6 MB) and the targets (16.8 MB int64), ~0.03 ms
// at 3.35 TB/s, but takes B*H*W*C = 315 M exponentials, ~0.08 ms at the SFU's
// 16 a clock per SM; the backward also writes dhm (78.6 MB). The design:
//   * one block per full-resolution row; the row of hmid (w*C floats) is read
//     from HBM once into shared memory and every output pixel of the row reads
//     its taps there;
//   * forward: one thread per output pixel, two passes over C (max and sums,
//     then the exponentials), no shuffles;
//   * backward: first the softmax statistics of every pixel of the row, one
//     thread a pixel as in the forward, into shared memory; then output
//     columns in chunks of kChunk: G of the chunk into shared memory
//     (class-major, a warp over 32 neighbouring pixels of one class), then
//     every dhm element of the input columns the chunk touches, owned by one
//     thread, sums its column's taps from the chunk in a fixed order into a
//     shared accumulator. 512 threads a block, since its shared memory leaves
//     room for only 2 blocks an SM. Two exponentials a logit instead of one.
//     A first version with one warp a pixel (three passes over C, shuffles)
//     and 256 threads took twice as long (PERF.md); what is left is
//     shared-memory traffic (three accesses per FMA of the A_w^T product) and
//     barrier waits;
//   * no float atomics anywhere: the forward writes per-row partials and a
//     second kernel sums them in a fixed order (in double), so the loss is the
//     same bit for bit from run to run.
// Targets are int64 (torch's label dtype); a target outside [0, C) that is not
// the ignore index picks no logit and weighs 0 with class weights, as the
// Pallas kernel's one-hot does. Everything is float32.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
// the backward's shared memory allows 2 blocks an SM at DeepLabv3's shape, so
// it takes more warps a block to hide the latency of its shared-memory passes
constexpr int kBwdThreads = 512;
// output columns a backward block holds in shared memory at once; the host
// builds its transposed lists of A_w per chunk of as many (seg_ce_kernel.py)
constexpr int kChunk = 64;
static_assert(kBwdThreads % kChunk == 0, "a G pass covers whole chunks");
constexpr int kReduceThreads = 1024;

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
    float v = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) v = fmaf(a[t], h[k[t] * C + c], v);
    return v;
  }
  // over the C logits of the pixel: max m, sum of exp(col - m), sum of col
  __device__ __forceinline__ void softmax_stats(const float* h, int C, float& m, float& s,
                                                float& sum) const {
    m = -INFINITY;
    sum = 0.f;
    for (int c = 0; c < C; ++c) {
      const float v = col(h, c, C);
      m = fmaxf(m, v);
      sum += v;
    }
    s = 0.f;
    for (int c = 0; c < C; ++c) s += expf(col(h, c, C) - m);
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

__device__ __forceinline__ void load_row(float* dst, const float* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

template <int kTaps>
__global__ void __launch_bounds__(kThreads) seg_ce_fwd_kernel(
    const float* __restrict__ hmid, const long long* __restrict__ target,
    const int* __restrict__ tap_idx, const float* __restrict__ tap_wt,
    const float* __restrict__ class_wts, float* __restrict__ partial_loss,
    int* __restrict__ partial_cnt, int w, int W, int C, int ignore_idx, float ls) {
  extern __shared__ float smem[];
  float* h = smem;                            // w*C
  float* red_loss = smem + w * C;             // one per warp
  int* red_cnt = reinterpret_cast<int*>(red_loss + kThreads / kWarp);
  const long long row = blockIdx.x;
  load_row(h, hmid + row * w * C, w * C);
  __syncthreads();

  const long long* trow = target + row * W;
  const float inv_c = 1.f / static_cast<float>(C);
  float loss = 0.f;
  int cnt = 0;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const long long t = trow[j];
    if (t == ignore_idx) continue;
    ++cnt;
    Taps<kTaps> taps;
    taps.load(tap_idx, tap_wt, j);
    float m, s, sum;
    taps.softmax_stats(h, C, m, s, sum);
    const bool in_range = t >= 0 && t < C;
    const float picked = in_range ? taps.col(h, static_cast<int>(t), C) : 0.f;
    const float lse = m + logf(s);
    float l = lse - picked;
    if (ls > 0.f) l = (1.f - ls) * l + ls * (lse - sum * inv_c);
    if (class_wts != nullptr) l *= in_range ? class_wts[t] : 0.f;
    loss += l;
  }

  // fixed-order reduction: shuffles within a warp, then warps in order
  loss = warp_sum(loss);
  for (int o = kWarp / 2; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  if (lane == 0) {
    red_loss[warp] = loss;
    red_cnt[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    int n = 0;
    for (int i = 0; i < static_cast<int>(blockDim.x) / kWarp; ++i) {
      l += red_loss[i];
      n += red_cnt[i];
    }
    partial_loss[row] = l;
    partial_cnt[row] = n;
  }
}

// Sums the per-row partials in a fixed order: out = (loss_sum, n_valid).
__global__ void __launch_bounds__(kReduceThreads) seg_ce_reduce_kernel(
    const float* __restrict__ partial_loss, const int* __restrict__ partial_cnt,
    int rows, float* __restrict__ out) {
  __shared__ double sl[kReduceThreads];
  __shared__ long long sn[kReduceThreads];
  double l = 0.0;
  long long n = 0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    l += partial_loss[r];
    n += partial_cnt[r];
  }
  sl[threadIdx.x] = l;
  sn[threadIdx.x] = n;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (static_cast<int>(threadIdx.x) < s) {
      sl[threadIdx.x] += sl[threadIdx.x + s];
      sn[threadIdx.x] += sn[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(sl[0]);
    out[1] = static_cast<float>(sn[0]);
  }
}

template <int kTaps>
__global__ void __launch_bounds__(kBwdThreads) seg_ce_bwd_kernel(
    const float* __restrict__ hmid, const long long* __restrict__ target,
    const int* __restrict__ tap_idx, const float* __restrict__ tap_wt,
    const int* __restrict__ col_ptr, const int* __restrict__ col_j,
    const float* __restrict__ col_wt, const float* __restrict__ class_wts,
    const float* __restrict__ scale_ptr, float* __restrict__ dhm, int w, int W, int C,
    int ignore_idx, float ls) {
  extern __shared__ float smem[];
  __shared__ int k_range[2];  // the input columns [k_lo, k_hi) the chunk touches
  const int n = w * C;
  const int ld = kChunk + 1;  // G is class-major (C, kChunk + 1)
  float* h = smem;            // (w, C) row of hmid
  float* acc = h + n;         // (w, C) dhm accumulator
  float* g = acc + n;         // (C, ld) G of the current chunk
  float* px_m = g + C * ld;   // per output pixel: max logit,
  float* px_inv = px_m + W;   // 1 / sum of exponentials,
  float* px_f = px_inv + W;   // class weight * valid * scale (0: no grad),
  int* px_t = reinterpret_cast<int*>(px_f + W);  // target, -1 outside [0, C)
  const long long row = blockIdx.x;
  load_row(h, hmid + row * n, n);
  for (int e = threadIdx.x; e < n; e += blockDim.x) acc[e] = 0.f;
  __syncthreads();

  // the softmax statistics, one thread per output pixel, as the forward does
  const long long* trow = target + row * W;
  const float scale = *scale_ptr;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const long long t = trow[j];
    const bool in_range = t >= 0 && t < C;
    float factor = t == ignore_idx ? 0.f : scale;
    if (class_wts != nullptr) factor *= in_range ? class_wts[t] : 0.f;
    float m = 0.f, inv_s = 0.f;
    if (factor != 0.f) {
      Taps<kTaps> taps;
      taps.load(tap_idx, tap_wt, j);
      float s, sum;
      taps.softmax_stats(h, C, m, s, sum);
      inv_s = 1.f / s;
    }
    px_m[j] = m;
    px_inv[j] = inv_s;
    px_f[j] = factor;
    px_t[j] = in_range ? static_cast<int>(t) : -1;
  }
  __syncthreads();

  // thread (c0, jl) fills G[c0 + i * c_step, jl] of each chunk: a warp covers 32
  // neighbouring pixels of one class, so its G writes are contiguous and its
  // reads of the row mostly hit one address
  const float smooth = ls > 0.f ? ls / static_cast<float>(C) : 0.f;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int jl = threadIdx.x % kChunk, c0 = threadIdx.x / kChunk;
  const int c_step = blockDim.x / kChunk;
  const int n_chunks = (W + kChunk - 1) / kChunk;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int j = ch * kChunk + jl;
    const int* ptr = col_ptr + ch * (w + 1);
    if (warp == 0) {  // published by the barrier after the G pass
      int lo = w, hi = 0;
      for (int k = lane; k < w; k += kWarp) {
        if (ptr[k + 1] > ptr[k]) {
          lo = min(lo, k);
          hi = k + 1;
        }
      }
      for (int o = kWarp / 2; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        k_range[0] = lo;
        k_range[1] = hi;
      }
    }
    if (j < W) {
      const float factor = px_f[j];
      if (factor == 0.f) {
        for (int c = c0; c < C; c += c_step) g[c * ld + jl] = 0.f;
      } else {
        Taps<kTaps> taps;
        taps.load(tap_idx, tap_wt, j);
        const float m = px_m[j], inv_s = px_inv[j];
        const int t = px_t[j];
        for (int c = c0; c < C; c += c_step) {
          float d = expf(taps.col(h, c, C) - m) * inv_s - smooth;
          if (c == t) d -= 1.f - ls;
          g[c * ld + jl] = d * factor;
        }
      }
    }
    __syncthreads();
    // dhm[k, c] += sum over this chunk's j of A_w[j, k] * G[j, c], in j order,
    // for the columns the chunk touches (a bilinear upsample's chunk of 64
    // output columns touches w/W*64 + 2 of them); lanes over c read G with the
    // stride kChunk + 1, so they hit distinct banks
    for (int e = k_range[0] * C + threadIdx.x; e < k_range[1] * C; e += blockDim.x) {
      const int k = e / C, c = e - k * C;
      float a = acc[e];
      for (int q = ptr[k]; q < ptr[k + 1]; ++q) a = fmaf(col_wt[q], g[c * ld + col_j[q]], a);
      acc[e] = a;
    }
    __syncthreads();
  }
  float* drow = dhm + row * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) drow[e] = acc[e];
}

size_t fwd_smem(int w, int C) {
  return (static_cast<size_t>(w) * C + kThreads / kWarp) * sizeof(float) +
         (kThreads / kWarp) * sizeof(int);
}

size_t bwd_smem(int w, int W, int C) {
  return (2 * static_cast<size_t>(w) * C + static_cast<size_t>(C) * (kChunk + 1) +
          4 * static_cast<size_t>(W)) * sizeof(float);
}

template <int kTaps>
int launch_fwd(const float* hmid, const long long* target, const int* tap_idx,
               const float* tap_wt, const float* class_wts, float* partial_loss,
               int* partial_cnt, float* out, int rows, int w, int W, int C,
               int ignore_idx, float ls, cudaStream_t stream) {
  const size_t smem = fwd_smem(w, C);
  cudaError_t err = cudaFuncSetAttribute(seg_ce_fwd_kernel<kTaps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_ce_fwd_kernel<kTaps><<<rows, kThreads, smem, stream>>>(
      hmid, target, tap_idx, tap_wt, class_wts, partial_loss, partial_cnt, w, W, C,
      ignore_idx, ls);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_ce_reduce_kernel<<<1, kReduceThreads, 0, stream>>>(partial_loss, partial_cnt,
                                                         rows, out);
  return static_cast<int>(cudaGetLastError());
}

template <int kTaps>
int launch_bwd(const float* hmid, const long long* target, const int* tap_idx,
               const float* tap_wt, const int* col_ptr, const int* col_j,
               const float* col_wt, const float* class_wts,
               const float* scale, float* dhm, int rows, int w, int W, int C,
               int ignore_idx, float ls, cudaStream_t stream) {
  const size_t smem = bwd_smem(w, W, C);
  cudaError_t err = cudaFuncSetAttribute(seg_ce_bwd_kernel<kTaps>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  seg_ce_bwd_kernel<kTaps><<<rows, kBwdThreads, smem, stream>>>(
      hmid, target, tap_idx, tap_wt, col_ptr, col_j, col_wt, class_wts, scale,
      dhm, w, W, C, ignore_idx, ls);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes. `taps` is 2, 4, 8 or 16; class_wts
// may be null. They launch on `stream` without synchronising and return
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported `taps`).
extern "C" int seg_ce_forward(const void* hmid, const void* target, const void* tap_idx,
                              const void* tap_wt, int taps, const void* class_wts,
                              void* partial_loss, void* partial_cnt, void* out, int rows,
                              int w, int W, int C, int ignore_idx, float ls,
                              void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(static_cast<const float*>(hmid), static_cast<const long long*>(target),
                  static_cast<const int*>(tap_idx), static_cast<const float*>(tap_wt),
                  static_cast<const float*>(class_wts), static_cast<float*>(partial_loss),
                  static_cast<int*>(partial_cnt), static_cast<float*>(out), rows, w, W, C,
                  ignore_idx, ls, st);
  };
  switch (taps) {
    case 2: return args(launch_fwd<2>);
    case 4: return args(launch_fwd<4>);
    case 8: return args(launch_fwd<8>);
    case 16: return args(launch_fwd<16>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int seg_ce_backward(const void* hmid, const void* target, const void* tap_idx,
                               const void* tap_wt, int taps, const void* col_ptr,
                               const void* col_j, const void* col_wt, const void* class_wts,
                               const void* scale, void* dhm, int rows, int w, int W, int C,
                               int ignore_idx, float ls, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto launch) {
    return launch(static_cast<const float*>(hmid), static_cast<const long long*>(target),
                  static_cast<const int*>(tap_idx), static_cast<const float*>(tap_wt),
                  static_cast<const int*>(col_ptr), static_cast<const int*>(col_j),
                  static_cast<const float*>(col_wt),
                  static_cast<const float*>(class_wts), static_cast<const float*>(scale),
                  static_cast<float*>(dhm), rows, w, W, C, ignore_idx, ls, st);
  };
  switch (taps) {
    case 2: return args(launch_bwd<2>);
    case 4: return args(launch_bwd<4>);
    case 8: return args(launch_bwd<8>);
    case 16: return args(launch_bwd<16>);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
