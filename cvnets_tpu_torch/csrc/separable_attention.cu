// Fused MobileViTv2 separable self-attention, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cvnets_tpu/ops/pallas/mobilevit_attn.py
// (_attn_kernel, launched by _pallas_forward). For each (batch*patch) row:
//   s   = softmax over the N tokens of q (N, 1)
//   ctx = sum_n k[n, :] * s[n]                       (1, C)
//   out = relu(v) * ctx                              (N, C)
// with all arithmetic in float32 and the output in the input dtype.
//
// What bounds it: memory. Per row it reads N q values plus 2*N*C of k and v and
// writes N*C, for about 4 flops per element of k/v, far under the ~295
// flops/byte at which an H100 stops being memory-bound. The design therefore
// reads every input byte once and keeps the softmax weights on chip:
//   * one block per row, threads across C: at each token n the threads of a
//     warp read 32 neighbouring channels of k (and v), so loads coalesce;
//   * the N softmax weights live in shared memory (N floats);
//   * max and sum use warp shuffles, then one shared slot per warp.
// q, k and v may be column slices of one fused qkv projection: each is given
// by a pointer and its two outer strides (row, token); the channel stride must
// be 1. The output is contiguous (rows, N, C).
// No tensor cores, TMA or wgmma: there is no matrix product to feed them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kWarp = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Reduce one value per thread over the block (blockDim.x is a multiple of 32).
// `red` holds one float per warp; the trailing barrier lets it be reused.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x) / kWarp; ++w) {
    x = kMax ? fmaxf(x, red[w]) : x + red[w];
  }
  __syncthreads();
  return x;
}

template <typename T>
__global__ void separable_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int n, int c,
    long long q_s0, long long q_s1, long long k_s0, long long k_s1,
    long long v_s0, long long v_s1) {
  extern __shared__ float smem[];
  float* s = smem;        // n softmax weights
  float* red = smem + n;  // one slot per warp
  const long long row = blockIdx.x;
  const T* qr = q + row * q_s0;
  const T* kr = k + row * k_s0;
  const T* vr = v + row * v_s0;
  T* outr = out + row * n * c;

  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = to_f32(qr[i * q_s1]);
    s[i] = x;
    m = fmaxf(m, x);
  }
  m = block_reduce<true>(m, red);

  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float e = expf(s[i] - m);
    s[i] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = s[i] / sum;
  __syncthreads();

  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float ctx = 0.f;
    for (int i = 0; i < n; ++i) ctx += to_f32(kr[i * k_s1 + ch]) * s[i];
    for (int i = 0; i < n; ++i) {
      const float x = to_f32(vr[i * v_s1 + ch]);
      outr[static_cast<long long>(i) * c + ch] = from_f32<T>(fmaxf(x, 0.f) * ctx);
    }
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* out, int rows,
            int n, int c, long long q_s0, long long q_s1, long long k_s0,
            long long k_s1, long long v_s0, long long v_s1, cudaStream_t stream) {
  int threads = (c + kWarp - 1) / kWarp * kWarp;
  if (threads > 1024) threads = 1024;
  const size_t smem = (n + threads / kWarp) * sizeof(float);
  separable_attention_kernel<T><<<rows, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, c,
      q_s0, q_s1, k_s0, k_s1, v_s0, v_s1);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int separable_attention_forward(
    const void* q, const void* k, const void* v, void* out, int rows, int n,
    int c, long long q_s0, long long q_s1, long long k_s0, long long k_s1,
    long long v_s0, long long v_s1, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch<__nv_bfloat16>(q, k, v, out, rows, n, c, q_s0, q_s1, k_s0, k_s1,
                          v_s0, v_s1, st);
  } else if (dtype == 0) {
    launch<float>(q, k, v, out, rows, n, c, q_s0, q_s1, k_s0, k_s1, v_s0,
                  v_s1, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
