// MobileViTv2 separable self-attention, forward and backward, for Hopper (sm_90a).
//
// The forward replaces the Pallas TPU kernel cvnets_tpu/ops/pallas/mobilevit_attn.py
// (_attn_kernel, launched by _pallas_forward:44); the backward computes that
// file's _bwd (:120-134), which the JAX package leaves to XLA to fuse. For each
// (batch*patch) row of N tokens:
//   s   = softmax over the N tokens of q (N, 1)
//   ctx = sum_n s[n] k[n, :]                         (1, C)
//   out = relu(v) ctx                                (N, C)
// and, given g = dL/dout,
//   dv = g ctx [v > 0],  dctx = sum_n g relu(v),  dk = s dctx,
//   ds = sum_c dctx k,   dq = s (ds - sum_n s ds) = s (ds - sum_c dctx ctx),
// all in float32, inputs and gradients in the input dtype. q, k, v (and dq, dk,
// dv) are column views of one (rows, N, 1 + 2C) qkv tensor on the main path,
// each given by a pointer and its (row, token) strides, channel stride 1.
//
// What bounds them: memory. The forward reads q, k and v once and writes out
// (4 flops an element of k and v); the backward reads g, k and v once and
// writes dk and dv (10 bytes an element in bf16, plus q and dq), far under the
// ~295 flops a byte at which an H100 stops being memory-bound. So:
//   * the forward saves the row's softmax max and sum and ctx in float32
//     (rows x (2 + C) floats), and the backward reads them instead of another
//     pass over k: its first pass reads g and v (dv, dctx), its second k (dk, ds);
//   * a row's tokens are split over the blocks of a cluster, enough to give the
//     card two blocks an SM (DeepLabv3 has 32 rows), and over eight warps a block;
//   * 16-byte loads and stores, though k, v, dk and dv are not 16-byte aligned
//     (below).
// What is left: both run at about twice their bound at the flagship's shapes,
// where the 512 rows fill one wave of 3-4 blocks an SM and each warp waits on
// its tokens' loads one step at a time. Two or four tokens a lane in flight,
// and aligned 16-byte accesses rebuilt from two lanes' pieces by warp
// shuffles, were slower: they took registers, and so blocks an SM (PERF.md,
// the separable attention's step table). Misaligned narrow stores of dk and
// dv cost the backward about a quarter of its time at (N, C) = (256, 128).
// No tensor cores, TMA or wgmma: there is no matrix product to feed them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cooperative_groups.h>

#include <cmath>
#include <cstdint>

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

// The split-token design of both kernels.
//
// A row (one of BP) is cut into `blocks_a_row` runs of tokens, one block each;
// the blocks of a row form a thread-block cluster, so a sum over the row's N
// tokens is each block's partial in its shared memory, read by every block of
// the cluster through distributed shared memory and added in rank order: the
// same bits on every run and in every block, and no atomics. Within a block,
// eight warps walk the run's tokens; the lanes of a warp cover one token's C
// channels eight at a time (16 bytes of bf16), `w` lanes a token (C/8 rounded
// up to a power of two, at most 32), so a warp works on 32 / w tokens at once.
// k and v start one element into each token's qkv row of 1 + 2C elements, so
// no 16-byte load of them is aligned: `load8` reads the aligned 16-byte chunks
// that cover the eight elements and shifts them into place in registers.

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * kWarp;
constexpr int kVec = 8;  // channels a lane reads at once
constexpr float kLog2e = 1.4426950408889634f;

struct View {  // (row, token, channel) with channel stride 1, strides in elements
  char* p;
  long long s0, s1;
  template <typename T>
  __device__ __forceinline__ T* at(long long row, long long n, int ch) const {
    return reinterpret_cast<T*>(p) + row * s0 + n * s1 + ch;
  }
};

// Eight consecutive elements at `p`, any element-aligned address, as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint4* base = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  const int sh = static_cast<int>(addr & 15);  // bytes past the chunk, even
  const uint4 lo = __ldg(base);
  const uint4 hi = sh ? __ldg(base + 1) : lo;  // never past the chunk of element 7
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int ws = sh >> 2;
  uint32_t o[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint32_t t = w[i];
    t = ws == 1 ? w[i + 1] : t;
    t = ws == 2 ? w[i + 2] : t;
    t = ws == 3 ? w[i + 3] : t;
    o[i] = t;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t r = (sh & 2) ? __funnelshift_r(o[i], o[i + 1], 16) : o[i];
    x[2 * i] = __uint_as_float(r << 16);
    x[2 * i + 1] = __uint_as_float(r & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kVec]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint4* base = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  const int ws = static_cast<int>(addr & 15) >> 2;
  const uint4 a = __ldg(base), b = __ldg(base + 1);
  const uint4 c = ws ? __ldg(base + 2) : b;
  const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    uint32_t t = w[i];
    t = ws == 1 ? w[i + 1] : t;
    t = ws == 2 ? w[i + 2] : t;
    t = ws == 3 ? w[i + 3] : t;
    x[i] = __uint_as_float(t);
  }
}

// Eight floats to eight consecutive elements at `p`, any element-aligned
// address: one 16-byte store where `p` is aligned, else the widest aligned
// stores that cover exactly these elements (a neighbour owns the rest).
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&x)[kVec]) {
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    r[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if ((addr & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else if ((addr & 3) == 0) {
    uint32_t* d = reinterpret_cast<uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = r[i];
  } else {  // two bytes past a word: element 0, three words, element 7
    unsigned short* h = reinterpret_cast<unsigned short*>(p);
    h[0] = static_cast<unsigned short>(r[0]);
    uint32_t* d = reinterpret_cast<uint32_t*>(p + 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = __funnelshift_r(r[i], r[i + 1], 16);
    h[7] = static_cast<unsigned short>(r[3] >> 16);
  }
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kVec]) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if ((addr & 15) == 0) {
    float4* d = reinterpret_cast<float4*>(p);
    d[0] = make_float4(x[0], x[1], x[2], x[3]);
    d[1] = make_float4(x[4], x[5], x[6], x[7]);
  } else if ((addr & 7) == 0) {
    float2* d = reinterpret_cast<float2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = make_float2(x[2 * i], x[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) p[i] = x[i];
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Lanes a token: C/8 groups of eight channels rounded up to a power of two,
// at most a warp. The launch's cluster size (blocks_a_row) reads it too.
__host__ __device__ constexpr int lanes_a_token(int c) {
  int w = 1;
  while (w < c / kVec && w < kWarp) w <<= 1;
  return w;
}

// Where a lane works: the warp's tokens start at `first` and step by `stride`;
// this lane takes token `slot` of the warp's 32 / w and channel group `sub`.
struct Lanes {
  int w, slot, sub, first, stride;
  __device__ explicit Lanes(int c) {
    w = lanes_a_token(c);
    const int lane = threadIdx.x % kWarp;
    slot = lane / w;
    sub = lane % w;
    first = threadIdx.x / kWarp * (kWarp / w);
    stride = kWarps * (kWarp / w);
  }
  // the first channel of this lane's j-th group of eight, or -1 past C
  __device__ __forceinline__ int channel(int j, int c) const {
    const int ch = kVec * (sub + w * j);
    return ch < c ? ch : -1;
  }
};

// Shared memory of a block, in floats: the per-warp channel sums, this
// block's share of a sum over the row, the row's sum, the softmax pair and a
// block scratch.
struct Smem {
  float* red;   // kWarps x C
  float* part;  // C: this block's share, read by the whole cluster
  float* sum;   // C: ctx in the forward, dctx in the backward
  float* ml;    // 2: this block's max and sum of the softmax, read by the cluster
  float* tmp;   // kWarps: block_reduce's slots; sum_c dctx ctx in the backward
  __device__ Smem(float* s, int c)
      : red(s), part(s + kWarps * c), sum(part + c), ml(sum + c), tmp(ml + 2) {}
  static constexpr int floats(int c) { return (kWarps + 2) * c + 2 + kWarps; }
};

// Sum `acc` (each lane's eight channels of group j, summed over its tokens)
// over the block's tokens, then over the cluster's blocks in rank order, times
// `scale`, into out[C]. Other blocks may still read this block's partial
// when it returns: the caller passes a later cluster barrier before the
// block's shared memory is reused or the block exits.
template <int J>
__device__ void channel_sum(float (&acc)[J][kVec], const Lanes& ln, int c, float* red,
                            float* part, float* out, float scale,
                            cooperative_groups::cluster_group& cluster) {
  const int warp = threadIdx.x / kWarp;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      for (int o = ln.w; o < kWarp; o <<= 1) acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], o);
    }
    const int ch = ln.channel(j, c);
    if (ln.slot == 0 && ch >= 0) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) red[warp * c + ch + i] = acc[j][i];
    }
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float s = red[ch];
    for (int w = 1; w < kWarps; ++w) s += red[w * c + ch];
    part[ch] = s;
  }
  cluster.sync();
  const int blocks = static_cast<int>(cluster.num_blocks());
  for (int ch = threadIdx.x; ch < c; ch += kThreads) {
    float s = 0.f;
    for (int r = 0; r < blocks; ++r) s += cluster.map_shared_rank(part, r)[ch];
    out[ch] = s * scale;
  }
}

// The softmax of q over the row: (max, sum of exp(q - max)) of the block's
// tokens, combined over the cluster's blocks in rank order.
template <typename T>
__device__ float2 softmax_stats(const View& q, long long row, int n0, int n1, Smem& sm,
                                cooperative_groups::cluster_group& cluster) {
  float m = -INFINITY;
  for (int n = n0 + threadIdx.x; n < n1; n += kThreads) m = fmaxf(m, to_f32(*q.at<const T>(row, n, 0)));
  m = block_reduce<true>(m, sm.tmp);
  float l = 0.f;
  for (int n = n0 + threadIdx.x; n < n1; n += kThreads) {
    l += exp2f((to_f32(*q.at<const T>(row, n, 0)) - m) * kLog2e);
  }
  l = block_reduce<false>(l, sm.tmp);
  if (threadIdx.x == 0) {
    sm.ml[0] = m;
    sm.ml[1] = l;
  }
  cluster.sync();
  const int blocks = static_cast<int>(cluster.num_blocks());
  float big = -INFINITY;
  for (int r = 0; r < blocks; ++r) big = fmaxf(big, cluster.map_shared_rank(sm.ml, r)[0]);
  float sum = 0.f;
  for (int r = 0; r < blocks; ++r) {
    const float* p = cluster.map_shared_rank(sm.ml, r);
    if (p[1] > 0.f) sum += p[1] * exp2f((p[0] - big) * kLog2e);
  }
  return make_float2(big, sum);
}

// ctx[C] = sum over the row's tokens of softmax(q)[n] * k[n, :], into sm.sum.
template <typename T, int J>
__device__ void context(const View& q, const View& k, long long row, int n0, int n1, int c,
                        float2 ml, const Lanes& ln, Smem& sm,
                        cooperative_groups::cluster_group& cluster) {
  float acc[J][kVec] = {};
  const float m2 = ml.x * kLog2e;
  for (int base = n0 + ln.first; base < n1; base += ln.stride) {
    const int n = base + ln.slot;
    if (n >= n1) continue;
    const float e = exp2f(to_f32(*q.at<const T>(row, n, 0)) * kLog2e - m2);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int ch = ln.channel(j, c);
      if (ch < 0) continue;
      float x[kVec];
      load8(k.at<const T>(row, n, ch), x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[j][i] += e * x[i];
    }
  }
  channel_sum<J>(acc, ln, c, sm.red, sm.part, sm.sum, 1.f / ml.y, cluster);
}

// The row's cut into runs of tokens, one a block of the cluster.
struct Run {
  long long row;
  int rank, n0, n1;
  __device__ Run(const cooperative_groups::cluster_group& cluster, int n) {
    const int blocks = static_cast<int>(cluster.num_blocks());
    row = blockIdx.x / blocks;
    rank = static_cast<int>(cluster.block_rank());
    const int per = (n + blocks - 1) / blocks;
    n0 = min(n, rank * per);
    n1 = min(n, n0 + per);
  }
};

// This lane's eight channels of group j of a C-float array in shared memory.
template <int J>
__device__ __forceinline__ void lane_channels(const float* src, const Lanes& ln, int c,
                                              float (&x)[J][kVec]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int ch = ln.channel(j, c);
#pragma unroll
    for (int i = 0; i < kVec; ++i) x[j][i] = ch >= 0 ? src[ch + i] : 0.f;
  }
}

struct FwdArgs {
  View q, k, v, out;
  float* stats;  // (rows, 2): the softmax's max and sum, for the backward
  float* ctx;    // (rows, C): ctx in float32, for the backward
  int n, c;
};

template <typename T, int J>
__global__ void __launch_bounds__(kThreads) separable_attention_fwd_kernel(FwdArgs a) {
  extern __shared__ float smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  Smem sm(smem, a.c);
  const Lanes ln(a.c);
  const Run run(cluster, a.n);
  const int c = a.c;
  const float2 ml = softmax_stats<T>(a.q, run.row, run.n0, run.n1, sm, cluster);
  context<T, J>(a.q, a.k, run.row, run.n0, run.n1, c, ml, ln, sm, cluster);
  cluster_arrive();  // this block is done reading the cluster's partials
  __syncthreads();
  if (run.rank == 0) {
    for (int ch = threadIdx.x; ch < c; ch += kThreads) a.ctx[run.row * c + ch] = sm.sum[ch];
    if (threadIdx.x == 0) {
      a.stats[2 * run.row] = ml.x;
      a.stats[2 * run.row + 1] = ml.y;
    }
  }
  float cx[J][kVec];
  lane_channels<J>(sm.sum, ln, c, cx);
  for (int base = run.n0 + ln.first; base < run.n1; base += ln.stride) {
    const int n = base + ln.slot;
    if (n >= run.n1) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int ch = ln.channel(j, c);
      if (ch < 0) continue;
      float x[kVec];
      load8(a.v.at<const T>(run.row, n, ch), x);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = fmaxf(x[i], 0.f) * cx[j][i];
      store8(a.out.at<T>(run.row, n, ch), x);
    }
  }
  cluster_wait();  // no block leaves while another may read its shared memory
}

struct BwdArgs {
  View q, k, v, g, dq, dk, dv;
  const float* stats;  // (rows, 2) and
  const float* ctx;    // (rows, C): the forward's
  int n, c;
};

// The VJP for one run of a row's tokens: pass 1 reads g and v, writes dv and
// sums dctx over the row; pass 2 reads k, writes dk and, from ds, dq.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads) separable_attention_bwd_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  Smem sm(smem, a.c);
  const Lanes ln(a.c);
  const Run run(cluster, a.n);
  const int c = a.c;
  const float m2 = a.stats[2 * run.row] * kLog2e, inv = 1.f / a.stats[2 * run.row + 1];
  float cx[J][kVec];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int ch = ln.channel(j, c);
#pragma unroll
    for (int i = 0; i < kVec; ++i) cx[j][i] = ch >= 0 ? a.ctx[run.row * c + ch + i] : 0.f;
  }

  // pass 1: dv, and this block's share of dctx
  float acc[J][kVec] = {};
  for (int base = run.n0 + ln.first; base < run.n1; base += ln.stride) {
    const int n = base + ln.slot;
    if (n >= run.n1) continue;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int ch = ln.channel(j, c);
      if (ch < 0) continue;
      float gv[kVec], vv[kVec], d[kVec];
      load8(a.g.at<const T>(run.row, n, ch), gv);
      load8(a.v.at<const T>(run.row, n, ch), vv);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        d[i] = vv[i] > 0.f ? gv[i] * cx[j][i] : 0.f;
        acc[j][i] += gv[i] * fmaxf(vv[i], 0.f);
      }
      store8(a.dv.at<T>(run.row, n, ch), d);
    }
  }
  channel_sum<J>(acc, ln, c, sm.red, sm.part, sm.sum, 1.f, cluster);
  cluster_arrive();  // this block is done reading the cluster's partials
  __syncthreads();

  // sum_n s ds = sum_c dctx ctx, by warp 0 in a fixed order
  if (threadIdx.x < kWarp) {
    float t = 0.f;
    for (int ch = threadIdx.x; ch < c; ch += kWarp) t += sm.sum[ch] * a.ctx[run.row * c + ch];
    for (int o = kWarp / 2; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) sm.tmp[0] = t;
  }
  __syncthreads();
  const float sds = sm.tmp[0];

  // pass 2: dk and dq
  float dc[J][kVec];
  lane_channels<J>(sm.sum, ln, c, dc);
  for (int base = run.n0 + ln.first; base < run.n1; base += ln.stride) {
    const int n = base + ln.slot;
    const bool live = n < run.n1;
    float s = 0.f, ds = 0.f;
    if (live) {
      s = exp2f(to_f32(*a.q.at<const T>(run.row, n, 0)) * kLog2e - m2) * inv;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int ch = ln.channel(j, c);
        if (ch < 0) continue;
        float kv[kVec], d[kVec];
        load8(a.k.at<const T>(run.row, n, ch), kv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          d[i] = s * dc[j][i];
          ds += dc[j][i] * kv[i];
        }
        store8(a.dk.at<T>(run.row, n, ch), d);
      }
    }
    // every lane of the warp takes part: the loop's trip count is the warp's
    for (int o = ln.w / 2; o > 0; o >>= 1) ds += __shfl_xor_sync(0xffffffffu, ds, o);
    if (live && ln.sub == 0) *a.dq.at<T>(run.row, n, 0) = from_f32<T>(s * (ds - sds));
  }
  cluster_wait();  // no block leaves while another may read its shared memory
}

int num_sms() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Blocks a row (the cluster size): the fewest powers of two, at most 8, that
// give the card two blocks an SM, while each block keeps two steps of tokens
// (eight warps' worth each) or more.
int blocks_a_row(int rows, int n, int c) {
  const int step = kWarps * (kWarp / lanes_a_token(c));
  int s = 1;
  while (s < 8 && static_cast<long long>(rows) * s < 2LL * num_sms() && n >= 2 * s * step) s *= 2;
  return s;
}

template <typename Args>
cudaError_t launch_cluster(void (*kernel)(Args), const Args& args, int rows, int n, int c,
                           cudaStream_t stream) {
  const int s = blocks_a_row(rows, n, c);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) * s);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Smem::floats(c) * sizeof(float);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args);
}

// What the kernels take: dtype 0 (float32) or 1 (bfloat16), C a multiple of
// 8 up to 512 (at most two groups of eight channels a lane).
bool takes(int dtype, int c) {
  return (dtype == 0 || dtype == 1) && c > 0 && c % kVec == 0 && c <= 2 * kWarp * kVec;
}

View view(const void* const* ptrs, const long long* strides, int i) {
  return View{static_cast<char*>(const_cast<void*>(ptrs[i])), strides[2 * i], strides[2 * i + 1]};
}

}  // namespace

// Plain C entry points, bound with ctypes; each launches on `stream` without
// synchronising and returns the launch's cudaError. ptrs are the tensors'
// data pointers, strides their (row, token) strides in elements, two a tensor
// in the same order. dtype: 0 = float32, 1 = bfloat16.

// ptrs: q, k, v, out. Writes out, stats (rows, 2) and ctx (rows, C) float32.
extern "C" int separable_attention_forward(const void* const* ptrs, const long long* strides,
                                           float* stats, float* ctx, int rows, int n, int c,
                                           int dtype, void* stream) {
  if (!takes(dtype, c)) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = c > kWarp * kVec;
  void (*kernel)(FwdArgs) =
      dtype == 1 ? (wide ? separable_attention_fwd_kernel<__nv_bfloat16, 2>
                         : separable_attention_fwd_kernel<__nv_bfloat16, 1>)
                 : (wide ? separable_attention_fwd_kernel<float, 2>
                         : separable_attention_fwd_kernel<float, 1>);
  const FwdArgs a{view(ptrs, strides, 0), view(ptrs, strides, 1), view(ptrs, strides, 2),
                  view(ptrs, strides, 3), stats, ctx, n, c};
  const cudaError_t err = launch_cluster(kernel, a, rows, n, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// ptrs: q, k, v, g, dq, dk, dv. Reads the forward's stats and ctx.
extern "C" int separable_attention_backward(const void* const* ptrs, const long long* strides,
                                            const float* stats, const float* ctx, int rows,
                                            int n, int c, int dtype, void* stream) {
  if (!takes(dtype, c)) return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = c > kWarp * kVec;
  void (*kernel)(BwdArgs) =
      dtype == 1 ? (wide ? separable_attention_bwd_kernel<__nv_bfloat16, 2>
                         : separable_attention_bwd_kernel<__nv_bfloat16, 1>)
                 : (wide ? separable_attention_bwd_kernel<float, 2>
                         : separable_attention_bwd_kernel<float, 1>);
  BwdArgs a{};
  View* views[7] = {&a.q, &a.k, &a.v, &a.g, &a.dq, &a.dk, &a.dv};
  for (int i = 0; i < 7; ++i) *views[i] = view(ptrs, strides, i);
  a.stats = stats;
  a.ctx = ctx;
  a.n = n;
  a.c = c;
  const cudaError_t err = launch_cluster(kernel, a, rows, n, c, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
