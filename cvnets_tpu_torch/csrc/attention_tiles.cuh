// Tiles, fragments and warp products shared by the attention kernels of this
// directory (mha_attention.cu, window_attention.cu). A block is four warps over
// a 64-row tile, each warp owning 16 rows (the MHA kernels' bf16 blocks hold
// more rows, in as many warps); bfloat16 products run on the tensor cores
// through mma.sync m16n8k16, float32 ones on FMAs over shared memory. Every
// bf16 fragment comes from ldmatrix (mm_abt_ldsm, ldsm_rows with mm_abt_regs,
// mm_pm_ldsm) and every bf16 tile from cp.async, in the MHA and the window
// kernels, forward and backward.
// Everything is in an anonymous namespace: each source that includes this is
// built into a library of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;               // query rows and key rows of a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kTile / kWarps;   // rows of a tile owned by one warp (16)

// Batch and token strides (in elements) of each (B, S, H*D) tensor argument.
struct Strides {
  long long b[8];
  long long s[8];
};

__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU, one instruction (exp2f without fast math adds a denormal
// guard); -inf gives +0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [0, rows) of one head's (64 x D) tile into shared memory (leading
// dimension ld) and zero the rest. src points at the tile's first element and
// ss is the token stride. vec: 16-byte loads (pointers and strides aligned).
template <typename T, int D>
__device__ void load_tile(T* dst, int ld, const T* src, long long ss, int rows, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = D / kVec;
    for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
      const int r = i / kPerRow, c = (i % kPerRow) * kVec;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * ss + c);
      *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D, c = i % D;
      dst[r * ld + c] = r < rows ? src[r * ss + c] : from_f32<T>(0.f);
    }
  }
}

// cp.async: copies from device to shared memory that bypass the registers and
// complete in the background; a thread waits for its own with cp_async_wait,
// and a barrier after that makes every thread's copies visible to the block.
// cp_async_16 with `bytes` 0 reads nothing and writes 16 zero bytes.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are still in flight
template <int N = 0>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// load_tile for a tile of kR rows and a block of kN threads, copied with
// cp.async (zero-filled past `rows`) when vec, else loaded and stored at once.
template <int D, int kR, int kN>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src, long long ss,
                                                int rows, bool vec) {
  if (vec) {
    constexpr int kPerRow = D / 8;
    for (int i = threadIdx.x; i < kR * kPerRow; i += kN) {
      const int r = i / kPerRow, c = (i % kPerRow) * 8;
      const bool ok = r < rows;
      cp_async_16(dst + r * ld + c, src + (ok ? r : 0) * ss + c, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kR * D; i += kN) {
      const int r = i / D, c = i % D;
      dst[r * ld + c] = r < rows ? src[r * ss + c] : from_f32<bf16>(0.f);
    }
  }
}

// ============================================================ bfloat16: mma.sync
//
// Fragments of mma.m16n8k16 (PTX ISA), with g = lane / 4 and t = lane % 4:
//   A (16 x 16): a[0] (row g, cols 2t, 2t+1), a[1] (row g+8, same cols),
//                a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8):  b[0] (rows k = 2t, 2t+1, col n = g), b[1] (rows 2t+8, 2t+9);
//   C (16 x 8):  c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row g+8, same).
// A warp's 16 x 64 tile is 8 C fragments, c[j] covering columns 8j .. 8j+7, so
// its element e sits at row g + 8 (e / 2), column 8j + 2t + e % 2.

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory into one register
// each. Lane l gives the address of row l % 8 of matrix l / 8; rows are 16
// bytes, 16-byte aligned. Lane (g, t) receives elements (g, 2t) and (g, 2t + 1)
// of each matrix, or with .trans (2t, g) and (2t + 1, g): exactly the A and B
// fragments of mma.m16n8k16, one instruction where 32- and 16-bit shared
// loads take four to sixteen. A row pitch of D + 8 elements puts the 8 rows of a matrix in 8
// different 16-byte bank groups, so the loads are free of bank conflicts.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc (16 x N) = A . B^T over N columns (a multiple of 16; the default, 64,
// is a whole tile), fragments by ldmatrix. A (the warp's 16 rows) and B (N
// rows) are row-major bf16 in shared memory, D wide, pitch ld.
template <int D, int N = kTile>
__device__ __forceinline__ void mm_abt_ldsm(float (&acc)[N / 8][4], const bf16* A, const bf16* B,
                                            int ld, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // A: matrices (rows 0-7, 8-15) x (cols 0-7, 8-15), in a[0..3] order
  const bf16* a_src = A + (lane % 16) * ld + (lane / 16) * 8;
  // B: rows 8j + (0-7) and 8(j+1) + (0-7), each at cols 0-7 and 8-15
  const bf16* b_src = B + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_src + 16 * kk);
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, b_src + 8 * j * ld + 16 * kk);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma(acc[j], a, b0);
      mma(acc[j + 1], a, b1);
    }
  }
}

// The A fragments of a warp's 16 rows (row-major, D wide, pitch ld), one
// ldmatrix.x4 per 16 columns: a[kk] is the 16 x 16 block kk.
template <int D>
__device__ __forceinline__ void ldsm_rows(uint32_t (&a)[D / 16][4], const bf16* A, int ld,
                                          int lane) {
  const bf16* src = A + (lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(a[kk], src + 16 * kk);
}

// acc (16 x 64) = A . B^T as mm_abt_ldsm, A's fragments already in registers
// (ldsm_rows); B is 64 x D. Columns from n_valid on (rows of B past S) are
// left 0 and cost no products.
template <int D>
__device__ __forceinline__ void mm_abt_regs(float (&acc)[kTile / 8][4],
                                            const uint32_t (&a)[D / 16][4], const bf16* B, int ld,
                                            int lane, int n_valid) {
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const bf16* b_src = B + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kTile / 8; j += 2) {
      if (8 * j >= n_valid) break;
      uint32_t b[4];
      ldsm_x4(b, b_src + 8 * j * ld + 16 * kk);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma(acc[j], a[kk], b0);
      mma(acc[j + 1], a[kk], b1);
    }
  }
}

// acc (16 x D) += P . M over K rows of M (a multiple of 16; the default, 64,
// is a whole tile), M's fragments by ldmatrix.trans. P is a 16 x K tile in C
// fragments, rounded to bf16 here; M is row-major bf16 in shared memory, pitch
// ld. P's columns from k_valid on must be 0; their 16-wide steps are skipped.
template <int D, int K = kTile>
__device__ __forceinline__ void mm_pm_ldsm(float (&acc)[D / 8][4], const float (&p)[K / 8][4],
                                           const bf16* M, int ld, int lane, int k_valid = K) {
  // matrices (rows 16kk + 0-7, 8-15) x (cols 8j + 0-7, 8(j+1) + 0-7)
  const bf16* m_src = M + (lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if (16 * kk >= k_valid) break;
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
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

// Write the warp's 16 x D accumulator rows (scaled by 1 / div per row) to a
// (B, S, H*D) bf16 tensor; rows at or past `rows` are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long ss, int r0, int rows,
                                           const float (&acc)[D / 8][4], const float (&div)[2],
                                           int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= rows) continue;
    bf16* row = dst + r * ss + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[j][2 * i] / div[i], acc[j][2 * i + 1] / div[i]);
  }
}

template <int D>
struct Bf16Tiles {
  static constexpr int kLd = D + 8;  // staggers rows across banks; fragment loads are conflict-free
  static constexpr int kBytes = kTile * kLd * 2;
};

// ============================================================ float32: FMAs

// C (16 x 64, ldc) = A (16 x D) . B^T, with B (64 x D); A points at the warp's rows.
template <int D>
__device__ void f32_abt(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < kRows; ++r) {
    for (int n = lane; n < kTile; n += 32) {
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < D; ++k) acc = fmaf(A[r * lda + k], B[n * ldb + k], acc);
      C[r * ldc + n] = acc;
    }
  }
}

// A 16 x D float32 accumulator of one warp: acc += A (16 x 64) . B (64 x D).
// Lane holds elements e = 32 i + lane of the row-major block.
template <int D>
struct F32Acc {
  float v[kRows * D / 32];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < kRows * D / 32; ++i) v[i] = 0.f;
  }
  __device__ void load(const float* C, int ldc) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < kRows * D / 32; ++i) {
      const int e = 32 * i + lane;
      v[i] = C[(e / D) * ldc + e % D];
    }
  }
  __device__ void store(float* C, int ldc) const {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < kRows * D / 32; ++i) {
      const int e = 32 * i + lane;
      C[(e / D) * ldc + e % D] = v[i];
    }
  }
  __device__ void mma(const float* A, int lda, const float* B, int ldb) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < kRows * D / 32; ++i) {
      const int e = 32 * i + lane, r = e / D, d = e % D;
      float acc = v[i];
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) acc = fmaf(A[r * lda + k], B[k * ldb + d], acc);
      v[i] = acc;
    }
  }
  // acc += A . B with A given transposed: At is 64 x 16, A[r][k] = At[k * ldat + r]
  __device__ void mma_at(const float* At, int ldat, const float* B, int ldb) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < kRows * D / 32; ++i) {
      const int e = 32 * i + lane, r = e / D, d = e % D;
      float acc = v[i];
#pragma unroll 8
      for (int k = 0; k < kTile; ++k) acc = fmaf(At[k * ldat + r], B[k * ldb + d], acc);
      v[i] = acc;
    }
  }
};

// ------------------------------------------------------------------ host side

// 16-byte loads when every tensor's base and strides allow them (the head
// offset h*D is a multiple of 8 elements for every supported D).
template <typename T>
bool aligned(const void* const* ptrs, const Strides& st, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
    if ((st.b[i] * static_cast<long long>(sizeof(T))) % 16 != 0) return false;
    if ((st.s[i] * static_cast<long long>(sizeof(T))) % 16 != 0) return false;
  }
  return true;
}

Strides read_strides(const long long* strides, int n) {
  Strides st{};
  for (int i = 0; i < n; ++i) {
    st.b[i] = strides[2 * i];
    st.s[i] = strides[2 * i + 1];
  }
  return st;
}

}  // namespace
