// JPEG decode on the card (nvJPEG) and the crop -> resize -> flip kernel of the
// port's native data path (cvnets_tpu_torch/native/__init__.py).
//
// Replaces the JAX package's host library cvnets_tpu/native/decode.cpp
// (decode_one, :118-210, on a C++ thread pool over libjpeg): no TPU kernel.
// The card machine has no libjpeg but has nvJPEG, part of the CUDA toolkit.
//
// Host side (jd_*): one nvJPEG handle and two JPEG states per Decoder, which
// one thread uses at a time. jd_info reads each header (nvjpegGetImageInfo);
// jd_decode decodes the three-component images of a batch in one
// nvjpegDecodeBatched call (default backend, interleaved RGB) into the
// caller's device raster buffer, at the offsets it gives, and the grayscale
// ones one by one as luma (nvjpegDecode, NVJPEG_OUTPUT_Y). A JPEG nvJPEG
// rejects gets status 0: if the batched call fails, its images are decoded
// one by one to find which. Four-component files (CMYK, YCCK) get status 0,
// as libjpeg's JCS_RGB conversion refuses them in decode.cpp.
//
// The kernel (crop_resize_flip): one launch a batch, a block an output row of
// an image, a thread an output pixel (all three channels). It follows
// decode_one step by step: the crop clamp (:138-147); the prescale to the
// coarsest 1/2^k raster that covers the output (:151-155), where libjpeg's
// scaled IDCT, which nvJPEG lacks, is emulated by the rounded mean of each
// denom x denom box of the full raster; the crop's integer division into that
// raster (:161-168); area averaging where the crop is at least 1.5x the output
// on both sides, bilinear otherwise (:201), with resize_area's (:43-74) and
// resize_bilinear's (:76-110) float arithmetic, each operation an _rn
// intrinsic so that nvcc contracts nothing into an FMA (the plain version in
// native/plain.py rounds each operation too, and gives the same bits); the
// mirror written while storing (ox = out_w - 1 - x). A failed image is zeros.
//
// Bound: bytes. It reads the crop's part of each raster once (the prescale's
// boxes tile it) and writes the uint8 NCHW batch; a few integer operations a
// byte. Design: a raster read through the L1 cache (a bilinear tap's four
// pixels and an area box's rows are shared by neighbouring threads), stores
// of a row's pixels by neighbouring threads to neighbouring bytes. Simple and
// right first: no shared-memory staging, no vector loads.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kParams = 10;  // offset, W, H, channels, cx, cy, cw, ch, flip, ok
constexpr int kThreads = 128;
constexpr int kNvjpegError = 1000;  // returned codes above it: 1000 + nvjpegStatus_t

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t batched = nullptr;  // nvjpegDecodeBatched's state
  nvjpegJpegState_t single = nullptr;   // nvjpegDecode's: grayscale, isolating a failure
  int batch_size = 0;                   // the batch `batched` was initialised for
};

void destroy(Decoder* d) {
  if (d->batched != nullptr) nvjpegJpegStateDestroy(d->batched);
  if (d->single != nullptr) nvjpegJpegStateDestroy(d->single);
  if (d->handle != nullptr) nvjpegDestroy(d->handle);
  delete d;
}

struct Plan {
  int denom, x, y, w, h;
  bool area;
};

// decode.cpp:138-172 and :201 for an image of W x H and the crop (cx, cy, cw, ch)
__device__ Plan make_plan(int W, int H, int cx, int cy, int cw, int ch, int out_h,
                          int out_w) {
  if (cw <= 0 || ch <= 0) {
    cx = cy = 0;
    cw = W;
    ch = H;
  }
  cx = max(0, min(cx, W - 1));
  cy = max(0, min(cy, H - 1));
  cw = max(1, min(cw, W - cx));
  ch = max(1, min(ch, H - cy));
  int denom = 1;
  while (denom < 8 && cw / (denom * 2) >= out_w && ch / (denom * 2) >= out_h) denom *= 2;
  const int dec_w = (W + denom - 1) / denom, dec_h = (H + denom - 1) / denom;
  Plan p;
  p.denom = denom;
  p.x = min(cx / denom, dec_w - 1);
  p.y = min(cy / denom, dec_h - 1);
  p.w = min(max(1, cw / denom), dec_w - p.x);
  p.h = min(max(1, ch / denom), dec_h - p.y);
  p.area = p.w >= out_w * 3 / 2 && p.h >= out_h * 3 / 2;
  return p;
}

// pixel (px, py) of the raster prescaled by denom: the rounded mean of the valid
// part of its box, each channel (a grayscale raster gives its luma three times)
__device__ __forceinline__ void prescaled(const uint8_t* img, int W, int H, int chans,
                                          int denom, int px, int py, int v[3]) {
  const int x0 = px * denom, y0 = py * denom;
  const int x1 = min(x0 + denom, W), y1 = min(y0 + denom, H);
  unsigned s[3] = {0u, 0u, 0u};
  for (int y = y0; y < y1; ++y) {
    const uint8_t* row = img + (static_cast<size_t>(y) * W + x0) * chans;
    for (int x = 0; x < x1 - x0; ++x) {
      const uint8_t* px_ = row + x * chans;
      s[0] += px_[0];
      s[1] += px_[chans == 3 ? 1 : 0];
      s[2] += px_[chans == 3 ? 2 : 0];
    }
  }
  const unsigned n = static_cast<unsigned>((y1 - y0) * (x1 - x0));
  for (int c = 0; c < 3; ++c) v[c] = static_cast<int>((s[c] + n / 2) / n);
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return static_cast<uint8_t>(static_cast<int>(v));  // truncation, as static_cast<uint8_t>
}

__global__ void __launch_bounds__(kThreads) crop_resize_flip_kernel(
    const uint8_t* __restrict__ raster, const long long* __restrict__ params, int out_h,
    int out_w, uint8_t* __restrict__ out) {
  const int b = blockIdx.y, oy = blockIdx.x;
  const long long* p = params + static_cast<size_t>(b) * kParams;
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  uint8_t* dst = out + static_cast<size_t>(b) * 3 * plane + static_cast<size_t>(oy) * out_w;
  if (p[9] == 0) {  // a failed decode: zeros
    for (int x = threadIdx.x; x < out_w; x += blockDim.x) {
      dst[x] = 0;
      dst[plane + x] = 0;
      dst[2 * plane + x] = 0;
    }
    return;
  }
  const uint8_t* img = raster + p[0];
  const int W = static_cast<int>(p[1]), H = static_cast<int>(p[2]);
  const int chans = static_cast<int>(p[3]);
  const bool flip = p[8] != 0;
  const Plan pl = make_plan(W, H, static_cast<int>(p[4]), static_cast<int>(p[5]),
                            static_cast<int>(p[6]), static_cast<int>(p[7]), out_h, out_w);
  const float sy = __fdiv_rn(static_cast<float>(pl.h), static_cast<float>(out_h));
  const float sx = __fdiv_rn(static_cast<float>(pl.w), static_cast<float>(out_w));

  // this row's source rows (the same for every thread of the block)
  int ry0, ry1;
  float fy = 0.0f;
  if (pl.area) {
    ry0 = static_cast<int>(__fmul_rn(static_cast<float>(oy), sy));
    ry1 = static_cast<int>(__fmul_rn(static_cast<float>(oy + 1), sy));
    if (ry1 <= ry0) ry1 = ry0 + 1;
    if (ry1 > pl.h) ry1 = pl.h;
  } else {
    float cy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(oy), 0.5f), sy), 0.5f);
    cy = fmaxf(0.0f, fminf(cy, static_cast<float>(pl.h - 1)));
    ry0 = static_cast<int>(cy);
    ry1 = min(ry0 + 1, pl.h - 1);
    fy = __fsub_rn(cy, static_cast<float>(ry0));
  }

  for (int x = threadIdx.x; x < out_w; x += blockDim.x) {
    uint8_t v[3];
    if (pl.area) {
      const int x0 = static_cast<int>(__fmul_rn(static_cast<float>(x), sx));
      int x1 = static_cast<int>(__fmul_rn(static_cast<float>(x + 1), sx));
      if (x1 <= x0) x1 = x0 + 1;
      if (x1 > pl.w) x1 = pl.w;
      unsigned acc[3] = {0u, 0u, 0u};  // decode.cpp's float sums of integers: exact
      for (int yy = ry0; yy < ry1; ++yy) {
        for (int xx = x0; xx < x1; ++xx) {
          int q[3];
          prescaled(img, W, H, chans, pl.denom, pl.x + xx, pl.y + yy, q);
          acc[0] += q[0];
          acc[1] += q[1];
          acc[2] += q[2];
        }
      }
      const float inv = __fdiv_rn(1.0f, static_cast<float>((ry1 - ry0) * (x1 - x0)));
      for (int c = 0; c < 3; ++c) {
        v[c] = to_u8(__fadd_rn(__fmul_rn(static_cast<float>(acc[c]), inv), 0.5f));
      }
    } else {
      float cx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), sx), 0.5f);
      cx = fmaxf(0.0f, fminf(cx, static_cast<float>(pl.w - 1)));
      const int x0 = static_cast<int>(cx);
      const int x1 = min(x0 + 1, pl.w - 1);
      const float fx = __fsub_rn(cx, static_cast<float>(x0));
      int a[3], b2[3], c2[3], d[3];
      prescaled(img, W, H, chans, pl.denom, pl.x + x0, pl.y + ry0, a);
      prescaled(img, W, H, chans, pl.denom, pl.x + x1, pl.y + ry0, b2);
      prescaled(img, W, H, chans, pl.denom, pl.x + x0, pl.y + ry1, c2);
      prescaled(img, W, H, chans, pl.denom, pl.x + x1, pl.y + ry1, d);
      for (int c = 0; c < 3; ++c) {
        const float top = __fadd_rn(static_cast<float>(a[c]),
                                    __fmul_rn(static_cast<float>(b2[c] - a[c]), fx));
        const float bot = __fadd_rn(static_cast<float>(c2[c]),
                                    __fmul_rn(static_cast<float>(d[c] - c2[c]), fx));
        v[c] = to_u8(__fadd_rn(__fadd_rn(top, __fmul_rn(__fsub_rn(bot, top), fy)), 0.5f));
      }
    }
    const int ox = flip ? out_w - 1 - x : x;
    dst[ox] = v[0];
    dst[plane + ox] = v[1];
    dst[2 * plane + ox] = v[2];
  }
}

}  // namespace

extern "C" {

// a Decoder in *out; 0, or 1000 + the nvjpegStatus_t of the call that failed
int jd_create(void** out) {
  Decoder* d = new Decoder();
  nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, 0, &d->handle);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegJpegStateCreate(d->handle, &d->batched);
  if (s == NVJPEG_STATUS_SUCCESS) s = nvjpegJpegStateCreate(d->handle, &d->single);
  if (s != NVJPEG_STATUS_SUCCESS) {
    destroy(d);
    *out = nullptr;
    return kNvjpegError + static_cast<int>(s);
  }
  *out = d;
  return 0;
}

void jd_destroy(void* dec) {
  if (dec != nullptr) destroy(static_cast<Decoder*>(dec));
}

// each header: width, height and components (all 0 where nvJPEG cannot read it)
int jd_info(void* dec, const unsigned char* const* bufs, const size_t* lens, int n, int* ws,
            int* hs, int* comps) {
  Decoder* d = static_cast<Decoder*>(dec);
  for (int i = 0; i < n; ++i) {
    int nc = 0;
    nvjpegChromaSubsampling_t css;
    int w[NVJPEG_MAX_COMPONENT] = {0}, h[NVJPEG_MAX_COMPONENT] = {0};
    if (nvjpegGetImageInfo(d->handle, bufs[i], lens[i], &nc, &css, w, h) !=
            NVJPEG_STATUS_SUCCESS ||
        w[0] <= 0 || h[0] <= 0) {
      ws[i] = hs[i] = comps[i] = 0;
      continue;
    }
    ws[i] = w[0];
    hs[i] = h[0];
    comps[i] = nc;
  }
  return 0;
}

// decode image i (comps[i] 3: interleaved RGB, 1: luma; anything else fails)
// into raster + offsets[i], a ws[i]-wide raster; status[i] 1 ok, 0 failed.
// Returns the stream's last cudaError.
int jd_decode(void* dec, const unsigned char* const* bufs, const size_t* lens, int n,
              const int* comps, const int* ws, unsigned char* raster,
              const long long* offsets, int* status, void* stream_ptr) {
  Decoder* d = static_cast<Decoder*>(dec);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  std::vector<const unsigned char*> data;
  std::vector<size_t> len;
  std::vector<nvjpegImage_t> dst;
  std::vector<int> color;
  for (int i = 0; i < n; ++i) {
    status[i] = 0;
    if (comps[i] != 3) continue;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = raster + offsets[i];
    img.pitch[0] = static_cast<size_t>(ws[i]) * 3;
    color.push_back(i);
    data.push_back(bufs[i]);
    len.push_back(lens[i]);
    dst.push_back(img);
  }
  const int m = static_cast<int>(color.size());
  if (m > 0) {
    nvjpegStatus_t s = NVJPEG_STATUS_SUCCESS;
    if (d->batch_size != m) {
      s = nvjpegDecodeBatchedInitialize(d->handle, d->batched, m, 1, NVJPEG_OUTPUT_RGBI);
      d->batch_size = s == NVJPEG_STATUS_SUCCESS ? m : 0;
    }
    if (s == NVJPEG_STATUS_SUCCESS) {
      s = nvjpegDecodeBatched(d->handle, d->batched, data.data(), len.data(), dst.data(),
                              stream);
    }
    if (s == NVJPEG_STATUS_SUCCESS) {
      for (int k = 0; k < m; ++k) status[color[k]] = 1;
    } else {  // one image at a time, to find the ones nvJPEG rejects
      d->batch_size = 0;
      for (int k = 0; k < m; ++k) {
        status[color[k]] = nvjpegDecode(d->handle, d->single, data[k], len[k],
                                        NVJPEG_OUTPUT_RGBI, &dst[k],
                                        stream) == NVJPEG_STATUS_SUCCESS;
      }
    }
  }
  for (int i = 0; i < n; ++i) {
    if (comps[i] != 1) continue;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = raster + offsets[i];
    img.pitch[0] = static_cast<size_t>(ws[i]);
    status[i] = nvjpegDecode(d->handle, d->single, bufs[i], lens[i], NVJPEG_OUTPUT_Y, &img,
                             stream) == NVJPEG_STATUS_SUCCESS;
  }
  return static_cast<int>(cudaGetLastError());
}

// the batch's crops of the decoded rasters resized to out_h x out_w and
// mirrored where asked, into out, uint8 (n, 3, out_h, out_w); params: n rows
// of kParams int64 on the card (raster offset, W, H, channels, the crop's x,
// y, w, h in the original image, flip, status)
int crop_resize_flip(const void* raster, const void* params, int n, int out_h, int out_w,
                     void* out, void* stream) {
  if (n <= 0 || out_h <= 0 || out_w <= 0) return 0;
  crop_resize_flip_kernel<<<dim3(out_h, n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raster), static_cast<const long long*>(params), out_h, out_w,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
