// Letterbox a batch of decoded images, for Hopper (sm_90a).
//
// The card's counterpart of the letterbox in tpudet's native JPEG loader
// (tpudet/ops/native/jpeg_loader.cc: make_axis and resize_bilinear_u8,
// :49-106; the letterbox of decode_one, :133-190), which tpudet's server
// runs on the host after each decode. tpudet has no TPU kernel for it; the
// server's hot path (decode -> letterbox -> one batched call) needs one on
// the card, so that the decoded pixels never leave it.
//
// One launch letterboxes a batch into (n, out_h, out_w, 3): image b is
// resized to (nh, nw) into the top-left corner and the rest is pad. The
// wrapper (tpudet_torch/ops/letterbox.py) computes nh, nw on the host as
// decode_one does; an image with nh = nw = 0 is all pad (a failed decode).
//
// Arithmetic, equal to jpeg_loader.cc bit for bit:
// - the taps of each axis are make_axis's: s = (d + 0.5) * src / dst - 0.5
//   in double, clamped to [0, src - 1], truncated, i <= src - 2 (0 for a
//   source 1 pixel wide), w1 = int(frac * 32768 + 0.5). Every double op is
//   an _rn intrinsic: nvcc would otherwise contract the multiply and the
//   subtract into a fused multiply-add, which rounds once where the host
//   rounds twice;
// - horizontal then vertical in int64, rounded once: (v + 2^29) >> 30.
//   The products reach 255 * 2^30, past int32;
// - an image already at its target size takes w1 = 32768 at the last
//   index and 0 elsewhere, which equals the loader's memcpy branch.
// Output: the uint8 canvas (BGR as decoded, or RGB with swap), or a float32
// canvas (v - mean) / std with a true division (__fdiv_rn): numpy divides,
// and a multiply by 1 / std rounds differently.
//
// Bound: bytes. A pixel takes ~30 double and integer operations for its
// taps and 12 multiply-adds; it reads 12 source bytes (4 taps x 3) and
// writes 3 or 12. The least time is the decoded images read once plus the
// canvas written once, at 3.35 TB/s. Design, simple first: one thread a
// canvas pixel, grid (pixels / 256, images), each thread recomputing its
// row's and column's taps (no table in memory, no host copy before the
// launch); the image descriptors travel in the launch's parameters. The
// kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxImages = 64;  // descriptors in one launch's parameters
constexpr int kThreads = 256;

struct Image {
  const uint8_t* src;  // (h, w, 3) uint8, rows of 3 w bytes
  int h, w, nh, nw;
};

struct Batch {
  Image img[kMaxImages];
};

struct Tap {
  int i0, i1, w1;
};

// make_axis (jpeg_loader.cc:55-75) at destination index d
__device__ __forceinline__ Tap axis_tap(int src, int dst, int d) {
  const double scale = __ddiv_rn(static_cast<double>(src),
                                 static_cast<double>(dst));
  double s = __dsub_rn(__dmul_rn(__dadd_rn(static_cast<double>(d), 0.5),
                                 scale), 0.5);
  if (s < 0) s = 0;
  if (s > src - 1) s = src - 1;
  int i = static_cast<int>(s);
  if (i > src - 2) i = src - 2 < 0 ? 0 : src - 2;
  const double frac = __dsub_rn(s, static_cast<double>(i));
  Tap t;
  t.i0 = i;
  t.i1 = min(i + 1, src - 1);
  t.w1 = static_cast<int>(__dadd_rn(__dmul_rn(frac, 32768.0), 0.5));
  return t;
}

template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
letterbox_kernel(Batch batch, void* out, int out_h, int out_w, int swap,
                 int pad, float mean, float stdv) {
  const Image im = batch.img[blockIdx.y];
  const long long npix = static_cast<long long>(out_h) * out_w;
  const long long base = static_cast<long long>(blockIdx.y) * npix;
  for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       p < npix; p += static_cast<long long>(gridDim.x) * kThreads) {
    const int y = static_cast<int>(p / out_w);
    const int x = static_cast<int>(p - static_cast<long long>(y) * out_w);
    int v[3] = {pad, pad, pad};
    if (y < im.nh && x < im.nw) {
      const Tap ty = axis_tap(im.h, im.nh, y);
      const Tap tx = axis_tap(im.w, im.nw, x);
      const uint8_t* r0 = im.src + static_cast<size_t>(ty.i0) * im.w * 3;
      const uint8_t* r1 = im.src + static_cast<size_t>(ty.i1) * im.w * 3;
      const int x0 = tx.i0 * 3, x1 = tx.i1 * 3;
      const long long wx1 = tx.w1, wx0 = 32768 - tx.w1;
      const long long wy1 = ty.w1, wy0 = 32768 - ty.w1;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const long long top = r0[x0 + c] * wx0 + r0[x1 + c] * wx1;
        const long long bot = r1[x0 + c] * wx0 + r1[x1 + c] * wx1;
        const long long val = top * wy0 + bot * wy1;  // scale 2^30
        v[c] = static_cast<int>((val + (1ll << 29)) >> 30);
      }
    }
    const size_t o = static_cast<size_t>(base + p) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int s = swap ? v[2 - c] : v[c];
      if (kFloat) {
        static_cast<float*>(out)[o + c] =
            __fdiv_rn(__fsub_rn(static_cast<float>(s), mean), stdv);
      } else {
        static_cast<uint8_t*>(out)[o + c] = static_cast<uint8_t>(s);
      }
    }
  }
}

}  // namespace

extern "C" {

// Letterbox n <= 64 images. desc holds 5 int64 an image: the address of
// its (h, w, 3) uint8 pixels on the device, h, w, nh, nw. out is (n,
// out_h, out_w, 3), uint8 or (is_float) float32. Returns the launch's
// cudaError_t.
int tpudet_letterbox(const long long* desc, int n, void* out, int out_h,
                     int out_w, int is_float, int swap, int pad, float mean,
                     float stdv, void* stream) {
  if (n <= 0 || n > kMaxImages || out_h <= 0 || out_w <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Batch batch;
  for (int i = 0; i < n; ++i) {
    const long long* d = desc + 5 * i;
    batch.img[i].src = reinterpret_cast<const uint8_t*>(d[0]);
    batch.img[i].h = static_cast<int>(d[1]);
    batch.img[i].w = static_cast<int>(d[2]);
    batch.img[i].nh = static_cast<int>(d[3]);
    batch.img[i].nw = static_cast<int>(d[4]);
  }
  const long long npix = static_cast<long long>(out_h) * out_w;
  const long long blocks = (npix + kThreads - 1) / kThreads;
  const dim3 grid(static_cast<unsigned>(blocks < 65535 ? blocks : 65535),
                  static_cast<unsigned>(n));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_float)
    letterbox_kernel<true><<<grid, kThreads, 0, s>>>(batch, out, out_h, out_w,
                                                     swap, pad, mean, stdv);
  else
    letterbox_kernel<false><<<grid, kThreads, 0, s>>>(
        batch, out, out_h, out_w, swap, pad, mean, stdv);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
