// Bilinear backward warp: out[b, y, x] = img[b] sampled at (x + u, y + v),
// coordinates clamped to the image.
//
// Replaces ofps_tpu/pallas/warp.py::_warp_kernel (launched by
// warp_bilinear_tpu), which avoided per-element gathers on the TPU: each
// 32 x 128 block DMA'd its source window at the block's rounded mean flow,
// shifted columns with a one-hot matmul and clamped the per-pixel residual
// to +-7 px.  Hopper gathers per thread, so none of that is carried over:
// this kernel computes ops/image.py warp_bilinear exactly (warp_sample keeps
// its operand order; the library is built with -fmad=false), including
// where the flow varies by more than 7 px inside a block.
//
// What bounds it on the H100: bytes.  It reads img, u and v once and writes
// out once, 16 B per pixel (33.2 MB at 1080 x 1920, ~10 us at 3.35 TB/s),
// against ~23 float operations per pixel.  Design: one thread per output
// pixel in 32 x 8 blocks (batch on gridDim.z), so the u, v loads and the out
// store are coalesced; the four taps are read-only gathers that, for smooth
// flow, land on neighbouring source pixels for neighbouring threads, and a
// 1080p plane (8.3 MB) stays in the 50 MB L2.

#include "level_refine.cuh"

using namespace ofps;

namespace {

__global__ void __launch_bounds__(kFlatW * kFlatH)
warp_kernel(const float* __restrict__ img, const float* __restrict__ u,
            const float* __restrict__ v, float* __restrict__ out, int h,
            int w) {
  const int x = blockIdx.x * kFlatW + threadIdx.x;
  const int y = blockIdx.y * kFlatH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t off = blockIdx.z * (size_t)h * w;
  const size_t i = off + (size_t)y * w + x;
  out[i] = warp_sample(img + off, h, w, y, x, __ldg(u + i), __ldg(v + i));
}

}  // namespace

extern "C" int ofps_warp_bilinear(const float* img, const float* u,
                                  const float* v, float* out, int B, int h,
                                  int w, void* stream) {
  const dim3 grid((w + kFlatW - 1) / kFlatW, (h + kFlatH - 1) / kFlatH, B);
  warp_kernel<<<grid, dim3(kFlatW, kFlatH), 0, (cudaStream_t)stream>>>(
      img, u, v, out, h, w);
  return (int)cudaGetLastError();
}
