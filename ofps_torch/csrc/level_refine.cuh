// Shared device code of the flow-refine kernels: in-kernel bilinear flow
// upsample, exact bilinear warp, and the SAD cost of one integer candidate.
//
// One algorithm with the plain PyTorch versions (ofps_torch/ops/
// flow_pyramid.py _level_refine, ops/image.py warp_bilinear/box_filter):
// every expression below keeps their operand order, and the library is
// built with -fmad=false, so each product and sum rounds as theirs does.
//
// Tile scheme: one CTA of TILE_W x TILE_H threads owns a TILE_W x TILE_H
// output tile, one pixel per thread.  It first builds in shared memory the
// warped i2 over the tile plus an R = win/2 + search halo (each halo pixel
// warped with its own upsampled flow, coordinates clamped to the image:
// that clamp IS the edge padding of the candidate windows), and i1 over the
// tile plus a win/2 halo.  Every cost tap then reads shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ofps {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int TILE_THREADS = TILE_W * TILE_H;
constexpr float kBig = 1e10f;
constexpr float kTieEps = 1e-3f;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Two-tap tables of the resize (hc, wc) -> (h, w): out[i] = w0*x[i0] +
// w1*x[i1], tables laid out as (2, n).  Identity tables (w0=1, w1=0) and
// scale 1 leave a same-resolution flow unchanged.
struct Upsample {
  const int* yi;
  const float* yw;
  const int* xi;
  const float* xw;
  int h, w, hc, wc;
  float scale;
};

// Flow plane `c` (hc x wc) upsampled at full-resolution pixel (y, x): the
// row pass first, then the column pass, as the plain version's matmuls.
__device__ __forceinline__ float upsampled(const float* __restrict__ c,
                                           const Upsample& t, int y, int x) {
  const int y0 = t.yi[y], y1 = t.yi[t.h + y];
  const float wy0 = t.yw[y], wy1 = t.yw[t.h + y];
  const int x0 = t.xi[x], x1 = t.xi[t.w + x];
  const float wx0 = t.xw[x], wx1 = t.xw[t.w + x];
  const float r0 = wy0 * c[y0 * t.wc + x0] + wy1 * c[y1 * t.wc + x0];
  const float r1 = wy0 * c[y0 * t.wc + x1] + wy1 * c[y1 * t.wc + x1];
  return (wx0 * r0 + wx1 * r1) * t.scale;
}

// Bilinear sample of img (h x w, global memory, read-only for the launch)
// at (x + u, y + v), coordinates clamped to the image (ops/image.py
// warp_bilinear).  The four taps go through the read-only data cache.
__device__ __forceinline__ float warp_sample(const float* __restrict__ img,
                                             int h, int w, int y, int x,
                                             float u, float v) {
  const float sx = fminf(fmaxf((float)x + u, 0.0f), (float)(w - 1));
  const float sy = fminf(fmaxf((float)y + v, 0.0f), (float)(h - 1));
  const float x0f = floorf(sx), y0f = floorf(sy);
  const float fx = sx - x0f, fy = sy - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
  float r = __ldg(img + y0 * w + x0) * (1.0f - fx) * (1.0f - fy);
  r = r + __ldg(img + y0 * w + x1) * fx * (1.0f - fy);
  r = r + __ldg(img + y1 * w + x0) * (1.0f - fx) * fy;
  r = r + __ldg(img + y1 * w + x1) * fx * fy;
  return r;
}

// Shared-memory tiles of one CTA.  sW: warped i2 over (TILE_H + 2R) x
// (TILE_W + 2R) from (oy - R, ox - R); sA: i1 over (TILE_H + 2r) x
// (TILE_W + 2r) from (oy - r, ox - r); both at clamped image coordinates.
struct Tiles {
  float* sW;
  float* sA;
  int R, r, oy, ox;
  __device__ __forceinline__ int wpitch() const { return TILE_W + 2 * R; }
  __device__ __forceinline__ int apitch() const { return TILE_W + 2 * r; }
};

__device__ inline void load_tiles(const Tiles& t, const float* __restrict__ i1,
                                  const float* __restrict__ i2,
                                  const float* __restrict__ uc,
                                  const float* __restrict__ vc,
                                  const Upsample& up, int h, int w) {
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int wp = t.wpitch(), wn = wp * (TILE_H + 2 * t.R);
  for (int i = tid; i < wn; i += TILE_THREADS) {
    const int gy = clampi(t.oy - t.R + i / wp, 0, h - 1);
    const int gx = clampi(t.ox - t.R + i % wp, 0, w - 1);
    t.sW[i] = warp_sample(i2, h, w, gy, gx, upsampled(uc, up, gy, gx),
                          upsampled(vc, up, gy, gx));
  }
  const int ap = t.apitch(), an = ap * (TILE_H + 2 * t.r);
  for (int i = tid; i < an; i += TILE_THREADS) {
    const int gy = clampi(t.oy - t.r + i / ap, 0, h - 1);
    const int gx = clampi(t.ox - t.r + i % ap, 0, w - 1);
    t.sA[i] = i1[gy * w + gx];
  }
}

// Cost of candidate (dx, dy) at image pixel (y, x), local tile position
// (ly, lx): box mean over the win x win taps of |i1 - shifted warp| (taps
// outside the image count 0, the sum is still divided by win^2), each
// |diff| rounded to bf16 when round_bf16, plus the 1e-3/px prior; an
// out-of-image centre replaces the cost with 1e10.
__device__ __forceinline__ float cand_cost(const Tiles& t, int y, int x,
                                           int ly, int lx, int dx, int dy,
                                           int h, int w, int round_bf16) {
  if (x + dx < 0 || x + dx > w - 1 || y + dy < 0 || y + dy > h - 1) return kBig;
  const int wp = t.wpitch(), ap = t.apitch();
  float vs = 0.0f;
  for (int ty = -t.r; ty <= t.r; ++ty) {
    const int yy = y + ty;
    float hs = 0.0f;
    if (yy >= 0 && yy < h) {
      const float* arow = t.sA + (ly + ty + t.r) * ap + t.r + lx;
      const float* wrow = t.sW + (ly + ty + dy + t.R) * wp + t.R + lx + dx;
      for (int tx = -t.r; tx <= t.r; ++tx) {
        const int xx = x + tx;
        float d = 0.0f;
        if (xx >= 0 && xx < w) {
          d = fabsf(arow[tx] - wrow[tx]);
          if (round_bf16) d = __bfloat162float(__float2bfloat16_rn(d));
        }
        hs = hs + d;
      }
    }
    vs = vs + hs;
  }
  const float win = (float)(2 * t.r + 1);
  return vs / (win * win) + kTieEps * (float)(abs(dx) + abs(dy));
}

// Parabola vertex offset through (-1, cm), (0, cc), (1, cp), clipped to
// +-0.5; 0 where the curvature vanishes.
__device__ __forceinline__ float parabola(float cm, float cc, float cp) {
  const float denom = cm - 2.0f * cc + cp;
  if (!(fabsf(denom) > 1e-12f)) return 0.0f;
  const float sgn = denom > 0.0f ? 1.0f : -1.0f;
  const float off = 0.5f * (cm - cp) / fmaxf(fabsf(denom), 1e-12f) * sgn;
  return fminf(fmaxf(off, -0.5f), 0.5f);
}

inline size_t tiles_smem_bytes(int R, int r) {
  return sizeof(float) * ((size_t)(TILE_H + 2 * R) * (TILE_W + 2 * R) +
                          (size_t)(TILE_H + 2 * r) * (TILE_W + 2 * r));
}

}  // namespace ofps
