// Shared device code of the flow-refine kernels: in-kernel bilinear flow
// upsample, exact bilinear warp, and the SAD cost plane of one integer
// candidate over a tile, built separably in shared memory.
//
// One algorithm with the plain PyTorch versions (ofps_torch/ops/
// flow_pyramid.py _level_refine, ops/image.py warp_bilinear/box_filter):
// every expression below keeps their operand order, and the library is
// built with -fmad=false, so each product and sum rounds as theirs does.
// The box mean multiplies by 1/win^2, as PyTorch computes a CUDA tensor
// divided by a host scalar.
//
// Tile scheme: a CTA owns a TW x TH output tile.  stage() builds in shared
// memory the warped i2 over the tile plus an R = win/2 + search halo (each
// halo pixel warped with its own upsampled flow, coordinates clamped to the
// image: that clamp IS the edge padding of the candidate windows) and i1
// over the tile plus a win/2 halo.  A candidate's cost plane then takes
// three passes, each reading the previous one from shared memory:
//
//   diff:  d = |i1 - shifted warp| (rounded to bf16) once per pixel of the
//          tile plus the win/2 halo; 0 outside the image;
//   rows:  hs = 0 + d(x - r) + ... + d(x + r), four columns per item;
//   cols:  vs = 0 + hs(y - r) + ... + hs(y + r), times 1/win^2, plus the
//          1e-3/px prior; 1e10 where the candidate centre leaves the image.
//
// These are box_filter's additions in box_filter's order (no running sums,
// which would round differently).
//
// Median prologue (kMedianIn): the pyramid filters each level >= 2 with a
// 3x3 median (edge clamp) whose only reader is the next finer level's
// upsample.  A median is an exact selection, so the CTA filters, in shared
// memory, just the coarse region its upsample taps reach (a 1-pixel ring
// of raw values around it, clamped to the coarse image) and the upsample
// reads the filtered taps from there: the same bits as a separate median
// launch, with no launch and no round trip through device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ofps {

// Block of the one-thread-per-pixel warp kernel.
constexpr int kFlatW = 32, kFlatH = 8;
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

// One row's or column's two taps, staged in shared memory (one LDS.128).
struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Tap load_tap(const int* idx, const float* wts,
                                        int n, int i) {
  return Tap{idx[i], idx[n + i], wts[i], wts[n + i]};
}

// Flow plane `c` (hc x wc) upsampled at the pixel whose row and column taps
// are ty, tx: the row pass first, then the column pass, as the plain
// version's matmuls.
__device__ __forceinline__ float upsampled(const float* __restrict__ c, int wc,
                                           const Tap& ty, const Tap& tx,
                                           float scale) {
  const float r0 = ty.w0 * __ldg(c + ty.i0 * wc + tx.i0) + ty.w1 * __ldg(c + ty.i1 * wc + tx.i0);
  const float r1 = ty.w0 * __ldg(c + ty.i0 * wc + tx.i1) + ty.w1 * __ldg(c + ty.i1 * wc + tx.i1);
  return (tx.w0 * r0 + tx.w1 * r1) * scale;
}

// The coarser level's flow as the upsample reads it: global memory, or
// (kSmem) the tile's 3x3-median-filtered region in shared memory, whose
// first row and column are the coarse (y0, x0).
template <bool kSmem>
struct Coarse {
  const float* u;
  const float* v;
  int pitch, y0, x0;

  // Plane `c` (u or v) upsampled at the pixel with taps ty, tx.
  __device__ __forceinline__ float at(const float* __restrict__ c, const Tap& ty,
                                      const Tap& tx, float scale) const {
    if constexpr (kSmem) {
      const int a0 = (ty.i0 - y0) * pitch, a1 = (ty.i1 - y0) * pitch;
      const int b0 = tx.i0 - x0, b1 = tx.i1 - x0;
      const float r0 = ty.w0 * c[a0 + b0] + ty.w1 * c[a1 + b0];
      const float r1 = ty.w0 * c[a0 + b1] + ty.w1 * c[a1 + b1];
      return (tx.w0 * r0 + tx.w1 * r1) * scale;
    } else {
      return upsampled(c, pitch, ty, tx, scale);
    }
  }
};

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

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory geometry of a TW x TH tile with window radius r and a
// warped halo R.  Pitches: warp WW, i1 AW, diff DP (a multiple of 4 wide
// enough for the rows pass's aligned float4 reads), row sums TW.
struct Geom {
  int TW, TH, r, R;
  __host__ __device__ constexpr int WH() const { return TH + 2 * R; }
  __host__ __device__ constexpr int WW() const { return TW + 2 * R; }
  __host__ __device__ constexpr int AH() const { return TH + 2 * r; }
  __host__ __device__ constexpr int AW() const { return TW + 2 * r; }
  // float4 reads per rows-pass item: 4 + 2r values from an aligned start.
  __host__ __device__ constexpr int NL() const { return (4 + 2 * r + 3) / 4; }
  __host__ __device__ constexpr int DP() const { return TW - 4 + 4 * NL(); }
  __host__ __device__ constexpr int warp_floats() const { return WH() * WW(); }
  __host__ __device__ constexpr int a_floats() const { return AH() * AW(); }
  __host__ __device__ constexpr int d_floats() const { return AH() * DP(); }
  __host__ __device__ constexpr int h_floats() const { return AH() * TW; }
  __host__ __device__ constexpr int tap_count() const { return WH() + WW(); }
};

// Coarse pixels that the upsample taps of `span` consecutive outputs reach
// along an axis resized from nc to n (a bilinear upsample or the identity):
// at most ceil((span - 1) nc / n) + 2, and never more than nc.
__host__ __device__ constexpr int region_cap(int span, int nc, int n) {
  return (span - 1) * nc / n + 3 < nc ? (span - 1) * nc / n + 3 : nc;
}

// Capacity of a tile's median region: fh x fw filtered coarse pixels (0 x
// 0 without the prologue), and the raw region with its 1-pixel ring.
struct MedianCap {
  int fh, fw;
  __host__ __device__ constexpr int filtered() const { return fh * fw; }
  __host__ __device__ constexpr int raw() const { return fh ? (fh + 2) * (fw + 2) : 0; }
};

__host__ __device__ constexpr MedianCap median_cap(const Geom g, const Upsample& up) {
  return MedianCap{region_cap(g.WH(), up.hc, up.h), region_cap(g.WW(), up.wc, up.w)};
}

// A CTA's shared memory, in this order: the row and column taps, the
// warped i2 (sW), i1 (sA), the median-filtered coarse u and v (sM, each
// m.filtered() floats; none without the prologue), `planes` diff planes
// (sD, pitch DP) and as many row-sum planes (sH, pitch TW), then whatever
// the kernel adds (rest).  The prologue's raw region lies from sD on,
// before any pass writes there.
struct TileSmem {
  Tap* rt;
  Tap* ct;
  float *sW, *sA, *sM, *sD, *sH, *rest;
};

__host__ __device__ constexpr int tile_smem_floats(const Geom g, int planes,
                                                   const MedianCap m = MedianCap{0, 0}) {
  return 4 * g.tap_count() + round4(g.warp_floats()) + round4(g.a_floats()) +
         2 * round4(m.filtered()) + planes * (g.d_floats() + g.h_floats());
}

// Floats of dynamic shared memory for the tile, `planes` passes, `rest`
// floats of the kernel's own and the median region `m`.
__host__ __device__ constexpr int smem_floats(const Geom g, int planes, int rest,
                                              const MedianCap m) {
  const int tile = tile_smem_floats(g, planes, m) + rest;
  const int raw_end = tile_smem_floats(g, 0, m) + 2 * m.raw();
  return tile > raw_end ? tile : raw_end;
}

__device__ __forceinline__ TileSmem carve(float* smem, const Geom g, int planes,
                                          const MedianCap m = MedianCap{0, 0}) {
  TileSmem t;
  t.rt = reinterpret_cast<Tap*>(smem);
  t.ct = t.rt + g.WH();
  t.sW = smem + 4 * g.tap_count();
  t.sA = t.sW + round4(g.warp_floats());
  t.sM = t.sA + round4(g.a_floats());
  t.sD = t.sM + 2 * round4(m.filtered());
  t.sH = t.sD + planes * g.d_floats();
  t.rest = t.sH + planes * g.h_floats();
  return t;
}

__device__ __forceinline__ void exch(float* p, int i, int j) {
  const float lo = fminf(p[i], p[j]), hi = fmaxf(p[i], p[j]);
  p[i] = lo;
  p[j] = hi;
}

// Median of the 3x3 block whose top-left value is src[0] (row pitch
// `pitch`), by the median-of-9 exchange network (Smith, Graphics Gems).
__device__ __forceinline__ float median9(const float* src, int pitch) {
  float p[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) p[dy * 3 + dx] = src[dy * pitch + dx];
  exch(p, 1, 2); exch(p, 4, 5); exch(p, 7, 8); exch(p, 0, 1); exch(p, 3, 4);
  exch(p, 6, 7); exch(p, 1, 2); exch(p, 4, 5); exch(p, 7, 8); exch(p, 0, 3);
  exch(p, 5, 8); exch(p, 4, 7); exch(p, 3, 6); exch(p, 1, 4); exch(p, 2, 5);
  exch(p, 4, 7); exch(p, 4, 2); exch(p, 6, 4); exch(p, 4, 2);
  return p[4];
}

// The coarse flow that the upsample of the tile reads (after stage()'s
// taps are in shared memory).  The taps are non-decreasing (a bilinear
// resize), so the region runs from the first row's and column's i0 to the
// last one's i1.
template <bool kMedianIn>
__device__ __forceinline__ Coarse<kMedianIn> coarse_flow(const Geom g, const TileSmem& t,
                                                         const float* uc, const float* vc,
                                                         const Upsample& up,
                                                         const MedianCap m) {
  if constexpr (kMedianIn) {
    const int y0 = t.rt[0].i0, x0 = t.ct[0].i0;
    return Coarse<true>{t.sM, t.sM + round4(m.filtered()), t.ct[g.WW() - 1].i1 - x0 + 1,
                        y0, x0};
  } else {
    return Coarse<false>{uc, vc, up.wc, 0, 0};
  }
}

// The median prologue: the raw coarse u and v over the taps' region plus a
// clamped 1-pixel ring into sD, then their 3x3 medians into sM.  All NT
// threads take part; ends with __syncthreads().
template <int NT>
__device__ __forceinline__ void median_prologue(const Geom g, const TileSmem& t,
                                                const float* __restrict__ uc,
                                                const float* __restrict__ vc,
                                                const Upsample& up, const MedianCap m) {
  const int tid = threadIdx.x;
  const int y0 = t.rt[0].i0, x0 = t.ct[0].i0;
  const int fh = t.rt[g.WH() - 1].i1 - y0 + 1, fw = t.ct[g.WW() - 1].i1 - x0 + 1;
  const int rw = fw + 2, raw = (fh + 2) * rw;
  float* ru = t.sD;
  float* rv = t.sD + raw;
  for (int i = tid; i < raw; i += NT) {
    const int row = i / rw, col = i - row * rw;
    const int o = clampi(y0 - 1 + row, 0, up.hc - 1) * up.wc + clampi(x0 - 1 + col, 0, up.wc - 1);
    ru[i] = __ldg(uc + o);
    rv[i] = __ldg(vc + o);
  }
  __syncthreads();
  float* mu = t.sM;
  float* mv = t.sM + round4(m.filtered());
  for (int i = tid; i < fh * fw; i += NT) {
    const int row = i / fw, col = i - row * fw;
    mu[i] = median9(ru + row * rw + col, rw);
    mv[i] = median9(rv + row * rw + col, rw);
  }
  __syncthreads();
}

// Stage the tile at (oy, ox): the row and column upsample taps of the warp
// region (rt: WH rows, ct: WW columns, at clamped image coordinates), with
// kMedianIn the median prologue, then sW (warped i2, WH x WW) and sA (i1,
// AH x AW).  All NT threads of the CTA take part; ends with
// __syncthreads().
template <int NT, bool kMedianIn = false>
__device__ __forceinline__ void stage(const Geom g, const TileSmem& t,
                                      const float* __restrict__ i1,
                                      const float* __restrict__ i2,
                                      const float* __restrict__ uc,
                                      const float* __restrict__ vc,
                                      const Upsample& up, int oy, int ox,
                                      const MedianCap m = MedianCap{0, 0}) {
  const int tid = threadIdx.x, h = up.h, w = up.w;
  const int WH = g.WH(), WW = g.WW();
  for (int i = tid; i < WH + WW; i += NT) {
    if (i < WH) {
      t.rt[i] = load_tap(up.yi, up.yw, h, clampi(oy - g.R + i, 0, h - 1));
    } else {
      t.ct[i - WH] = load_tap(up.xi, up.xw, w, clampi(ox - g.R + i - WH, 0, w - 1));
    }
  }
  __syncthreads();
  if constexpr (kMedianIn) median_prologue<NT>(g, t, uc, vc, up, m);
  const Coarse<kMedianIn> c = coarse_flow<kMedianIn>(g, t, uc, vc, up, m);
  for (int i = tid; i < WH * WW; i += NT) {
    const int row = i / WW, col = i - row * WW;
    const int gy = clampi(oy - g.R + row, 0, h - 1);
    const int gx = clampi(ox - g.R + col, 0, w - 1);
    const Tap ty = t.rt[row], tx = t.ct[col];
    t.sW[i] = warp_sample(i2, h, w, gy, gx, c.at(c.u, ty, tx, up.scale),
                          c.at(c.v, ty, tx, up.scale));
  }
  const int AH = g.AH(), AW = g.AW();
  for (int i = tid; i < AH * AW; i += NT) {
    const int row = i / AW, col = i - row * AW;
    const int gy = clampi(oy - g.r + row, 0, h - 1);
    const int gx = clampi(ox - g.r + col, 0, w - 1);
    t.sA[i] = __ldg(i1 + gy * w + gx);
  }
  __syncthreads();
}

// diff pass of candidate (dx, dy): items `first`, `first + stride`, ... of
// the AH x AW plane into sD (pitch DP).
__device__ __forceinline__ void diff_pass(const Geom g, const float* sA,
                                          const float* sW, float* sD, int dx,
                                          int dy, int oy, int ox, int h, int w,
                                          int round_bf16, int first,
                                          int stride) {
  const int AW = g.AW(), WW = g.WW(), s = g.R - g.r;
  for (int i = first; i < g.AH() * AW; i += stride) {
    const int row = i / AW, col = i - row * AW;
    const int gy = oy - g.r + row, gx = ox - g.r + col;
    float d = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      d = fabsf(sA[i] - sW[(row + s + dy) * WW + col + s + dx]);
      if (round_bf16) d = __bfloat162float(__float2bfloat16_rn(d));
    }
    sD[row * g.DP() + col] = d;
  }
}

// rows pass: for each (row, group of four columns) item, the four row sums
// 0 + d(x - r) + ... + d(x + r) into sH (pitch TW).
__device__ __forceinline__ void rows_pass(const Geom g, const float* sD,
                                          float* sH, int first, int stride) {
  const int groups = g.TW / 4, n = 2 * g.r + 1;
  for (int i = first; i < g.AH() * groups; i += stride) {
    const int row = i / groups, c4 = (i - row * groups) * 4;
    const float4* src = reinterpret_cast<const float4*>(sD + row * g.DP() + c4);
    float d[12];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < g.NL()) {
        const float4 q = src[j];
        d[4 * j] = q.x;
        d[4 * j + 1] = q.y;
        d[4 * j + 2] = q.z;
        d[4 * j + 3] = q.w;
      }
    }
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float s = d[k];
#pragma unroll
      for (int t = 1; t < 7; ++t) {
        if (t < n) s = s + d[k + t];
      }
      o[k] = s;
    }
    *reinterpret_cast<float4*>(sH + row * g.TW + c4) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// cols pass for output row ly (tile-local), columns c4 .. c4 + 3 at image
// (y, x): the four costs of candidate (dx, dy).
__device__ __forceinline__ float4 cols_cost(const Geom g, const float* sH,
                                            int ly, int c4, int y, int x,
                                            int dx, int dy, int h, int w,
                                            float inv_area, float tie) {
  const float* col = sH + ly * g.TW + c4;
  float4 v = *reinterpret_cast<const float4*>(col);
#pragma unroll
  for (int t = 1; t < 7; ++t) {
    if (t < 2 * g.r + 1) {
      const float4 q = *reinterpret_cast<const float4*>(col + t * g.TW);
      v.x = v.x + q.x;
      v.y = v.y + q.y;
      v.z = v.z + q.z;
      v.w = v.w + q.w;
    }
  }
  const bool row_out = y + dy < 0 || y + dy > h - 1;
  auto cost = [&](float vs, int xx) {
    return (row_out || xx + dx < 0 || xx + dx > w - 1) ? kBig : vs * inv_area + tie;
  };
  return make_float4(cost(v.x, x), cost(v.y, x + 1), cost(v.z, x + 2), cost(v.w, x + 3));
}

// Component j of q (j a compile-time constant after unrolling, so q stays
// in registers).
__device__ __forceinline__ float lane4(const float4& q, int j) {
  return j == 0 ? q.x : (j == 1 ? q.y : (j == 2 ? q.z : q.w));
}

__device__ __forceinline__ float tie_of(int dx, int dy) {
  return kTieEps * (float)(abs(dx) + abs(dy));
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

// Opt a kernel into `bytes` of dynamic shared memory (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace ofps
