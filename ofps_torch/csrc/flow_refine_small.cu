// Full 2-D flow refine and warm/zero guard select.
//
// Replaces ofps_tpu/pallas/flow_refine_small.py::_small_kernel (launched by
// flow_refine_small_uv), which held a whole coarse level in VMEM and fused
// three steps into one launch: the sweep, the guard and the 3x3 median.
// Here the sweep and the guard are two kernels, and the median runs inside
// the launch that reads its output (the next level's refine, with
// kMedianIn: level_refine.cuh):
//
// * refine_2d_kernel: per pixel, the full (2s+1)^2 SAD sweep (win x win box
//   mean, edge-padded candidates, 1e-3/px prior, 1e10 for out-of-image
//   centres), the first minimum in dy-outer order (strict <) and a per-axis
//   parabola step (ops/flow_pyramid.py _level_refine).  The coarser level's
//   flow is upsampled in the kernel.  It also serves the big levels' 2-D
//   mode (ofps_tpu/pallas/flow_refine.py:396-480).
// * guard_kernel: per pixel, keeps the warm-init solution unless the
//   zero-init one has a strictly smaller box-mean SAD of |a - warp(b)| at
//   its refined flow (ops/flow_pyramid.py _coarse_guard).  The TPU kernel
//   compared best integer-candidate costs instead; this is the XLA path's
//   criterion.
//
// What bounds the sweep on the H100: the coarse levels are small (33 x 60
// at B=4 and 67 x 120 at B=1 are ~8k pixels), so a one-thread-per-pixel
// sweep is a few dozen CTAs, each as long as one thread's 169-candidate
// serial stream.  Design: the candidates are spread over the warps of a
// CTA (one warp per candidate at a time, its cost plane over the tile
// built separably in the warp's own shared-memory buffers,
// level_refine.cuh), every cost is kept in shared memory, and the argmin
// runs over the stored costs by (cost, dy-outer index): the smallest index
// among equal minima, which is the strict-< first-minimum scan.  The
// parabola reads the best candidate's neighbours from the same store.
// Tiles: 8 x 8 pixels and 16 warps for s >= 3 (169 costs x 64 px = 43 KB
// at s = 6; 160 CTAs at 33 x 60 B=4, 135 at 67 x 120 B=1) and 32 x 8 with 8
// warps for s <= 2 (the big levels' 2-D mode at 1080x1920 s=1 and 540x960
// s=2, and 67 x 120 s=1).
//
// The guard is bound by latency: 33 x 60 at B=4 is ~8k pixels, and a
// thread per pixel summing its own win x win window warps every tap again
// (~100 dependent gathers per thread).  Design: a 16 x 8 tile per CTA (80
// CTAs at 33 x 60 B=4, 72 at 67 x 120 B=1) warps each pixel of the tile
// and its win/2 halo once per flow into two shared |diff| planes, then
// takes box_filter's row sums and column sums from there.

#include "level_refine.cuh"

using namespace ofps;

namespace {

template <int TW, int TH, int r, int NT, bool kMedianIn>
__global__ void __launch_bounds__(NT)
refine_2d_kernel(const float* __restrict__ i1, const float* __restrict__ i2,
                 const float* __restrict__ uc, const float* __restrict__ vc,
                 Upsample up, float* __restrict__ u_out,
                 float* __restrict__ v_out, int s, int round_bf16) {
  constexpr int P = TW * TH;  // pixels of the tile
  constexpr int kWarps = NT / 32;
  static_assert(NT % P == 0, "NT / P threads per tile pixel in the argmin");
  constexpr int TPP = NT / P;
  const Geom g{TW, TH, r, r + s};
  const int side = 2 * s + 1, K = side * side;
  const MedianCap m = kMedianIn ? median_cap(g, up) : MedianCap{0, 0};
  // Each warp has its own diff and row-sum planes; every cost follows.
  extern __shared__ float4 smem4[];
  const TileSmem t = carve(reinterpret_cast<float*>(smem4), g, kWarps, m);
  float* costs = t.rest;  // [K][TH][TW]

  const int h = up.h, w = up.w, b = blockIdx.z, tid = threadIdx.x;
  const size_t plane = (size_t)h * w, cplane = (size_t)up.hc * up.wc;
  i1 += b * plane;
  i2 += b * plane;
  uc += b * cplane;
  vc += b * cplane;
  const int oy = blockIdx.y * TH, ox = blockIdx.x * TW;
  stage<NT, kMedianIn>(g, t, i1, i2, uc, vc, up, oy, ox, m);

  // Each warp sweeps candidates warp, warp + kWarps, ... through its own diff
  // and row-sum planes; only __syncwarp orders its passes.
  const int warp = tid / 32, lane = tid % 32;
  float* myD = t.sD + warp * g.d_floats();
  float* myH = t.sH + warp * g.h_floats();
  const float inv_area = 1.0f / (float)((2 * r + 1) * (2 * r + 1));
  constexpr int groups = TW / 4;
  for (int k = warp; k < K; k += kWarps) {
    const int dx = k % side - s, dy = k / side - s;
    diff_pass(g, t.sA, t.sW, myD, dx, dy, oy, ox, h, w, round_bf16, lane, 32);
    __syncwarp();
    rows_pass(g, myD, myH, lane, 32);
    __syncwarp();
    const float tie = tie_of(dx, dy);
    for (int i = lane; i < TH * groups; i += 32) {
      const int ly = i / groups, c4 = (i - ly * groups) * 4;
      *reinterpret_cast<float4*>(costs + k * P + ly * TW + c4) =
          cols_cost(g, myH, ly, c4, oy + ly, ox + c4, dx, dy, h, w, inv_area, tie);
    }
  }
  __syncthreads();

  // Argmin by (cost, k): TPP adjacent threads scan interleaved k, then
  // combine with shuffles.
  const int p = tid / TPP, sub = tid % TPP;
  float bc = INFINITY;
  int bk = K;
  for (int k = sub; k < K; k += TPP) {
    const float c = costs[k * P + p];
    if (c < bc) {
      bc = c;
      bk = k;
    }
  }
#pragma unroll
  for (int off = TPP / 2; off >= 1; off /= 2) {
    const float oc = __shfl_xor_sync(0xffffffffu, bc, off);
    const int ok = __shfl_xor_sync(0xffffffffu, bk, off);
    if (oc < bc || (oc == bc && ok < bk)) {
      bc = oc;
      bk = ok;
    }
  }
  const int ly = p / TW, lx = p % TW, y = oy + ly, x = ox + lx;
  if (sub != 0 || y >= h || x >= w) return;
  const int bx = bk % side - s, by = bk / side - s;
  const float cxm = costs[(bk - (bx > -s ? 1 : 0)) * P + p];
  const float cxp = costs[(bk + (bx < s ? 1 : 0)) * P + p];
  const float cym = costs[(bk - (by > -s ? side : 0)) * P + p];
  const float cyp = costs[(bk + (by < s ? side : 0)) * P + p];
  const float sub_x = abs(bx) == s ? 0.0f : parabola(cxm, bc, cxp);
  const float sub_y = abs(by) == s ? 0.0f : parabola(cym, bc, cyp);
  const Tap ty = t.rt[ly + g.R], tx = t.ct[lx + g.R];
  const Coarse<kMedianIn> cf = coarse_flow<kMedianIn>(g, t, uc, vc, up, m);
  u_out[b * plane + (size_t)y * w + x] = cf.at(cf.u, ty, tx, up.scale) + ((float)bx + sub_x);
  v_out[b * plane + (size_t)y * w + x] = cf.at(cf.v, ty, tx, up.scale) + ((float)by + sub_y);
}

template <int TW, int TH, int r, int NT, bool kMedianIn>
int launch_2d(const float* i1, const float* i2, const float* uc,
              const float* vc, const Upsample& up, float* u_out, float* v_out,
              int B, int s, int round_bf16, cudaStream_t stream) {
  const int K = (2 * s + 1) * (2 * s + 1);
  const Geom g{TW, TH, r, r + s};
  const MedianCap m = kMedianIn ? median_cap(g, up) : MedianCap{0, 0};
  const size_t smem = sizeof(float) * smem_floats(g, NT / 32, K * TW * TH, m);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(refine_2d_kernel<TW, TH, r, NT, kMedianIn>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((up.w + TW - 1) / TW, (up.h + TH - 1) / TH, B);
  refine_2d_kernel<TW, TH, r, NT, kMedianIn><<<grid, NT, smem, stream>>>(
      i1, i2, uc, vc, up, u_out, v_out, s, round_bf16);
  return (int)cudaGetLastError();
}

template <int r, bool kMedianIn>
int launch_2d_r(const float* i1, const float* i2, const float* uc,
                const float* vc, const Upsample& up, float* u_out,
                float* v_out, int B, int s, int round_bf16,
                cudaStream_t stream) {
  if (s >= 3)
    return launch_2d<8, 8, r, 512, kMedianIn>(i1, i2, uc, vc, up, u_out, v_out, B, s,
                                              round_bf16, stream);
  return launch_2d<32, 8, r, 256, kMedianIn>(i1, i2, uc, vc, up, u_out, v_out, B, s,
                                             round_bf16, stream);
}

template <int r>
int launch_2d_m(const float* i1, const float* i2, const float* uc,
                const float* vc, const Upsample& up, float* u_out,
                float* v_out, int B, int s, int round_bf16, int median_in,
                cudaStream_t stream) {
  if (median_in)
    return launch_2d_r<r, true>(i1, i2, uc, vc, up, u_out, v_out, B, s, round_bf16, stream);
  return launch_2d_r<r, false>(i1, i2, uc, vc, up, u_out, v_out, B, s, round_bf16, stream);
}

constexpr int kGuardW = 16, kGuardH = 8, kGuardThreads = kGuardW * kGuardH;

// Per pixel of a 16 x 8 tile: box-mean SAD of |a - warp(b, (U, V))| for the
// warm and the zero-init flow, zero-padded taps, ties keep warm.  The
// additions are box_filter's in its order (row sums 0 + d(x - r) + ... +
// d(x + r), then column sums likewise), divided by (2r + 1)^2.
__global__ void __launch_bounds__(kGuardThreads)
guard_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ u_w, const float* __restrict__ v_w,
             const float* __restrict__ u_0, const float* __restrict__ v_0,
             float* __restrict__ u_out, float* __restrict__ v_out, int h, int w,
             int r) {
  const int ah = kGuardH + 2 * r, aw = kGuardW + 2 * r, n = 2 * r + 1;
  extern __shared__ float4 smem4[];
  float* dw = reinterpret_cast<float*>(smem4);  // |diff| at the warm flow, ah x aw
  float* d0 = dw + ah * aw;                     // at the zero-init flow
  float* hw = d0 + ah * aw;                     // row sums, ah x kGuardW
  float* h0 = hw + ah * kGuardW;
  const int tid = threadIdx.x, oy = blockIdx.y * kGuardH, ox = blockIdx.x * kGuardW;
  const size_t off = blockIdx.z * (size_t)h * w;
  a += off;
  b += off;
  u_w += off;
  v_w += off;
  u_0 += off;
  v_0 += off;
  for (int i = tid; i < ah * aw; i += kGuardThreads) {
    const int row = i / aw, col = i - row * aw;
    const int y = oy - r + row, x = ox - r + col;
    float ew = 0.0f, e0 = 0.0f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const int o = y * w + x;
      const float av = __ldg(a + o);
      ew = fabsf(av - warp_sample(b, h, w, y, x, __ldg(u_w + o), __ldg(v_w + o)));
      e0 = fabsf(av - warp_sample(b, h, w, y, x, __ldg(u_0 + o), __ldg(v_0 + o)));
    }
    dw[i] = ew;
    d0[i] = e0;
  }
  __syncthreads();
  for (int i = tid; i < ah * kGuardW; i += kGuardThreads) {
    const int row = i / kGuardW, col = i - row * kGuardW;
    const float* pw = dw + row * aw + col;
    const float* p0 = d0 + row * aw + col;
    float sw = 0.0f, s0 = 0.0f;
    for (int t = 0; t < n; ++t) {
      sw = sw + pw[t];
      s0 = s0 + p0[t];
    }
    hw[i] = sw;
    h0[i] = s0;
  }
  __syncthreads();
  const int ly = tid / kGuardW, lx = tid - ly * kGuardW;
  const int y = oy + ly, x = ox + lx;
  if (y >= h || x >= w) return;
  float sw = 0.0f, s0 = 0.0f;
  for (int t = 0; t < n; ++t) {
    sw = sw + hw[(ly + t) * kGuardW + lx];
    s0 = s0 + h0[(ly + t) * kGuardW + lx];
  }
  const float area = (float)n * (float)n;
  const bool warm = sw / area <= s0 / area;
  const int i = y * w + x;
  u_out[off + i] = warm ? u_w[i] : u_0[i];
  v_out[off + i] = warm ? v_w[i] : v_0[i];
}

}  // namespace

extern "C" int ofps_flow_refine_small(const float* i1, const float* i2,
                                      const float* uc, const float* vc,
                                      const int* yi, const float* yw,
                                      const int* xi, const float* xw,
                                      float scale, float* u_out, float* v_out,
                                      int B, int h, int w, int hc, int wc,
                                      int search, int win, int round_bf16,
                                      int median_in, void* stream) {
  if (search < 0) return (int)cudaErrorInvalidValue;
  const Upsample up{yi, yw, xi, xw, h, w, hc, wc, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (win) {
    case 3:
      return launch_2d_m<1>(i1, i2, uc, vc, up, u_out, v_out, B, search, round_bf16,
                            median_in, st);
    case 5:
      return launch_2d_m<2>(i1, i2, uc, vc, up, u_out, v_out, B, search, round_bf16,
                            median_in, st);
    case 7:
      return launch_2d_m<3>(i1, i2, uc, vc, up, u_out, v_out, B, search, round_bf16,
                            median_in, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ofps_guard_select(const float* a, const float* b,
                                 const float* u_w, const float* v_w,
                                 const float* u_0, const float* v_0,
                                 float* u_out, float* v_out, int B, int h,
                                 int w, int win, void* stream) {
  // Two |diff| planes over the tile and its halo, two row-sum planes.
  const int r = win / 2, ah = kGuardH + 2 * r, aw = kGuardW + 2 * r;
  const size_t smem = sizeof(float) * (2 * ah * aw + 2 * ah * kGuardW);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(guard_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((w + kGuardW - 1) / kGuardW, (h + kGuardH - 1) / kGuardH, B);
  guard_kernel<<<grid, kGuardThreads, smem, (cudaStream_t)stream>>>(
      a, b, u_w, v_w, u_0, v_0, u_out, v_out, h, w, r);
  return (int)cudaGetLastError();
}
