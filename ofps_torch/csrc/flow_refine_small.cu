// Full 2-D flow refine, warm/zero guard select and 3x3 median.
//
// Replaces ofps_tpu/pallas/flow_refine_small.py::_small_kernel (launched by
// flow_refine_small_uv), which held a whole coarse level in VMEM and fused
// three steps into one launch; here they are three kernels:
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
// * median_kernel: 3x3 median with edge clamping of both flow planes
//   (ops/image.py median3x3), also used after the large levels >= 2.
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
// The guard and median read global memory directly (a few KB).

#include "level_refine.cuh"

using namespace ofps;

namespace {

template <int TW, int TH, int r, int NT>
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
  // Each warp has its own diff and row-sum planes; every cost follows.
  extern __shared__ float4 smem4[];
  const TileSmem t = carve(reinterpret_cast<float*>(smem4), g, kWarps);
  float* costs = t.rest;  // [K][TH][TW]

  const int h = up.h, w = up.w, b = blockIdx.z, tid = threadIdx.x;
  const size_t plane = (size_t)h * w, cplane = (size_t)up.hc * up.wc;
  i1 += b * plane;
  i2 += b * plane;
  uc += b * cplane;
  vc += b * cplane;
  const int oy = blockIdx.y * TH, ox = blockIdx.x * TW;
  stage<NT>(g, t, i1, i2, uc, vc, up, oy, ox);

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
  u_out[b * plane + (size_t)y * w + x] = upsampled(uc, up.wc, ty, tx, up.scale) + ((float)bx + sub_x);
  v_out[b * plane + (size_t)y * w + x] = upsampled(vc, up.wc, ty, tx, up.scale) + ((float)by + sub_y);
}

template <int TW, int TH, int r, int NT>
int launch_2d(const float* i1, const float* i2, const float* uc,
              const float* vc, const Upsample& up, float* u_out, float* v_out,
              int B, int s, int round_bf16, cudaStream_t stream) {
  const int K = (2 * s + 1) * (2 * s + 1);
  const size_t smem =
      sizeof(float) * (tile_smem_floats(Geom{TW, TH, r, r + s}, NT / 32) + K * TW * TH);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(refine_2d_kernel<TW, TH, r, NT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((up.w + TW - 1) / TW, (up.h + TH - 1) / TH, B);
  refine_2d_kernel<TW, TH, r, NT><<<grid, NT, smem, stream>>>(
      i1, i2, uc, vc, up, u_out, v_out, s, round_bf16);
  return (int)cudaGetLastError();
}

template <int r>
int launch_2d_r(const float* i1, const float* i2, const float* uc,
                const float* vc, const Upsample& up, float* u_out,
                float* v_out, int B, int s, int round_bf16,
                cudaStream_t stream) {
  if (s >= 3)
    return launch_2d<8, 8, r, 512>(i1, i2, uc, vc, up, u_out, v_out, B, s, round_bf16, stream);
  return launch_2d<32, 8, r, 256>(i1, i2, uc, vc, up, u_out, v_out, B, s, round_bf16, stream);
}

// Box-mean SAD of |a - warp(b, (U, V))| at (y, x), zero-padded taps.
__device__ __forceinline__ float guard_sad(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           const float* __restrict__ U,
                                           const float* __restrict__ V, int h,
                                           int w, int y, int x, int r) {
  float vs = 0.0f;
  for (int ty = -r; ty <= r; ++ty) {
    const int yy = y + ty;
    float hs = 0.0f;
    if (yy >= 0 && yy < h) {
      for (int tx = -r; tx <= r; ++tx) {
        const int xx = x + tx;
        float d = 0.0f;
        if (xx >= 0 && xx < w) {
          const int i = yy * w + xx;
          d = fabsf(a[i] - warp_sample(b, h, w, yy, xx, U[i], V[i]));
        }
        hs = hs + d;
      }
    }
    vs = vs + hs;
  }
  const float win = (float)(2 * r + 1);
  return vs / (win * win);
}

__global__ void __launch_bounds__(kFlatW * kFlatH)
guard_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ u_w, const float* __restrict__ v_w,
             const float* __restrict__ u_0, const float* __restrict__ v_0,
             float* __restrict__ u_out, float* __restrict__ v_out, int h, int w,
             int r) {
  const int x = blockIdx.x * kFlatW + threadIdx.x;
  const int y = blockIdx.y * kFlatH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t off = blockIdx.z * (size_t)h * w;
  a += off;
  b += off;
  u_w += off;
  v_w += off;
  u_0 += off;
  v_0 += off;
  const bool warm = guard_sad(a, b, u_w, v_w, h, w, y, x, r) <=
                    guard_sad(a, b, u_0, v_0, h, w, y, x, r);
  const int i = y * w + x;
  u_out[off + i] = warm ? u_w[i] : u_0[i];
  v_out[off + i] = warm ? v_w[i] : v_0[i];
}

__device__ __forceinline__ void exch(float* p, int i, int j) {
  const float lo = fminf(p[i], p[j]), hi = fmaxf(p[i], p[j]);
  p[i] = lo;
  p[j] = hi;
}

__device__ __forceinline__ float median9(const float* __restrict__ src, int h,
                                         int w, int y, int x) {
  float p[9];
  for (int dy = 0; dy < 3; ++dy)
    for (int dx = 0; dx < 3; ++dx)
      p[dy * 3 + dx] = src[clampi(y + dy - 1, 0, h - 1) * w + clampi(x + dx - 1, 0, w - 1)];
  // Median-of-9 exchange network (Smith, Graphics Gems).
  exch(p, 1, 2); exch(p, 4, 5); exch(p, 7, 8); exch(p, 0, 1); exch(p, 3, 4);
  exch(p, 6, 7); exch(p, 1, 2); exch(p, 4, 5); exch(p, 7, 8); exch(p, 0, 3);
  exch(p, 5, 8); exch(p, 4, 7); exch(p, 3, 6); exch(p, 1, 4); exch(p, 2, 5);
  exch(p, 4, 7); exch(p, 4, 2); exch(p, 6, 4); exch(p, 4, 2);
  return p[4];
}

__global__ void __launch_bounds__(kFlatW * kFlatH)
median_kernel(const float* __restrict__ u, const float* __restrict__ v,
              float* __restrict__ u_out, float* __restrict__ v_out, int h,
              int w) {
  const int x = blockIdx.x * kFlatW + threadIdx.x;
  const int y = blockIdx.y * kFlatH + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t off = blockIdx.z * (size_t)h * w;
  u_out[off + (size_t)y * w + x] = median9(u + off, h, w, y, x);
  v_out[off + (size_t)y * w + x] = median9(v + off, h, w, y, x);
}

dim3 tile_grid(int B, int h, int w) {
  return dim3((w + kFlatW - 1) / kFlatW, (h + kFlatH - 1) / kFlatH, B);
}

}  // namespace

extern "C" int ofps_flow_refine_small(const float* i1, const float* i2,
                                      const float* uc, const float* vc,
                                      const int* yi, const float* yw,
                                      const int* xi, const float* xw,
                                      float scale, float* u_out, float* v_out,
                                      int B, int h, int w, int hc, int wc,
                                      int search, int win, int round_bf16,
                                      void* stream) {
  if (search < 0) return (int)cudaErrorInvalidValue;
  const Upsample up{yi, yw, xi, xw, h, w, hc, wc, scale};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (win) {
    case 3:
      return launch_2d_r<1>(i1, i2, uc, vc, up, u_out, v_out, B, search, round_bf16, st);
    case 5:
      return launch_2d_r<2>(i1, i2, uc, vc, up, u_out, v_out, B, search, round_bf16, st);
    case 7:
      return launch_2d_r<3>(i1, i2, uc, vc, up, u_out, v_out, B, search, round_bf16, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ofps_guard_select(const float* a, const float* b,
                                 const float* u_w, const float* v_w,
                                 const float* u_0, const float* v_0,
                                 float* u_out, float* v_out, int B, int h,
                                 int w, int win, void* stream) {
  guard_kernel<<<tile_grid(B, h, w), dim3(kFlatW, kFlatH), 0,
                 (cudaStream_t)stream>>>(a, b, u_w, v_w, u_0, v_0, u_out,
                                         v_out, h, w, win / 2);
  return (int)cudaGetLastError();
}

extern "C" int ofps_median3x3(const float* u, const float* v, float* u_out,
                              float* v_out, int B, int h, int w,
                              void* stream) {
  median_kernel<<<tile_grid(B, h, w), dim3(kFlatW, kFlatH), 0,
                  (cudaStream_t)stream>>>(u, v, u_out, v_out, h, w);
  return (int)cudaGetLastError();
}
