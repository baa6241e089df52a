// Axis-separable flow refine of one large pyramid level.
//
// Replaces ofps_tpu/pallas/flow_refine.py::_refine_kernel (launched by
// flow_refine_uv).  Per pixel: the 2x bilinear upsample of the coarser
// level's flow, the exact bilinear warp of i2, the 5-cost search-1 cross
// (centre and the four axis neighbours) and the per-axis selection with a
// parabola step (ops/flow_pyramid.py _level_refine, axis_sep=True).  In
// grid mode (the serving finest level) each refined pixel is added into
// its grid cell instead of being stored.
//
// What bounds it on the H100: at 1080p the level reads i1 and i2 (8 MB
// each per frame) and writes u, v (16 MB) or nothing (grid mode); the
// function needs ~130 float operations per pixel.  The kernel is bound by
// instruction issue, so the design cuts instructions per pixel: one CTA of
// 512 threads per 64 x 32 tile (warped halo 3, 1.30 warps per pixel; the
// upsample taps staged in shared memory), and each candidate's cost plane
// built once in three shared-memory passes (level_refine.cuh: one |diff|
// per pixel, float4 row sums, float4 column sums) instead of 25 taps per
// pixel.  512 threads, each with the five costs of its 4 outputs in
// registers, capped at 40 registers so that three CTAs share an SM (48
// warps to hide the shared-memory and L1 latency between the barriers).  Grid mode sums each cell's
// rectangle of the tile in shared memory with one warp, so only one
// global atomicAdd per (tile, cell) reaches L2 and no shared-memory
// atomics contend.  The TPU kernel's
// block-mean DMA offset with a +-7 px residual clamp is not carried over:
// every pixel samples at its own flow.
//
// kMedianIn (the levels that follow a level >= 2): the coarser level's 3x3
// median runs as the staging's prologue (level_refine.cuh), a filtered
// region of about 21 x 37 coarse pixels per plane (6 KB of shared memory
// for both; the raw region reuses the diff and row-sum planes), so three
// CTAs still share an SM.

#include "level_refine.cuh"

using namespace ofps;

namespace {

constexpr int kTW = 64, kTH = 32, kThreads = 512;
constexpr int kGroups = kTW / 4;  // one thread per row and group of 4 columns
static_assert(kTH * kGroups == kThreads, "one output item per thread");

__host__ __device__ constexpr Geom sep_geom(int r) { return Geom{kTW, kTH, r, r + 1}; }

__device__ __forceinline__ float axis_refine(float cm, float cc, float cp) {
  const float bi = cm < cc ? (cm <= cp ? -1.0f : 1.0f) : (cp < cc ? 1.0f : 0.0f);
  return bi + (bi == 0.0f ? parabola(cm, cc, cp) : 0.0f);
}

// Runs of equal cell index along n <= 64 rows or columns (key -1 outside
// the image or in the border band), found by one warp: start[i] and
// cell[i] of run i, start[runs] = n; returns the number of runs.
__device__ __forceinline__ int cell_runs(const int* __restrict__ cells, int o,
                                         int lim, int n, int* start,
                                         int* cell) {
  const int lane = threadIdx.x % 32;
  int runs = 0, carry = -2;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int key = i < n && o + i < lim ? cells[o + i] : -1;
    int prev = __shfl_up_sync(0xffffffffu, key, 1);
    if (lane == 0) prev = carry;
    const bool head = i < n && key != prev;
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    if (head) {
      const int k = runs + __popc(heads & ((1u << lane) - 1u));
      start[k] = i;
      cell[k] = key;
    }
    runs += __popc(heads);
    carry = __shfl_sync(0xffffffffu, key, 31);
  }
  if (lane == 0) start[runs] = n;
  return runs;
}

template <int r, bool kMedianIn>
__global__ void __launch_bounds__(kThreads, 3)
refine_sep_kernel(const float* __restrict__ i1, const float* __restrict__ i2,
                  const float* __restrict__ uc, const float* __restrict__ vc,
                  Upsample up, float* __restrict__ u_out,
                  float* __restrict__ v_out, const int* __restrict__ cell_y,
                  const int* __restrict__ cell_x, float* __restrict__ gsum_u,
                  float* __restrict__ gsum_v, int gh, int gw, int round_bf16) {
  constexpr Geom g = sep_geom(r);
  const MedianCap m = kMedianIn ? median_cap(g, up) : MedianCap{0, 0};
  extern __shared__ float4 smem4[];
  const TileSmem t = carve(reinterpret_cast<float*>(smem4), g, 1, m);

  const int h = up.h, w = up.w, b = blockIdx.z, tid = threadIdx.x;
  const size_t plane = (size_t)h * w, cplane = (size_t)up.hc * up.wc;
  i1 += b * plane;
  i2 += b * plane;
  uc += b * cplane;
  vc += b * cplane;
  const int oy = blockIdx.y * kTH, ox = blockIdx.x * kTW;
  stage<kThreads, kMedianIn>(g, t, i1, i2, uc, vc, up, oy, ox, m);

  // Candidates in the order cym, cxm, c00, cxp, cyp; this thread's costs
  // at row ly, columns c4 .. c4 + 3.
  const float inv_area = 1.0f / (float)((2 * r + 1) * (2 * r + 1));
  const int ly = tid / kGroups, c4 = (tid % kGroups) * 4;
  const int y = oy + ly, x = ox + c4;
  float4 cost[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const int dx = c == 1 ? -1 : (c == 3 ? 1 : 0);
    const int dy = c == 0 ? -1 : (c == 4 ? 1 : 0);
    diff_pass(g, t.sA, t.sW, t.sD, dx, dy, oy, ox, h, w, round_bf16, tid, kThreads);
    __syncthreads();
    rows_pass(g, t.sD, t.sH, tid, kThreads);
    __syncthreads();
    cost[c] = cols_cost(g, t.sH, ly, c4, y, x, dx, dy, h, w, inv_area, tie_of(dx, dy));
  }

  float uo[4], vo[4];
  const Tap ty = t.rt[ly + g.R];
  const Coarse<kMedianIn> cf = coarse_flow<kMedianIn>(g, t, uc, vc, up, m);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const Tap tx = t.ct[c4 + j + g.R];
    const float c00 = lane4(cost[2], j);
    uo[j] = cf.at(cf.u, ty, tx, up.scale) +
            axis_refine(lane4(cost[1], j), c00, lane4(cost[3], j));
    vo[j] = cf.at(cf.v, ty, tx, up.scale) +
            axis_refine(lane4(cost[0], j), c00, lane4(cost[4], j));
  }

  if (gsum_u == nullptr) {
    if (y >= h) return;
    const size_t o = b * plane + (size_t)y * w + x;
    if ((w & 3) == 0 && x + 3 < w) {
      *reinterpret_cast<float4*>(u_out + o) = make_float4(uo[0], uo[1], uo[2], uo[3]);
      *reinterpret_cast<float4*>(v_out + o) = make_float4(vo[0], vo[1], vo[2], vo[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (x + j < w) {
          u_out[o + j] = uo[j];
          v_out[o + j] = vo[j];
        }
      }
    }
    return;
  }

  // Grid mode: the tile's refined flow goes to shared memory (in place of
  // sW and sA, which no pass reads any more); the grid's cells cut the
  // tile into rectangles (runs of equal cell index along its rows and
  // columns); one warp sums each rectangle and adds it to the cell with
  // one global atomicAdd per plane.
  static_assert(2 * kTH * kTW <= round4(sep_geom(1).warp_floats()) + round4(sep_geom(1).a_floats()),
                "the tile's flow must fit in the staging buffers");
  __shared__ int run_y[kTH + 1], cell_of_y[kTH], run_x[kTW + 1], cell_of_x[kTW];
  __shared__ int n_runs[2];
  float* U = t.sW;
  float* V = t.sW + kTH * kTW;
  __syncthreads();
  *reinterpret_cast<float4*>(U + ly * kTW + c4) = make_float4(uo[0], uo[1], uo[2], uo[3]);
  *reinterpret_cast<float4*>(V + ly * kTW + c4) = make_float4(vo[0], vo[1], vo[2], vo[3]);
  const int warp = tid / 32, lane = tid % 32;
  if (warp == 0) {
    const int n = cell_runs(cell_y, oy, h, kTH, run_y, cell_of_y);
    if (lane == 0) n_runs[0] = n;
  } else if (warp == 1) {
    const int n = cell_runs(cell_x, ox, w, kTW, run_x, cell_of_x);
    if (lane == 0) n_runs[1] = n;
  }
  __syncthreads();
  const int nx = n_runs[1], cells = n_runs[0] * nx;
  for (int k = warp; k < cells; k += kThreads / 32) {
    const int sy = k / nx, sx = k - sy * nx;
    const int cy = cell_of_y[sy], cx = cell_of_x[sx];
    if (cy < 0 || cx < 0 || cy >= gh || cx >= gw) continue;
    const int r0 = run_y[sy], c0 = run_x[sx], cw = run_x[sx + 1] - c0;
    const int area = (run_y[sy + 1] - r0) * cw;
    float su = 0.0f, sv = 0.0f;
    for (int i = lane; i < area; i += 32) {
      const int rr = i / cw, o = (r0 + rr) * kTW + c0 + (i - rr * cw);
      su += U[o];
      sv += V[o];
    }
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) {
      su += __shfl_xor_sync(0xffffffffu, su, off);
      sv += __shfl_xor_sync(0xffffffffu, sv, off);
    }
    if (lane == 0) {
      atomicAdd(&gsum_u[(size_t)b * gh * gw + cy * gw + cx], su);
      atomicAdd(&gsum_v[(size_t)b * gh * gw + cy * gw + cx], sv);
    }
  }
}

template <int r, bool kMedianIn>
int launch_sep(const float* i1, const float* i2, const float* uc,
               const float* vc, const Upsample& up, float* u_out,
               float* v_out, const int* cell_y, const int* cell_x,
               float* gsum_u, float* gsum_v, int gh, int gw, int B,
               int round_bf16, cudaStream_t stream) {
  const MedianCap m = kMedianIn ? median_cap(sep_geom(r), up) : MedianCap{0, 0};
  const size_t smem = sizeof(float) * smem_floats(sep_geom(r), 1, 0, m);
  cudaError_t err = allow_smem(refine_sep_kernel<r, kMedianIn>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((up.w + kTW - 1) / kTW, (up.h + kTH - 1) / kTH, B);
  refine_sep_kernel<r, kMedianIn><<<grid, kThreads, smem, stream>>>(
      i1, i2, uc, vc, up, u_out, v_out, cell_y, cell_x, gsum_u, gsum_v, gh,
      gw, round_bf16);
  return (int)cudaGetLastError();
}

template <int r>
int launch_sep_m(const float* i1, const float* i2, const float* uc,
                 const float* vc, const Upsample& up, float* u_out,
                 float* v_out, const int* cell_y, const int* cell_x,
                 float* gsum_u, float* gsum_v, int gh, int gw, int B,
                 int round_bf16, int median_in, cudaStream_t stream) {
  if (median_in)
    return launch_sep<r, true>(i1, i2, uc, vc, up, u_out, v_out, cell_y, cell_x,
                               gsum_u, gsum_v, gh, gw, B, round_bf16, stream);
  return launch_sep<r, false>(i1, i2, uc, vc, up, u_out, v_out, cell_y, cell_x,
                              gsum_u, gsum_v, gh, gw, B, round_bf16, stream);
}

}  // namespace

extern "C" int ofps_flow_refine(const float* i1, const float* i2,
                                const float* uc, const float* vc,
                                const int* yi, const float* yw, const int* xi,
                                const float* xw, float scale, float* u_out,
                                float* v_out, const int* cell_y,
                                const int* cell_x, float* gsum_u,
                                float* gsum_v, int gh, int gw, int B, int h,
                                int w, int hc, int wc, int win, int round_bf16,
                                int median_in, void* stream) {
  const Upsample up{yi, yw, xi, xw, h, w, hc, wc, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (win) {
    case 3:
      return launch_sep_m<1>(i1, i2, uc, vc, up, u_out, v_out, cell_y, cell_x,
                             gsum_u, gsum_v, gh, gw, B, round_bf16, median_in, s);
    case 5:
      return launch_sep_m<2>(i1, i2, uc, vc, up, u_out, v_out, cell_y, cell_x,
                             gsum_u, gsum_v, gh, gw, B, round_bf16, median_in, s);
    case 7:
      return launch_sep_m<3>(i1, i2, uc, vc, up, u_out, v_out, cell_y, cell_x,
                             gsum_u, gsum_v, gh, gw, B, round_bf16, median_in, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
