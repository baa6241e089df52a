// Almeida's rotation RANSAC, whole: the minimal 3-point fits, the scoring
// on the shared eval subset, the first-maximum winner and the refit on its
// inliers (ofps_torch/estimators/almeida.py ransac_plain, its plain
// version).
//
// Replaces no TPU kernel: the JAX package leaves almeida to XLA, which
// fuses the hypotheses' iterative least squares into a few loops.  PyTorch
// runs each plane operation of the plain version as its own kernel, so in
// the consumers' CUDA graph almeida was ~17,800 nodes a step (30 dependent
// LSQ iterations twice, ~200 small launches each), bound by the launches.
//
// What bounds it on the H100: latency.  The work is small (at B=32, H=200
// hypotheses, S=1000 eval points: 6.4M inlier tests of ~70 float32
// operations, 2 atanf and 2 cosf each, and 60 chains of 30 dependent 3x3
// solves), and the bytes are a few hundred KB.  Design, three launches:
//
// * almeida_fit_kernel, a thread per (stream, hypothesis): its three
//   points and 30 LSQ iterations in registers.  All B x H fits run in one
//   wave, so the step pays one fit's latency (a chain of ~30 solves).
// * almeida_score_kernel, one CTA of 8 warps per (stream, 8 hypotheses):
//   the CTA stages the eval subset in shared memory, 1024 points at a time,
//   with each point's unprojected ray; warp w counts the inliers of
//   hypothesis w over it.  25 CTAs a stream at H=200, so B=8 already
//   spreads over the SMs.
// * almeida_refit_kernel, one CTA of 8 warps per stream: the first maximum
//   of the counts, the winner's inliers tested again with the same code
//   (so the same bits), then the 30 refit iterations, each a block sum of
//   three products over the subset in a fixed order (per thread, then a
//   shuffle tree, then the warps in order); every thread solves the 3x3
//   step itself from the sums, so no broadcast is needed.  The per-point
//   terms are kept in a global scratch row (L1/L2-resident) rather than in
//   shared memory, so the subset has no size limit.
//
// Same operations, same order as the plain version on the card: every
// multiply and add separately rounded (-fmad=false), IEEE division where
// PyTorch divides by a tensor, a multiply by the float32 reciprocal where
// it divides by a host scalar (PyTorch's CUDA division by a CPU scalar),
// precise cosf/sinf/atanf, and torch.sum's order over the 3 points of a
// fit.  The hypotheses, their counts and the winner are then the plain
// version's; only the refit's sums over the subset are taken in another
// order.

#include <cuda_runtime.h>

#include <cstdint>

namespace ofps_almeida {

// Camera and estimator constants, as the plain version folds them in.
struct Consts {
  float a[4][3];       // unproject rows: a0 * nx + a1 * ny + a2
  float g[4][4];       // project rows: g0 * x + g1 * y + g2 * z + g3
  float proto[3][9];   // the three EPS rotations, row-major
  float inv_eps;       // 1 / EPS in float32
  float inv_fx, inv_fy;  // 1 / the point-angle focals in float32
};

// kernels/almeida.py _Args, field for field.
struct Args {
  const float* pos;        // (B, N, 2) at pos_sb / pos_sn
  const float* motion;     // (B, N, 2) at mot_sb / mot_sn
  const float* mask;       // (B, N) at mask_sb / mask_sn
  const int64_t* fit_idx;  // (B, H, 3) point indices, batch stride fit_sb
  const int64_t* eidx;     // (B, S) eval point indices, batch stride eidx_sb
  const float* we;         // (B, S) eval weights, batch stride we_sb
  const float* bound;      // squared inlier angle per stream, or null
  float* fits;             // (B, H, 4) scratch: each hypothesis's rotation
  int* counts;             // (B, H) scratch: its inliers
  float* work;             // (B, kTerms, S) scratch: the refit's terms
  float* out_q;            // (B, 4) the camera rotation
  int* out_best;           // (B, 2) the winner and its count
  int64_t pos_sb, pos_sn, mot_sb, mot_sn, mask_sb, mask_sn;
  int64_t fit_sb, eidx_sb, we_sb, bound_sb;
  Consts c;
  float bound_value;  // the bound where `bound` is null
  float alpha;        // the LSQ step (estimators/almeida.py ALPHA)
  int B, H, S, iters;
};

}  // namespace ofps_almeida

using ofps_almeida::Args;
using ofps_almeida::Consts;

namespace {

constexpr int kFitThreads = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHypPerBlock = kWarps;  // warp w scores hypothesis w
constexpr int kChunk = 1024;          // eval points staged at a time
constexpr int kTerms = 14;            // refit scratch floats per point
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float x, y, z;
};

// ops/geometry_uv.py rotate_planes, the unproject half (per point).
__device__ __forceinline__ Ray unproject(const Consts& c, float px, float py) {
  const float nx = px * 2.0f - 1.0f;
  const float ny = py * 2.0f - 1.0f;
  const float h0 = c.a[0][0] * nx + c.a[0][1] * ny + c.a[0][2];
  const float h1 = c.a[1][0] * nx + c.a[1][1] * ny + c.a[1][2];
  const float h2 = c.a[2][0] * nx + c.a[2][1] * ny + c.a[2][2];
  const float hw = c.a[3][0] * nx + c.a[3][1] * ny + c.a[3][2];
  const float inv = 1.0f / hw;
  return {h0 * inv, h1 * inv, h2 * inv};
}

// ops/geometry_uv.py delta_planes: screen displacement of (px, py), whose
// ray is `u`, under the row-major rotation `r`.
__device__ __forceinline__ void delta(const Consts& c, const Ray& u, float px,
                                      float py, const float* r, float& du,
                                      float& dv) {
  const float vx = r[0] * u.x + r[1] * u.y + r[2] * u.z;
  const float vy = r[3] * u.x + r[4] * u.y + r[5] * u.z;
  const float vz = r[6] * u.x + r[7] * u.y + r[8] * u.z;
  const float g0 = c.g[0][0] * vx + c.g[0][1] * vy + c.g[0][2] * vz + c.g[0][3];
  const float g1 = c.g[1][0] * vx + c.g[1][1] * vy + c.g[1][2] * vz + c.g[1][3];
  const float g2 = c.g[2][0] * vx + c.g[2][1] * vy + c.g[2][2] * vz + c.g[2][3];
  const float gw = c.g[3][0] * vx + c.g[3][1] * vy + c.g[3][2] * vz + c.g[3][3];
  const float ginv = 1.0f / gw;
  const float n0 = g0 * ginv, n1 = g1 * ginv, n2 = g2 * ginv;
  const float sx = n0 / n2, sy = n1 / n2;
  du = (sx + 1.0f) * 0.5f - px;
  dv = (sy + 1.0f) * 0.5f - py;
}

// ops/geometry_uv.py qmat.
__device__ __forceinline__ void qmat(const float* q, float* r) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  r[0] = 1.0f - 2.0f * (y * y + z * z);
  r[1] = 2.0f * (x * y - w * z);
  r[2] = 2.0f * (x * z + w * y);
  r[3] = 2.0f * (x * y + w * z);
  r[4] = 1.0f - 2.0f * (x * x + z * z);
  r[5] = 2.0f * (y * z - w * x);
  r[6] = 2.0f * (x * z - w * y);
  r[7] = 2.0f * (y * z + w * x);
  r[8] = 1.0f - 2.0f * (x * x + y * y);
}

// ops/geometry_uv.py qmul (Hamilton product, (w, x, y, z)).
__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// One iteration's step of estimators/almeida.py _solve_ypr_planes: the
// Cramer solve (ops/geometry_uv.py solve3_planes), the step scaled by
// alpha, and q <- q * (pitch * (roll * yaw)).
__device__ __forceinline__ void lsq_step(const float* a, const float* b,
                                         float alpha, float* q) {
  const float a11 = a[0], a12 = a[1], a13 = a[2], a22 = a[3], a23 = a[4], a33 = a[5];
  const float c11 = a22 * a33 - a23 * a23;
  const float c12 = a13 * a23 - a12 * a33;
  const float c13 = a12 * a23 - a13 * a22;
  const float d = a11 * c11 + a12 * c12 + a13 * c13;
  const bool safe = fabsf(d) > 1e-30f;
  const float dinv = 1.0f / (safe ? d : 1.0f);
  const float c22 = a11 * a33 - a13 * a13;
  const float c23 = a12 * a13 - a11 * a23;
  const float c33 = a11 * a22 - a12 * a12;
  const float x1 = (b[0] * c11 + b[1] * c12 + b[2] * c13) * dinv;
  const float x2 = (b[0] * c12 + b[1] * c22 + b[2] * c23) * dinv;
  const float x3 = (b[0] * c13 + b[1] * c23 + b[2] * c33) * dinv;
  const float m1 = (safe ? x1 : 0.0f) * alpha;
  const float m2 = (safe ? x2 : 0.0f) * alpha;
  const float m3 = (safe ? x3 : 0.0f) * alpha;
  const float z = 0.0f;
  const float roll[4] = {cosf(m1 * 0.5f), z, sinf(m1 * 0.5f), z};
  const float pitch[4] = {cosf(m2 * 0.5f), sinf(m2 * 0.5f), z, z};
  const float yaw[4] = {cosf(m3 * 0.5f), z, z, -sinf(m3 * 0.5f)};
  float ry[4], pry[4], out[4];
  qmul(roll, yaw, ry);
  qmul(pitch, ry, pry);
  qmul(q, pry, out);
  for (int i = 0; i < 4; ++i) q[i] = out[i];
}

// torch.sum over a contiguous axis of 3 on the card: the reduction splits
// the axis over two lanes (elements 0 and 2, element 1), then adds them.
__device__ __forceinline__ float sum3(const float* t) {
  return (t[0] + t[2]) + t[1];
}

// The inlier test of one eval point under the rotation `r` (the
// hypothesis's qmat): solve_ypr_ransac's err2 <= bound.
__device__ __forceinline__ bool inlier(const Consts& c, const float* r,
                                       const Ray& u, float px, float py,
                                       float mu, float mv, float bound) {
  float du, dv;
  delta(c, u, px, py, r, du, dv);
  const float vu = mu - du, vv = mv - dv;
  const float au = atanf((px + du - 0.5f) * c.inv_fx);
  const float av = atanf((py + dv - 0.5f) * c.inv_fy);
  const float eu = vu * cosf(au), ev = vv * cosf(av);
  return eu * eu + ev * ev <= bound;
}

__device__ __forceinline__ float stream_bound(const Args& p, int b) {
  return p.bound != nullptr ? p.bound[b * p.bound_sb] : p.bound_value;
}

// The iterative LSQ fit of hypothesis h of stream b from its three points;
// returns its rotation (the points' rotation, before the conjugate).
__device__ void fit_hypothesis(const Args& p, int b, int h, float* q) {
  const Consts& c = p.c;
  float px[3], py[3], mu[3], mv[3], w[3], pu[3][3], pv[3][3];
  Ray u[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int64_t i = p.fit_idx[b * p.fit_sb + h * 3 + j];
    const float* ps = p.pos + b * p.pos_sb + i * p.pos_sn;
    const float* ms = p.motion + b * p.mot_sb + i * p.mot_sn;
    px[j] = ps[0];
    py[j] = ps[1];
    mu[j] = ms[0];
    mv[j] = ms[1];
    w[j] = p.mask[b * p.mask_sb + i * p.mask_sn];
    u[j] = unproject(c, px[j], py[j]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float du, dv;
      delta(c, u[j], px[j], py[j], c.proto[k], du, dv);
      pu[k][j] = du * c.inv_eps;
      pv[k][j] = dv * c.inv_eps;
    }
  }
  float a[6];
  {
    const int kk[6][2] = {{0, 0}, {0, 1}, {0, 2}, {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
    for (int e = 0; e < 6; ++e) {
      const int k = kk[e][0], l = kk[e][1];
      float t[3];
#pragma unroll
      for (int j = 0; j < 3; ++j) t[j] = w[j] * (pu[k][j] * pu[l][j] + pv[k][j] * pv[l][j]);
      a[e] = sum3(t);
    }
  }
  q[0] = 1.0f;
  q[1] = q[2] = q[3] = 0.0f;
  for (int it = 0; it < p.iters; ++it) {
    float r[9], t[3][3], bsum[3];
    qmat(q, r);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float du, dv;
      delta(c, u[j], px[j], py[j], r, du, dv);
      const float vu = mu[j] - du, vv = mv[j] - dv;
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k][j] = w[j] * (pu[k][j] * vu + pv[k][j] * vv);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) bsum[k] = sum3(t[k]);
    lsq_step(a, bsum, it == p.iters - 1 ? 1.0f : p.alpha, q);
  }
}

__device__ __forceinline__ void load_eval(const Args& p, int b, int s, float& px,
                                          float& py, float& mu, float& mv,
                                          bool& ok) {
  const int64_t i = p.eidx[b * p.eidx_sb + s];
  const float* ps = p.pos + b * p.pos_sb + i * p.pos_sn;
  const float* ms = p.motion + b * p.mot_sb + i * p.mot_sn;
  px = ps[0];
  py = ps[1];
  mu = ms[0];
  mv = ms[1];
  ok = p.we[b * p.we_sb + s] > 0.5f;
}

__global__ void __launch_bounds__(kFitThreads)
almeida_fit_kernel(Args p) {
  const int64_t i = (int64_t)blockIdx.x * kFitThreads + threadIdx.x;
  if (i >= (int64_t)p.B * p.H) return;
  float q[4];
  fit_hypothesis(p, (int)(i / p.H), (int)(i % p.H), q);
  for (int k = 0; k < 4; ++k) p.fits[i * 4 + k] = q[k];
}

__global__ void __launch_bounds__(kThreads)
almeida_score_kernel(Args p) {
  static_assert(kHypPerBlock == kWarps, "one hypothesis per warp");
  __shared__ float s_pt[8][kChunk];  // px, py, mu, mv, ray x, y, z, valid
  __shared__ float s_rot[kHypPerBlock][9];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h0 = blockIdx.x * kHypPerBlock;
  const int h = h0 + warp;
  const bool scores = h < p.H;  // uniform over the warp
  const float bound = stream_bound(p, b);
  int count = 0;
  for (int base = 0; base < p.S; base += kChunk) {
    const int n = min(kChunk, p.S - base);
    if (base > 0) __syncthreads();  // the last chunk is counted
    for (int s = tid; s < n; s += kThreads) {
      float px, py, mu, mv;
      bool ok;
      load_eval(p, b, base + s, px, py, mu, mv, ok);
      const Ray u = unproject(p.c, px, py);
      s_pt[0][s] = px;
      s_pt[1][s] = py;
      s_pt[2][s] = mu;
      s_pt[3][s] = mv;
      s_pt[4][s] = u.x;
      s_pt[5][s] = u.y;
      s_pt[6][s] = u.z;
      s_pt[7][s] = ok ? 1.0f : 0.0f;
    }
    if (base == 0 && tid < kHypPerBlock && h0 + tid < p.H)
      qmat(p.fits + ((int64_t)b * p.H + h0 + tid) * 4, s_rot[tid]);
    __syncthreads();
    if (scores) {
      float r[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) r[i] = s_rot[warp][i];
      for (int s = lane; s < n; s += 32) {
        if (s_pt[7][s] > 0.5f &&
            inlier(p.c, r, Ray{s_pt[4][s], s_pt[5][s], s_pt[6][s]}, s_pt[0][s],
                   s_pt[1][s], s_pt[2][s], s_pt[3][s], bound))
          ++count;
      }
    }
  }
  if (scores) {
    for (int off = 16; off >= 1; off /= 2) count += __shfl_xor_sync(kFull, count, off);
    if (lane == 0) p.counts[(int64_t)b * p.H + h] = count;
  }
}

// Sums v over the block, the same bits in every thread: each thread's own
// terms, a shuffle tree over the warp, then the warps in order.  `buf`
// alternates between calls (parity), so one barrier a call suffices.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*buf)[kWarps][6],
                                          int& parity) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k = 0; k < K; ++k)
    for (int off = 16; off >= 1; off /= 2) v[k] += __shfl_xor_sync(kFull, v[k], off);
  if (lane == 0)
    for (int k = 0; k < K; ++k) buf[parity][warp][k] = v[k];
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    float t = buf[parity][0][k];
    for (int i = 1; i < kWarps; ++i) t += buf[parity][i][k];
    v[k] = t;
  }
  parity ^= 1;
}

__global__ void __launch_bounds__(kThreads)
almeida_refit_kernel(Args p) {
  __shared__ int s_cnt[kWarps], s_idx[kWarps];
  __shared__ float s_sum[2][kWarps][6];
  const Consts& c = p.c;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // The first maximum of the counts (torch.argmax).
  int bc = -1, bi = 0;
  for (int h = tid; h < p.H; h += kThreads) {
    const int n = p.counts[(int64_t)b * p.H + h];
    if (n > bc) {
      bc = n;
      bi = h;
    }
  }
  for (int off = 16; off >= 1; off /= 2) {
    const int oc = __shfl_xor_sync(kFull, bc, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (oc > bc || (oc == bc && oi < bi)) {
      bc = oc;
      bi = oi;
    }
  }
  if (lane == 0) {
    s_cnt[warp] = bc;
    s_idx[warp] = bi;
  }
  __syncthreads();
  int best = s_idx[0], best_count = s_cnt[0];
  for (int i = 1; i < kWarps; ++i) {
    if (s_cnt[i] > best_count || (s_cnt[i] == best_count && s_idx[i] < best)) {
      best_count = s_cnt[i];
      best = s_idx[i];
    }
  }

  // The winner's inliers, tested again, and each point's refit terms.
  float r[9];
  qmat(p.fits + ((int64_t)b * p.H + best) * 4, r);
  const float bound = stream_bound(p, b);
  const int S = p.S;
  float* work = p.work + (int64_t)b * kTerms * S;
  float a[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = tid; s < S; s += kThreads) {
    float px, py, mu, mv;
    bool ok;
    load_eval(p, b, s, px, py, mu, mv, ok);
    const Ray u = unproject(c, px, py);
    const float w = ok && inlier(c, r, u, px, py, mu, mv, bound) ? 1.0f : 0.0f;
    float pu[3], pv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float du, dv;
      delta(c, u, px, py, c.proto[k], du, dv);
      pu[k] = du * c.inv_eps;
      pv[k] = dv * c.inv_eps;
    }
    const float terms[kTerms] = {px, py, mu, mv, u.x, u.y, u.z, w,
                                 pu[0], pv[0], pu[1], pv[1], pu[2], pv[2]};
#pragma unroll
    for (int f = 0; f < kTerms; ++f) work[f * S + s] = terms[f];
    a[0] += w * (pu[0] * pu[0] + pv[0] * pv[0]);
    a[1] += w * (pu[0] * pu[1] + pv[0] * pv[1]);
    a[2] += w * (pu[0] * pu[2] + pv[0] * pv[2]);
    a[3] += w * (pu[1] * pu[1] + pv[1] * pv[1]);
    a[4] += w * (pu[1] * pu[2] + pv[1] * pv[2]);
    a[5] += w * (pu[2] * pu[2] + pv[2] * pv[2]);
  }
  int parity = 0;
  block_sum(a, s_sum, parity);

  // The refit: _solve_ypr_planes over the subset with the inlier weights.
  float q[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < p.iters; ++it) {
    qmat(q, r);
    float bsum[3] = {0.0f, 0.0f, 0.0f};
    for (int s = tid; s < S; s += kThreads) {
      const float* t = work + s;
      const float px = t[0], py = t[S], mu = t[2 * S], mv = t[3 * S];
      const Ray u{t[4 * S], t[5 * S], t[6 * S]};
      const float w = t[7 * S];
      float du, dv;
      delta(c, u, px, py, r, du, dv);
      const float vu = mu - du, vv = mv - dv;
      bsum[0] += w * (t[8 * S] * vu + t[9 * S] * vv);
      bsum[1] += w * (t[10 * S] * vu + t[11 * S] * vv);
      bsum[2] += w * (t[12 * S] * vu + t[13 * S] * vv);
    }
    block_sum(bsum, s_sum, parity);
    lsq_step(a, bsum, it == p.iters - 1 ? 1.0f : p.alpha, q);
  }
  if (tid == 0) {
    // The camera's rotation is the conjugate; under 3 inliers, identity.
    const bool found = best_count >= 3;
    float* o = p.out_q + (int64_t)b * 4;
    o[0] = found ? q[0] : 1.0f;
    o[1] = found ? -q[1] : 0.0f;
    o[2] = found ? -q[2] : 0.0f;
    o[3] = found ? -q[3] : 0.0f;
    p.out_best[b * 2] = best;
    p.out_best[b * 2 + 1] = best_count;
  }
}

}  // namespace

extern "C" int ofps_almeida_ransac(const Args* args, void* stream) {
  const Args a = *args;
  const int fits = (int)(((int64_t)a.B * a.H + kFitThreads - 1) / kFitThreads);
  almeida_fit_kernel<<<fits, kFitThreads, 0, (cudaStream_t)stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.H + kHypPerBlock - 1) / kHypPerBlock, a.B);
  almeida_score_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  almeida_refit_kernel<<<a.B, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
