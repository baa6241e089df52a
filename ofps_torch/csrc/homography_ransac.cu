// Homography's RANSAC and everything after it: the 4-point DLT of every
// hypothesis, the prescore on a strided subsample of the eval subset with
// its adaptive LMedS cut, the top finalists counted on the eval subset and
// the first-maximum winner; then over all the points the winner's inliers,
// the LO rounds, the final weighted DLT, the Gauss-Newton polish, the
// positive-depth sign, both decomposition families with their quaternions
// and the first minimum of their translation norms (ops/robust.py
// robust_fit with ops/homography.py dlt_homography, gn_refine_homography
// and decompose_homography; kernels/homography.py ransac_plain is the plain
// version).
//
// Replaces no TPU kernel: the JAX package leaves homography to XLA.
// PyTorch runs each tensor operation of the plain version as its own
// kernel, so in the consumers' CUDA graph the estimator was ~1,900 nodes a
// step, each a few microseconds of work.
//
// What bounds it on the H100: latency.  At B=8, 91 hypotheses and 16,384
// points the work is a few MFLOP (728 small DLT solves, 93k transfer
// errors in the prescore, 0.5M on the finalists, 4 to 13 passes over the
// points in the refit) and the bytes a few MB.  Three launches:
//
// * hg_fit_kernel, a thread per (stream, hypothesis): the sample's Hartley
//   transforms, its 8x9 system's gram, the null vector by inverse
//   iteration, the denormalization and the h22 scale.
// * hg_score_kernel, a CTA per stream, the eval subset's points staged in
//   shared memory: a warp per candidate takes its transfer errors on the
//   prescore points (4 a lane) and their masked median by the 31 rounds of
//   ops/robust.py masked_median; the stream's least median raises
//   the cut; the candidates' prescore counts under it; the stable
//   descending top finalists (a histogram of the counts, then one warp
//   walks the candidates in index order); a warp per finalist counts its
//   inliers on the eval subset; the first maximum wins.
// * hg_refit_kernel, a cluster of CTAs per stream (up to 8, as many as
//   keep one CTA an SM): passes over all the points, each CTA over its
//   share, each pass summing what one step of the plain version sums (a
//   block reduction, then the CTAs' sums through distributed shared
//   memory), with the small solves between passes on one thread of every
//   CTA (the same sums, the same solves).  The inlier sets are flags in
//   global memory, written once a set.  The plain version's repeats are
//   not passed again: an LO round that is refused is refused again with
//   the same inputs, the last refit on the current inliers is the final
//   DLT, and a Gauss-Newton step that is refused repeats, so the refit
//   takes 4 to 13 passes.
//
// The fit and the score are the plain version's on the card bit for bit:
// they repeat PyTorch's card arithmetic operation for operation
// (ransac_algebra.cuh; a divide by a tensor an IEEE division, `1 / x` then
// a multiply where it divides a number by a tensor, PyTorch's reduction
// orders for the sample's sums, cuBLAS's fused multiply-add chains for the
// inverse iteration's and the denormalization's products), so the
// candidates, the cut, the finalists and the winner are the plain
// version's.  The refit's sums over all the points take the
// block's order, so the refined homography and the rotation differ from
// the plain version's in the last bits (within 1e-6 rad; on pure rotation
// the fit is well conditioned, H = K R K^-1).

#include <cuda_runtime.h>

#include <cstdint>

#if defined(__CUDACC__)
#include <cooperative_groups.h>
#endif

#include "ransac_algebra.cuh"

namespace ofps_homography {

// kernels/homography.py _Args, field for field.
struct Args {
  const float* pos;      // (B, N, 2) screen points: batch stride pos_sb, point stride pos_sn
  const float* motion;   // (B, N, 2) their motion: mot_sb, mot_sn
  const float* mask;     // (B, N) point weights: mask_sb, mask_sn
  const int64_t* idx;    // (B, H, 4) minimal samples, batch stride idx_sb
  const int64_t* eidx;   // (B, S) eval subset, batch stride eidx_sb
  const float* we;       // (B, S) its weights, batch stride we_sb
  const float* thr;      // the threshold, per stream at thr_sb; null: thr_value
  float* models;         // (B, H, 9) the candidates
  int* valid;            // (B, H)
  float* med;            // (B, H) scratch: prescore medians
  int* pre;              // (B, H) scratch: prescore counts (-1 invalid)
  float* thr2;           // (B,) the adapted squared cut
  int64_t* cand;         // (B, F) the finalists
  int64_t* best;         // (B,) the winning hypothesis
  float* model;          // (B, 9) the winner, then the LO rounds' model
  float* out_h;          // (B, 9) the refined, sign-fixed homography
  float* out_q;          // (B, 2, 4) the two families' rotations
  float* out_tn;         // (B, 2) their squared translation norms
  float* out_rot;        // (B, 4) the first minimum's rotation
  float* out_inl;        // (B, N) the final inliers, 0 or 1
  float* out_score;      // (B,) their count
  uint8_t* flags;        // (B, 2, N) scratch: two inlier sets of the refit
  int64_t pos_sb, pos_sn, mot_sb, mot_sn, mask_sb, mask_sn, idx_sb, eidx_sb, we_sb, thr_sb;
  float thr_value;
  float sigma_c;         // 2.5 * 1.4826 in float32
  float start[9];        // the inverse iteration's (9, 1) start block
  float k[9];            // the camera intrinsics K
  int B, N, H, S, P, F, lo_iters, gn_iters;
};

}  // namespace ofps_homography

using ofps_homography::Args;

namespace {

constexpr int kSample = 4;
constexpr int kMaxPrescore = 128;     // 4 points a lane
constexpr int kMaxFinalists = 32;     // a warp each
constexpr int kMaxEval = 8192;        // eval points staged in shared memory (17 bytes each)
constexpr int kFitThreads = 64;
constexpr int kThreads = 1024;        // hg_score_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kRefitThreads = 512;    // hg_refit_kernel
constexpr int kRefitWarps = kRefitThreads / 32;
constexpr int kMaxSums = 32;          // values a refit pass sums
constexpr float kSqrt2 = 1.41421356237309515f;

// ops/homography.py homography_transfer_error of one correspondence
// (x, y) -> (u, v): transform_points, the guarded depth, the projection.
__device__ __forceinline__ float transfer_error(const float* h, float x, float y, float u,
                                                float v) {
  const float p0 = (x * h[0] + y * h[1]) + 1.0f * h[2];
  const float p1 = (x * h[3] + y * h[4]) + 1.0f * h[5];
  float z = (x * h[6] + y * h[7]) + 1.0f * h[8];
  z = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float dx = p0 / z - u, dy = p1 / z - v;
  return dx * dx + dy * dy;
}

// ops/solve.py inv3x3 (fallback 0): adjugate columns by linalg.cross, the
// determinant a 3-term sum.
__device__ void inv3(const float* a, float* out) {
  float c0[3], c1[3], c2[3];
  cross3(a + 3, a + 6, c0);
  cross3(a + 6, a, c1);
  cross3(a, a + 3, c2);
  const float t[3] = {a[0] * c0[0], a[1] * c0[1], a[2] * c0[2]};
  const float det = sum_tree<3>(t);
  const bool safe = fabsf(det) > 1e-30f;
  const float d = safe ? det : 1.0f;
  const float* cols[3] = {c0, c1, c2};
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) out[r * 3 + c] = safe ? cols[c][r] / d : 0.0f;
}

// The Hartley transform (ops/epipolar.py hartley_normalization) from its
// weight sum (clamped), its weighted centroid sums and its weighted
// distance sum: s = sqrt(2) / mean distance, as PyTorch takes it (a
// reciprocal, then the multiply).
__device__ void hartley(float wsum, float cx_sum, float cy_sum, float d_sum, float* t) {
  const float cx = cx_sum / wsum, cy = cy_sum / wsum;
  const float s = (1.0f / clamp_min(d_sum / wsum, 1e-12f)) * kSqrt2;
  const float r[9] = {s, 0.0f, -s * cx, 0.0f, s, -s * cy, 0.0f, 0.0f, 1.0f};
  for (int i = 0; i < 9; ++i) t[i] = r[i];
}

// ops/homography.py dlt_homography after its gram: the null vector, then
// inv(T2) H T1 scaled so h22 = 1 (by the Frobenius norm where |h22| is
// 1e-12 or less).  cuBLAS takes the inverse iteration's batched (9, 9) by
// (9, 1) products in two halves of k (split2) at the minimal fits' batches
// (B x 91 = 182, 728 and 2,912 measured on an H100, torch 2.11, CUDA 12.8)
// as at the eight-point's.
__device__ void dlt_finish(const float* gram, const float* t1, const float* t2,
                           const float* start, float* out) {
  float vec[9], t2i[9], tmp[9], hh[9], sq[9];
  smallest_eigvecs9<1>(gram, 3, start, true, vec);
  inv3(t2, t2i);
  matmul3(t2i, vec, tmp);
  matmul3(tmp, t1, hh);
  for (int i = 0; i < 9; ++i) sq[i] = hh[i] * hh[i];
  const float fro = sqrtf(sum_tree<9>(sq));
  const float scale = fabsf(hh[8]) > 1e-12f ? hh[8] : fro;
  for (int i = 0; i < 9; ++i) out[i] = hh[i] / scale;
}

__device__ __forceinline__ void load_point(const Args& p, int b, int64_t n, float& x, float& y,
                                           float& u, float& v) {
  const float* a = p.pos + b * p.pos_sb + n * p.pos_sn;
  const float* m = p.motion + b * p.mot_sb + n * p.mot_sn;
  x = a[0];
  y = a[1];
  u = x + m[0];
  v = y + m[1];
}

__device__ __forceinline__ float point_weight(const Args& p, int b, int64_t n) {
  return p.mask[b * p.mask_sb + n * p.mask_sn];
}

__global__ void __launch_bounds__(kFitThreads)
hg_fit_kernel(Args p) {
  const int64_t t = (int64_t)blockIdx.x * kFitThreads + threadIdx.x;
  if (t >= (int64_t)p.B * p.H) return;
  const int h = (int)(t % p.H);
  const int b = (int)(t / p.H);
  float x1[kSample][2], x2[kSample][2], w[kSample];
  for (int j = 0; j < kSample; ++j) {
    const int64_t i = p.idx[b * p.idx_sb + (int64_t)h * kSample + j];
    load_point(p, b, i, x1[j][0], x1[j][1], x2[j][0], x2[j][1]);
    w[j] = point_weight(p, b, i);
  }
  // hartley_normalization of both views: the sums over the 4 points in
  // PyTorch's orders (the weight and the distances along the contiguous
  // axis, the centroid along an outer one).
  float t1[9], t2[9];
  const float wsum = clamp_min(sum_tree<kSample>(w), 1e-12f);
  float (*views[2])[2] = {x1, x2};
  float* ts[2] = {t1, t2};
  for (int v = 0; v < 2; ++v) {
    float cx[kSample], cy[kSample], d[kSample];
    for (int j = 0; j < kSample; ++j) {
      cx[j] = views[v][j][0] * w[j];
      cy[j] = views[v][j][1] * w[j];
    }
    const float cx_sum = sum_outer<kSample>(cx), cy_sum = sum_outer<kSample>(cy);
    const float c[2] = {cx_sum / wsum, cy_sum / wsum};
    for (int j = 0; j < kSample; ++j) {
      const float dx = views[v][j][0] - c[0], dy = views[v][j][1] - c[1];
      d[j] = sqrtf(dx * dx + dy * dy) * w[j];
    }
    hartley(wsum, cx_sum, cy_sum, sum_tree<kSample>(d), ts[v]);
  }
  // The weighted rows of the normalized points (rows_a for the 4 points,
  // then rows_b) and their gram, an outer sum over the 8 rows.
  float rows[2 * kSample][9];
  for (int j = 0; j < kSample; ++j) {
    const float u1 = (x1[j][0] * t1[0] + x1[j][1] * t1[1]) + 1.0f * t1[2];
    const float v1 = (x1[j][0] * t1[3] + x1[j][1] * t1[4]) + 1.0f * t1[5];
    const float u2 = (x2[j][0] * t2[0] + x2[j][1] * t2[1]) + 1.0f * t2[2];
    const float v2 = (x2[j][0] * t2[3] + x2[j][1] * t2[4]) + 1.0f * t2[5];
    const float ra[9] = {-u1, -v1, -1.0f, 0.0f, 0.0f, 0.0f, u2 * u1, u2 * v1, u2};
    const float rb[9] = {0.0f, 0.0f, 0.0f, -u1, -v1, -1.0f, v2 * u1, v2 * v1, v2};
    for (int k = 0; k < 9; ++k) {
      rows[j][k] = ra[k] * w[j];
      rows[kSample + j][k] = rb[k] * w[j];
    }
  }
  float gram[81];
  for (int i = 0; i < 9; ++i)
    for (int k = 0; k < 9; ++k) {
      float prod[2 * kSample];
      for (int j = 0; j < 2 * kSample; ++j) prod[j] = rows[j][i] * rows[j][k];
      gram[i * 9 + k] = sum_outer<2 * kSample>(prod);
    }
  float m[9];
  dlt_finish(gram, t1, t2, p.start, m);
  float* out = p.models + ((int64_t)b * p.H + h) * 9;
  for (int i = 0; i < 9; ++i) out[i] = m[i];
  // robust_fit's gate: a non-finite candidate is not valid.
  p.valid[(int64_t)b * p.H + h] = all_finite(m, 9) ? 1 : 0;
}

// The transfer errors of model `h` on the prescore points held by this
// lane (point j = lane + 32 q, eval slot j * stride, from the staged eval
// subset) and their validity.
__device__ __forceinline__ void prescore_errors(const Args& p, const float4* pts,
                                                const uint8_t* okb, const float* h, int lane,
                                                float* err, bool* ok) {
  const int stride = p.S / p.P;
  for (int q = 0; q < kMaxPrescore / 32; ++q) {
    const int j = lane + 32 * q;
    err[q] = 0.0f;
    ok[q] = false;
    if (j < p.P) {
      const float4 pt = pts[j * stride];
      err[q] = transfer_error(h, pt.x, pt.y, pt.z, pt.w);
      ok[q] = okb[j * stride] != 0;
    }
  }
}

struct ScoreShared {
  float red[kWarps][2];
  int hist[kMaxPrescore + 2];
  int above[kMaxFinalists], above_count[kMaxFinalists], ties[kMaxFinalists];
  int fin[kMaxFinalists], score[kMaxFinalists];
  int na, cstar, best;
  float thr2;
};

__global__ void __launch_bounds__(kThreads)
hg_score_kernel(Args p) {
  __shared__ ScoreShared sh;
  // The eval subset's points (x1, y1, x2, y2) and whether each is valid,
  // staged once: every error below reads them from here.
  extern __shared__ float4 smem4[];
  float4* pts = smem4;
  uint8_t* okb = reinterpret_cast<uint8_t*>(smem4 + p.S);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t h0 = (int64_t)b * p.H;
  for (int s = tid; s < p.S; s += kThreads) {
    float x, y, u, v;
    load_point(p, b, p.eidx[b * p.eidx_sb + s], x, y, u, v);
    pts[s] = make_float4(x, y, u, v);
    okb[s] = p.we[b * p.we_sb + s] > 0.5f ? 1 : 0;
  }
  __syncthreads();

  // Each candidate's prescore median: ops/robust.py masked_median, the bit
  // patterns of max(err, 0) (NaNs keep theirs), invalid entries above
  // every candidate, 31 rounds of compare and count (a warp's count in one
  // __reduce_add_sync).
  for (int c = warp; c < p.H; c += kWarps) {
    float h[9], err[kMaxPrescore / 32];
    bool ok[kMaxPrescore / 32];
    for (int i = 0; i < 9; ++i) h[i] = p.models[(h0 + c) * 9 + i];
    prescore_errors(p, pts, okb, h, lane, err, ok);
    uint64_t u[kMaxPrescore / 32];
    int nv = 0;
    for (int q = 0; q < kMaxPrescore / 32; ++q) {
      const uint32_t bits = __float_as_uint(err[q]);
      const bool negative = bits >= 0x80000000u && (bits & 0x7fffffffu) <= 0x7f800000u;
      u[q] = ok[q] ? (negative ? 0ull : (uint64_t)bits) : (1ull << 32);
      nv += ok[q] ? 1 : 0;
    }
    const int nvalid = (int)__reduce_add_sync(kFull, (unsigned)nv);
    const int kp1 = (nvalid - 1 > 0 ? nvalid - 1 : 0) / 2 + 1;
    uint64_t pm = 0;
    for (int i = 0; i < 31; ++i) {
      const uint64_t t = pm | (1ull << (30 - i));
      unsigned cnt = 0;
      for (int q = 0; q < kMaxPrescore / 32; ++q) cnt += u[q] < t ? 1u : 0u;
      if ((int)__reduce_add_sync(kFull, cnt) < kp1) pm = t;
    }
    if (lane == 0) p.med[h0 + c] = nvalid > 0 ? __uint_as_float((uint32_t)pm) : 1e30f;
  }
  __syncthreads();

  // The adapted squared cut (robust_fit's raise_to_lmeds_cut on the
  // prescore medians): the least median over the valid candidates.
  {
    float mn = f_inf(), swe = 0.0f;
    for (int c = tid; c < p.H; c += kThreads)
      mn = nan_min(mn, p.valid[h0 + c] ? p.med[h0 + c] : 1e30f);
    for (int s = tid; s < p.S; s += kThreads) swe += p.we[b * p.we_sb + s];
    for (int off = 16; off >= 1; off /= 2) {
      mn = nan_min(mn, __shfl_xor_sync(kFull, mn, off));
      swe += __shfl_xor_sync(kFull, swe, off);
    }
    if (lane == 0) {
      sh.red[warp][0] = mn;
      sh.red[warp][1] = swe;
    }
    __syncthreads();
    if (tid == 0) {
      float med_best = sh.red[0][0], nvalid = sh.red[0][1];
      for (int i = 1; i < kWarps; ++i) {
        med_best = nan_min(med_best, sh.red[i][0]);
        nvalid += sh.red[i][1];
      }
      // nvalid = clamp(sum(we), min=k + 1): a count, exact in any order;
      // sigma_k = 2.5 * 1.4826 * (1 + 5 / (nvalid - k)), the division a
      // reciprocal times 5 (__rtruediv__).
      nvalid = clamp_min(nvalid, (float)kSample + 1.0f);
      const float sigma = p.sigma_c * (1.0f + (1.0f / (nvalid - (float)kSample)) * 5.0f);
      const float t = p.thr != nullptr ? p.thr[b * p.thr_sb] : p.thr_value;
      sh.thr2 = nan_max(t * t, (sigma * sigma) * clamp_min(med_best, 0.0f));
      p.thr2[b] = sh.thr2;
    }
    __syncthreads();
  }
  const float thr2 = sh.thr2;

  // The prescore counts under the cut.
  for (int c = warp; c < p.H; c += kWarps) {
    float h[9], err[kMaxPrescore / 32];
    bool ok[kMaxPrescore / 32];
    for (int i = 0; i < 9; ++i) h[i] = p.models[(h0 + c) * 9 + i];
    prescore_errors(p, pts, okb, h, lane, err, ok);
    int cnt = 0;
    for (int q = 0; q < kMaxPrescore / 32; ++q) cnt += (ok[q] && err[q] <= thr2) ? 1 : 0;
    cnt = warp_sum(cnt);
    if (lane == 0) p.pre[h0 + c] = p.valid[h0 + c] ? cnt : -1;
  }
  for (int i = tid; i < kMaxPrescore + 2; i += kThreads) sh.hist[i] = 0;
  __syncthreads();

  // The finalists: jax.lax.top_k's order of the prescore counts
  // (descending, the lower index first among ties).  The counts lie in
  // [-1, P]: the histogram gives the count c* of the last finalist and how
  // many counts exceed it.
  for (int c = tid; c < p.H; c += kThreads) atomicAdd(&sh.hist[p.pre[h0 + c] + 1], 1);
  __syncthreads();
  if (tid == 0) {
    int cum = 0, cs = -1;
    for (int v = p.P; v >= -1; --v) {
      if (cum + sh.hist[v + 1] >= p.F) {
        cs = v;
        break;
      }
      cum += sh.hist[v + 1];
    }
    sh.cstar = cs;
    sh.na = cum;
  }
  __syncthreads();
  if (warp == 0) {
    const int cs = sh.cstar, need = p.F - sh.na;
    int na = 0, nt = 0;
    for (int base = 0; base < p.H; base += 32) {
      const int c = base + lane;
      const int v = c < p.H ? p.pre[h0 + c] : -2;
      const unsigned lt = (1u << lane) - 1u;
      const unsigned ab = __ballot_sync(kFull, v > cs);
      const unsigned ti = __ballot_sync(kFull, v == cs);
      if (v > cs) {
        sh.above[na + __popc(ab & lt)] = c;
        sh.above_count[na + __popc(ab & lt)] = v;
      }
      if (v == cs && nt + __popc(ti & lt) < need) sh.ties[nt + __popc(ti & lt)] = c;
      na += __popc(ab);
      nt += __popc(ti);
    }
    __syncwarp();
    if (lane == 0) {
      // A stable insertion sort of the counts above c*, descending.
      for (int i = 1; i < na; ++i) {
        const int key = sh.above[i], kv = sh.above_count[i];
        int j = i - 1;
        while (j >= 0 && sh.above_count[j] < kv) {
          sh.above[j + 1] = sh.above[j];
          sh.above_count[j + 1] = sh.above_count[j];
          --j;
        }
        sh.above[j + 1] = key;
        sh.above_count[j + 1] = kv;
      }
      for (int i = 0; i < p.F; ++i) sh.fin[i] = i < na ? sh.above[i] : sh.ties[i - na];
    }
  }
  __syncthreads();

  // Each finalist's inliers on the eval subset, a warp each.
  if (warp < p.F) {
    const int64_t c = h0 + sh.fin[warp];
    float h[9];
    for (int i = 0; i < 9; ++i) h[i] = p.models[c * 9 + i];
    int cnt = 0;
    for (int s = lane; s < p.S; s += 32) {
      const float4 pt = pts[s];
      cnt += (transfer_error(h, pt.x, pt.y, pt.z, pt.w) <= thr2 && okb[s]) ? 1 : 0;
    }
    cnt = warp_sum(cnt);
    if (lane == 0) sh.score[warp] = p.valid[c] ? cnt : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int i = 1; i < p.F; ++i)
      if (sh.score[i] > sh.score[best]) best = i;  // first maximum
    const int win = sh.fin[best];
    for (int i = 0; i < 9; ++i) p.model[(int64_t)b * 9 + i] = p.models[(h0 + win) * 9 + i];
    for (int i = 0; i < p.F; ++i) p.cand[(int64_t)b * p.F + i] = sh.fin[i];
    p.best[b] = win;
  }
}

// -- the refit over all the points -----------------------------------------

// A stream's refit runs on a cluster of CTAs (the launch sets its size):
// each CTA passes over its share of the points and the CTAs add their
// sums through distributed shared memory, every CTA in rank order, so all
// hold the same totals and make the same small solves.  The CPU emulation
// (tests/cuda_cpu_emu.h) runs one CTA at a time: a cluster of one.
#if defined(__CUDACC__)
namespace cg = cooperative_groups;
__device__ __forceinline__ int cluster_size() { return (int)cg::this_cluster().num_blocks(); }
__device__ __forceinline__ int cluster_rank() { return (int)cg::this_cluster().block_rank(); }
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }
__device__ __forceinline__ const float* cluster_peer(float* x, int rank) {
  return cg::this_cluster().map_shared_rank(x, rank);
}
#else
__device__ __forceinline__ int cluster_size() { return 1; }
__device__ __forceinline__ int cluster_rank() { return 0; }
__device__ __forceinline__ void cluster_sync() { __syncthreads(); }
__device__ __forceinline__ const float* cluster_peer(float* x, int) { return x; }
#endif

struct RefitShared {
  float red[kRefitWarps][kMaxSums];
  float part[2][kMaxSums];  // this CTA's sums, by the parity of the pass
  float sums[kMaxSums];     // the cluster's
  float im[9];      // the LO model: the winner, then the last refit kept
  float m2[9];      // a refit / a Gauss-Newton candidate
  float cur[9];     // the current homography
  float csum[5];    // the inliers' count and centroid sums (x1, y1, x2, y2)
};

// The points of a stream that this thread passes over, and the inlier
// flags of two sets (the current one and a refit's) in p.flags.
struct Share {
  int b, first, step, parity;
  uint8_t* flags[2];
};

// The cluster's sums of the K values each thread holds, into sh.sums for
// every thread: the warps (a lane tree each up to 5 values, more by
// halving: at each of the 5 steps a lane keeps half of its values and
// adds its partner's copies of them, so that lane l ends with the warp's
// sum of value l, in 31 shuffles), the CTA's warps in order, then the
// cluster's CTAs in rank order.
template <int K>
__device__ void block_sums(float (&v)[K], RefitShared& sh, Share& me) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (K <= 5) {
    for (int k = 0; k < K; ++k) {
      float x = v[k];
      for (int off = 16; off >= 1; off /= 2) x += __shfl_xor_sync(kFull, x, off);
      if (lane == 0) sh.red[warp][k] = x;
    }
  } else {
    float x[32];
    for (int k = 0; k < 32; ++k) x[k] = k < K ? v[k] : 0.0f;
    int n = 32;
    for (int off = 16; off >= 1; off /= 2) {
      n /= 2;
      const bool upper = (lane & off) != 0;
      for (int j = 0; j < n; ++j) {
        const float send = upper ? x[j] : x[j + n];
        const float keep = upper ? x[j + n] : x[j];
        x[j] = keep + __shfl_xor_sync(kFull, send, off);
      }
    }
    if (lane < K) sh.red[warp][lane] = x[0];
  }
  __syncthreads();
  if ((int)threadIdx.x < K) {
    float s = 0.0f;
    for (int w = 0; w < kRefitWarps; ++w) s += sh.red[w][threadIdx.x];
    sh.part[me.parity][threadIdx.x] = s;
  }
  // A CTA writes the other parity's sums only after the next pass's
  // barrier, which every CTA reaches after reading these.
  cluster_sync();
  if ((int)threadIdx.x < K) {
    float s = 0.0f;
    for (int r = 0; r < cluster_size(); ++r)
      s += cluster_peer(sh.part[me.parity], r)[threadIdx.x];
    sh.sums[threadIdx.x] = s;
  }
  me.parity ^= 1;
  __syncthreads();
}

// Whether point (x, y) -> (u, v) of weight w is an inlier of `im` under
// the cut, as 1 or 0; its error in `e`.
__device__ __forceinline__ float inlier(const float* im, float cut, float x, float y, float u,
                                        float v, float w, float& e) {
  e = transfer_error(im, x, y, u, v);
  return (e <= cut && w > 0.5f) ? 1.0f : 0.0f;
}

// The weighted DLT (dlt_homography) of the inlier set `set`, from its
// count and centroid sums in sh.csum: a pass for the mean distances, a
// pass for the normal matrix, then the solve into sh.m2.
__device__ void refit_dlt(const Args& p, int set, RefitShared& sh, Share& me) {
  const int b = me.b, tid = threadIdx.x;
  const uint8_t* fl = me.flags[set];
  const float wsum = clamp_min(sh.csum[0], 1e-12f);
  const float c1x = sh.csum[1] / wsum, c1y = sh.csum[2] / wsum;
  const float c2x = sh.csum[3] / wsum, c2y = sh.csum[4] / wsum;
  {
    float v[2] = {0.0f, 0.0f};
    for (int n = me.first; n < p.N; n += me.step) {
      float x, y, u, vv;
      load_point(p, b, n, x, y, u, vv);
      const float in = fl[n];
      const float dx = x - c1x, dy = y - c1y, du = u - c2x, dv = vv - c2y;
      v[0] += sqrtf(dx * dx + dy * dy) * in;
      v[1] += sqrtf(du * du + dv * dv) * in;
    }
    block_sums(v, sh, me);
  }
  float t1[9], t2[9];
  hartley(wsum, sh.csum[1], sh.csum[2], sh.sums[0], t1);
  hartley(wsum, sh.csum[3], sh.csum[4], sh.sums[1], t2);
  // The normal matrix of the weighted rows: with r = (u1, v1, 1), rows_a
  // = w (-r, 0, u2 r) and rows_b = w (0, -r, v2 r), so its blocks are sums
  // of w^2 r r^T times 1, -u2, -v2 and u2^2 + v2^2 (6 entries each).
  float v[24];
  for (int k = 0; k < 24; ++k) v[k] = 0.0f;
  for (int n = me.first; n < p.N; n += me.step) {
    float x, y, u, vv;
    load_point(p, b, n, x, y, u, vv);
    const float in = fl[n];
    const float u1 = (x * t1[0] + y * t1[1]) + 1.0f * t1[2];
    const float v1 = (x * t1[3] + y * t1[4]) + 1.0f * t1[5];
    const float u2 = (u * t2[0] + vv * t2[1]) + 1.0f * t2[2];
    const float v2 = (u * t2[3] + vv * t2[4]) + 1.0f * t2[5];
    const float w2 = in * in;
    const float rr[6] = {u1 * u1 * w2, u1 * v1 * w2, u1 * w2, v1 * v1 * w2, v1 * w2, w2};
    const float uv = u2 * u2 + v2 * v2;
    for (int k = 0; k < 6; ++k) {
      v[k] += rr[k];
      v[6 + k] += rr[k] * u2;
      v[12 + k] += rr[k] * v2;
      v[18 + k] += rr[k] * uv;
    }
  }
  block_sums(v, sh, me);
  if (tid == 0) {
    // rr's 6 entries as a symmetric 3x3 (row i, column j).
    const int sym[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
    float g[81];
    for (int i = 0; i < 81; ++i) g[i] = 0.0f;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const int k = sym[i][j];
        g[i * 9 + j] = sh.sums[k];
        g[(3 + i) * 9 + 3 + j] = sh.sums[k];
        g[i * 9 + 6 + j] = g[(6 + j) * 9 + i] = -sh.sums[6 + k];
        g[(3 + i) * 9 + 6 + j] = g[(6 + j) * 9 + 3 + i] = -sh.sums[12 + k];
        g[(6 + i) * 9 + 6 + j] = sh.sums[18 + k];
      }
    dlt_finish(g, t1, t2, p.start, sh.m2);
  }
  __syncthreads();
}

// One pass of the polish at sh.cur (gn_refine_homography's step, h22 = 1
// already) over the inlier set `set`: the normal equations J^T J (21
// distinct entries) and J^T r (8) of the weighted residuals, the weighted
// SSE, and the positive-depth sum x2n . (Hn x1n) over the inliers (kinv_h
// = K^-1 cur), into sh.sums.
__device__ void gn_pass(const Args& p, int set, const float* kinv, RefitShared& sh, Share& me) {
  const int b = me.b;
  const uint8_t* fl = me.flags[set];
  float h[9], kh[9];
  for (int i = 0; i < 9; ++i) h[i] = sh.cur[i];
  matmul3(kinv, h, kh);
  float v[31];
  for (int k = 0; k < 31; ++k) v[k] = 0.0f;
  for (int n = me.first; n < p.N; n += me.step) {
    float x, y, u, vv;
    load_point(p, b, n, x, y, u, vv);
    const float w = fl[n];
    const float p0 = (x * h[0] + y * h[1]) + 1.0f * h[2];
    const float p1 = (x * h[3] + y * h[4]) + 1.0f * h[5];
    float z = (x * h[6] + y * h[7]) + 1.0f * h[8];
    z = fabsf(z) > 1e-12f ? z : 1e-12f;
    const float e0 = p0 / z - u, e1 = p1 / z - vv;
    const float r0 = e0 * w, r1 = e1 * w;
    const float iz = 1.0f / z, iz2 = iz * iz;
    const float xz[3] = {x * iz * w, y * iz * w, iz * w};
    const float a0[2] = {-p0 * x * iz2 * w, -p0 * y * iz2 * w};
    const float a1[2] = {-p1 * x * iz2 * w, -p1 * y * iz2 * w};
    int k = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = i; j < 3; ++j) v[k++] += xz[i] * xz[j];          // 0..5
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 2; ++j) {
        v[6 + i * 2 + j] += xz[i] * a0[j];                             // 6..11
        v[12 + i * 2 + j] += xz[i] * a1[j];                            // 12..17
      }
    v[18] += a0[0] * a0[0] + a1[0] * a1[0];
    v[19] += a0[0] * a0[1] + a1[0] * a1[1];
    v[20] += a0[1] * a0[1] + a1[1] * a1[1];
    for (int i = 0; i < 3; ++i) {
      v[21 + i] += xz[i] * r0;
      v[24 + i] += xz[i] * r1;
    }
    v[27] += a0[0] * r0 + a1[0] * r1;
    v[28] += a0[1] * r0 + a1[1] * r1;
    v[29] += (e0 * e0 + e1 * e1) * w;
    // a = (K^-1 H) x1, b = K^-1 x2, both homogeneous.
    float an[3], bn[3];
    for (int i = 0; i < 3; ++i) {
      an[i] = (x * kh[i * 3] + y * kh[i * 3 + 1]) + kh[i * 3 + 2];
      bn[i] = (u * kinv[i * 3] + vv * kinv[i * 3 + 1]) + kinv[i * 3 + 2];
    }
    v[30] += ((an[0] * bn[0] + an[1] * bn[1]) + an[2] * bn[2]) * w;
  }
  block_sums(v, sh, me);
}

// The Gauss-Newton step from a gn_pass's sums: Levenberg damping, the
// unpivoted Gauss-Jordan solve (ops/solve.py gauss_solve), cur + delta.
__device__ void gn_step(const float* s, const float* cur, float* cand) {
  float jtj[8][9];
  const int xx[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) jtj[i][j] = 0.0f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) jtj[i][j] = jtj[3 + i][3 + j] = s[xx[i][j]];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 2; ++j) {
      jtj[i][6 + j] = jtj[6 + j][i] = s[6 + i * 2 + j];
      jtj[3 + i][6 + j] = jtj[6 + j][3 + i] = s[12 + i * 2 + j];
    }
  jtj[6][6] = s[18];
  jtj[6][7] = jtj[7][6] = s[19];
  jtj[7][7] = s[20];
  float tr = 0.0f;
  for (int i = 0; i < 8; ++i) tr += jtj[i][i];
  const float damp = (1e-8f * tr) * (1.0f / 8.0f);
  for (int i = 0; i < 8; ++i) {
    jtj[i][i] = jtj[i][i] + damp;
    jtj[i][8] = -s[21 + i];
  }
  for (int k = 0; k < 8; ++k) {
    float piv[9];
    const float d = jtj[k][k];
    for (int j = 0; j < 9; ++j) piv[j] = jtj[k][j] / d;
    for (int i = 0; i < 8; ++i) {
      if (i == k) continue;
      const float f = jtj[i][k];
      for (int j = 0; j < 9; ++j) jtj[i][j] = jtj[i][j] - f * piv[j];
    }
    for (int j = 0; j < 9; ++j) jtj[k][j] = piv[j];
  }
  for (int i = 0; i < 8; ++i) cand[i] = cur[i] + jtj[i][8];
  cand[8] = cur[8] + 0.0f;
}

// core/quat.py from_matrix3 (Shepperd, first maximum, w >= 0), then the
// axis remap of estimators/convention.py (w, -x, -z, y).
__device__ void quat_of(const float* r, float* q) {
  const float m00 = r[0], m01 = r[1], m02 = r[2], m10 = r[3], m11 = r[4], m12 = r[5];
  const float m20 = r[6], m21 = r[7], m22 = r[8];
  const float tr = (m00 + m11) + m22;
  const float cases[4][4] = {
      {1.0f + tr, m21 - m12, m02 - m20, m10 - m01},
      {m21 - m12, ((1.0f + m00) - m11) - m22, m01 + m10, m02 + m20},
      {m02 - m20, m01 + m10, ((1.0f - m00) + m11) - m22, m12 + m21},
      {m10 - m01, m02 + m20, m12 + m21, ((1.0f - m00) - m11) + m22}};
  const float mags[4] = {cases[0][0], cases[1][1], cases[2][2], cases[3][3]};
  int best = 0;
  for (int j = 1; j < 4 && !isnan(mags[best]); ++j)  // torch.argmax: a NaN is the maximum
    if (isnan(mags[j]) || mags[j] > mags[best]) best = j;
  const float* c = cases[best];
  const float n = clamp_min(sqrtf(((c[0] * c[0] + c[1] * c[1]) + c[2] * c[2]) + c[3] * c[3]),
                            1e-30f);
  float qq[4];
  for (int i = 0; i < 4; ++i) qq[i] = c[i] / n;
  const float sg = qq[0] < 0.0f ? -1.0f : 1.0f;
  q[0] = sg * qq[0];
  q[1] = -(sg * qq[1]);
  q[2] = -(sg * qq[3]);
  q[3] = sg * qq[2];
}

// ops/homography.py decompose_homography's two families (rotation and
// translation) of `h` with intrinsics k and k^-1.
__device__ void decompose(const float* h, const float* k, const float* kinv, float (*rs)[9],
                          float (*ts)[3]) {
  float tmp[9], hn[9], u[9], s[3], vt[9], hnt[9], hth[9], lam[3], vec[9];
  matmul3(kinv, h, tmp);
  matmul3(tmp, k, hn);
  svd3(hn, u, s, vt);
  for (int i = 0; i < 9; ++i) hn[i] = hn[i] / s[1];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) hnt[i * 3 + j] = hn[j * 3 + i];
  matmul3(hnt, hn, hth);
  eigh3(hth, lam, vec);
  const float s3sq = lam[0], s1sq = lam[2];
  float v1[3], v2[3], v3[3];
  for (int i = 0; i < 3; ++i) {
    v3[i] = vec[i * 3];
    v2[i] = vec[i * 3 + 1];
    v1[i] = vec[i * 3 + 2];
  }
  const float denom = clamp_min(s1sq - s3sq, 1e-12f);
  const float a = sqrtf(clamp_min(1.0f - s3sq, 0.0f) / denom);
  const float bb = sqrtf(clamp_min(s1sq - 1.0f, 0.0f) / denom);
  const bool degenerate = (s1sq - s3sq) < 1e-4f;
  // The pure-rotation branch: 4 Newton polar steps from hn.
  float rr[9];
  for (int i = 0; i < 9; ++i) rr[i] = hn[i];
  for (int it = 0; it < 4; ++it) {
    float det = det3(rr);
    det = fabsf(det) > 1e-20f ? det : 1e-20f;
    float cof[9];
    cross3(rr + 3, rr + 6, cof);
    cross3(rr + 6, rr, cof + 3);
    cross3(rr, rr + 3, cof + 6);
    for (int i = 0; i < 9; ++i) rr[i] = 0.5f * (rr[i] + cof[i] / det);
  }
  for (int f = 0; f < 2; ++f) {
    float uu[3], n[3], hv2[3], hu[3], hw[3], bu[9], bw[9], r[9];
    for (int i = 0; i < 3; ++i) uu[i] = f == 0 ? a * v1[i] + bb * v3[i] : a * v1[i] - bb * v3[i];
    cross3(v2, uu, n);
    for (int i = 0; i < 3; ++i) {
      hv2[i] = (hn[i * 3] * v2[0] + hn[i * 3 + 1] * v2[1]) + hn[i * 3 + 2] * v2[2];
      hu[i] = (hn[i * 3] * uu[0] + hn[i * 3 + 1] * uu[1]) + hn[i * 3 + 2] * uu[2];
    }
    cross3(hv2, hu, hw);
    for (int i = 0; i < 3; ++i) {
      bu[i * 3] = v2[i];
      bu[i * 3 + 1] = uu[i];
      bu[i * 3 + 2] = n[i];
      bw[i * 3] = hv2[i];
      bw[i * 3 + 1] = hu[i];
      bw[i * 3 + 2] = hw[i];
    }
    float but[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) but[i * 3 + j] = bu[j * 3 + i];
    matmul3(bw, but, r);
    for (int i = 0; i < 3; ++i) {
      const float d0 = hn[i * 3] - r[i * 3], d1 = hn[i * 3 + 1] - r[i * 3 + 1];
      const float d2 = hn[i * 3 + 2] - r[i * 3 + 2];
      ts[f][i] = degenerate ? 0.0f : (d0 * n[0] + d1 * n[1]) + d2 * n[2];
    }
    for (int i = 0; i < 9; ++i) rs[f][i] = degenerate ? rr[i] : r[i];
  }
}

__global__ void __launch_bounds__(kRefitThreads)
hg_refit_kernel(Args p) {
  __shared__ RefitShared sh;
  const int tid = threadIdx.x, rank = cluster_rank(), csize = cluster_size();
  Share me;
  me.b = blockIdx.x / csize;
  me.first = rank * kRefitThreads + tid;
  me.step = csize * kRefitThreads;
  me.parity = 0;
  me.flags[0] = p.flags + (int64_t)me.b * 2 * p.N;
  me.flags[1] = me.flags[0] + p.N;
  const int b = me.b;
  const float cut = p.thr2[b];
  if (tid < 9) sh.im[tid] = p.model[(int64_t)b * 9 + tid];
  __syncthreads();

  // The winner's inliers over all the points (set 0): their count, their
  // errors' sum (err_cur) and their centroid sums.
  float ninl, err_cur;
  int set = 0;
  {
    float im[9];
    for (int i = 0; i < 9; ++i) im[i] = sh.im[i];
    float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = me.first; n < p.N; n += me.step) {
      float x, y, u, vv, e;
      load_point(p, b, n, x, y, u, vv);
      const float in = inlier(im, cut, x, y, u, vv, point_weight(p, b, n), e);
      me.flags[0][n] = (uint8_t)in;
      v[0] += in;
      v[1] += e * in;
      v[2] += x * in;
      v[3] += y * in;
      v[4] += u * in;
      v[5] += vv * in;
    }
    block_sums(v, sh, me);
    ninl = sh.sums[0];
    err_cur = sh.sums[1];
    if (tid < 5) sh.csum[tid] = tid == 0 ? sh.sums[0] : sh.sums[tid + 1];
    __syncthreads();
  }

  // The LO rounds: a refit on the inliers, kept where the inlier set does
  // not shrink, the error over the current inliers strictly drops and the
  // refit is finite.  sh.m2 always holds the DLT of the current inliers,
  // which is also the final refit.
  refit_dlt(p, set, sh, me);
  for (int round = 0; round < p.lo_iters; ++round) {
    float m2[9];
    for (int i = 0; i < 9; ++i) m2[i] = sh.m2[i];
    const uint8_t* fl = me.flags[set];
    uint8_t* fl2 = me.flags[set ^ 1];
    float v[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = me.first; n < p.N; n += me.step) {
      float x, y, u, vv, e2;
      load_point(p, b, n, x, y, u, vv);
      const float in = fl[n];
      const float in2 = inlier(m2, cut, x, y, u, vv, point_weight(p, b, n), e2);
      fl2[n] = (uint8_t)in2;
      v[0] += in2;
      v[1] += e2 * in;
      v[2] += e2 * in2;
      v[3] += x * in2;
      v[4] += y * in2;
      v[5] += u * in2;
      v[6] += vv * in2;
    }
    block_sums(v, sh, me);
    const bool good = sh.sums[0] >= ninl && sh.sums[1] < err_cur && all_finite(m2, 9);
    if (!good) break;  // a refused round is refused again: same inputs
    ninl = sh.sums[0];
    err_cur = sh.sums[2];
    set ^= 1;
    __syncthreads();
    if (tid < 9) sh.im[tid] = m2[tid];
    if (tid < 5) sh.csum[tid] = tid == 0 ? sh.sums[0] : sh.sums[tid + 2];
    __syncthreads();
    refit_dlt(p, set, sh, me);
  }

  // The Gauss-Newton polish of the final refit, h22 = 1 (the same steps
  // as gn_refine_homography; a refused step repeats, so the polish stops
  // at the first).
  float kinv[9];
  inv3(p.k, kinv);
  if (tid < 9) {
    const float h22 = sh.m2[8];
    const float scale = fabsf(h22) > 1e-12f ? h22 : 1.0f;
    sh.cur[tid] = sh.m2[tid] / scale;
  }
  __syncthreads();
  gn_pass(p, set, kinv, sh, me);
  float sums[31];
  for (int k = 0; k < 31; ++k) sums[k] = sh.sums[k];
  for (int it = 0; it < p.gn_iters; ++it) {
    __syncthreads();
    if (tid == 0) gn_step(sums, sh.cur, sh.m2);
    __syncthreads();
    float keep_cur[9];
    for (int i = 0; i < 9; ++i) keep_cur[i] = sh.cur[i];
    __syncthreads();
    if (tid < 9) sh.cur[tid] = sh.m2[tid];
    __syncthreads();
    gn_pass(p, set, kinv, sh, me);
    if (!(sh.sums[29] < sums[29])) {  // keep = sse(cand) < sse(hm)
      __syncthreads();
      if (tid < 9) sh.cur[tid] = keep_cur[tid];
      __syncthreads();
      break;
    }
    for (int k = 0; k < 31; ++k) sums[k] = sh.sums[k];
  }

  // The final inliers, this CTA's share.
  for (int n = me.first; n < p.N; n += me.step)
    p.out_inl[(int64_t)b * p.N + n] = me.flags[set][n];
  if (rank == 0 && tid < 9) p.model[(int64_t)b * 9 + tid] = sh.im[tid];
  if (rank == 0 && tid == 0) {
    // The sign: positive depth on the inliers (torch.sign, 0 keeps it).
    const float sg = sign_of(sums[30]);
    float h[9];
    for (int i = 0; i < 9; ++i) {
      h[i] = sh.cur[i] * (sg == 0.0f ? 1.0f : sg);
      p.out_h[(int64_t)b * 9 + i] = h[i];
    }
    float rs[2][9], ts[2][3], q[2][4], tn[2];
    decompose(h, p.k, kinv, rs, ts);
    for (int f = 0; f < 2; ++f) {
      quat_of(rs[f], q[f]);
      tn[f] = (ts[f][0] * ts[f][0] + ts[f][1] * ts[f][1]) + ts[f][2] * ts[f][2];
      for (int i = 0; i < 4; ++i) p.out_q[((int64_t)b * 2 + f) * 4 + i] = q[f][i];
      p.out_tn[(int64_t)b * 2 + f] = tn[f];
    }
    // torch.argmin: the first minimum, a NaN the minimum.
    const int pick = isnan(tn[0]) ? 0 : (isnan(tn[1]) || tn[1] < tn[0] ? 1 : 0);
    for (int i = 0; i < 4; ++i) p.out_rot[(int64_t)b * 4 + i] = q[pick][i];
    p.out_score[b] = ninl;
  }
  cluster_sync();  // the peers have read this CTA's sums
}

}  // namespace

extern "C" int ofps_homography_ransac(const Args* args, void* stream) {
  const Args a = *args;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.P < 1 || a.P > kMaxPrescore || a.F < 1 || a.F > kMaxFinalists || a.F >= a.H ||
      a.P >= a.S || a.S > kMaxEval || a.lo_iters < 0 || a.gn_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t fits = (int64_t)a.B * a.H;
  hg_fit_kernel<<<(int)((fits + kFitThreads - 1) / kFitThreads), kFitThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (int)(a.S * (sizeof(float4) + 1));
  err = cudaFuncSetAttribute(hg_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  hg_score_kernel<<<a.B, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // A cluster of CTAs a stream, as many as keep every CTA of the grid on
  // its own SM (8 at B <= 16, 4 at B <= 33 on 132 SMs, 2, 1).
#if defined(__CUDACC__)
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int cluster = 8;
  while (cluster > 1 && a.B * cluster > sms) cluster /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * cluster);
  cfg.blockDim = dim3(kRefitThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, hg_refit_kernel, a);
  if (err != cudaSuccess) return (int)err;
#else
  hg_refit_kernel<<<a.B, kRefitThreads, 0, s>>>(a);
#endif
  return (int)cudaGetLastError();
}
