// Multiview's essential-matrix RANSAC: the Nister five-point fits of every
// hypothesis (two charts, 28 candidates each), the prescore on a strided
// subsample of the eval subset with its adaptive LMedS cut, the top
// finalists counted on the eval subset, the first-maximum winner and its
// inliers over all points; and the small algebra of each eight-point
// refit (ops/robust.py robust_fit with ops/five_point.py
// five_point_essential, and ops/epipolar.py eight_point_fundamental;
// ofps_torch/kernels/multiview.py ransac_plain is the plain version).
//
// Replaces no TPU kernel: the JAX package leaves multiview to XLA, which
// fuses the hypotheses' batched algebra into a few loops.  PyTorch runs
// each tensor operation of the plain version as its own kernel, so in the
// consumers' CUDA graph the RANSAC and its refits were ~4,100 nodes a
// step, each a few microseconds of work.
//
// What bounds it on the H100: latency.  At B=8, 218 hypotheses and 16,384
// points the work is well under a GFLOP (3,488 five-point solves of ~60k
// float32 operations, 6.2M Sampson tests in the prescore, 0.5M on the
// finalists) and the bytes a few MB.  Design, four launches a RANSAC, each
// one wave, and a few around each of PyTorch's sums over the points:
//
// * mv_fit_kernel, a thread per (stream, hypothesis, chart): the sample's
//   gram, its null space, the chart, the resultant's elimination, the
//   sign scan, bisection and Newton polish, and 14 candidates, in the
//   thread's registers and local memory.  3,488 threads: the step pays
//   one solve's latency.
// * mv_prescore_kernel, a warp per (stream, candidate): its Sampson errors
//   on the prescore points (4 a lane) and their masked median by the 31
//   rounds of ops/robust.py masked_median, the warp counting.
// * mv_count_kernel, a warp per (stream, candidate) in CTAs of 32: each
//   CTA takes the stream's least median over the valid candidates (the
//   adaptive cut; the same bits in every CTA), then counts each candidate's
//   prescore inliers under it.
// * mv_select_kernel, a CTA per stream: the stable descending top
//   finalists (a histogram of the counts, then one warp walks the
//   candidates in index order), their counts on the eval subset, the first
//   maximum, and its inliers over all points.
// * mv_eight_point_kernel, a thread per stream: an eight-point fit from its
//   normal matrix and Hartley transforms (the 9x9 inverse iteration, the
//   rank-2 SVD, the denormalization and the projection onto E).
// * mv_points_kernel, a thread per point: the elementwise steps between
//   the sums over all the points that stay PyTorch's (the normalized
//   coordinates; each refit's distances, Hartley transforms and normal
//   matrix terms; each LO round's Sampson errors and inliers).
//
// The results are the plain version's on the card, bit for bit: on the
// pure-rotation traffic of a codec camera the essential matrix has a
// three-dimensional family of fits, and the rotation moves by up to
// ~2e-3 degrees with the last bits of a sum.  So the kernels repeat
// PyTorch's card arithmetic operation for operation: every multiply and add
// separately rounded (-fmad=false), IEEE division where PyTorch divides by
// a tensor, a multiply by the float32 reciprocal where it divides by a
// host scalar, `1 / x` then a multiply where it divides a number by a
// tensor (__rtruediv__), PyTorch's NaN rules for clamp, maximum, amax,
// argmax and sign, its reduction orders (sum_tree, sum_outer), cuBLAS's
// fused multiply-add chains and the fused first product of linalg.cross,
// as measured on an H100 (torch 2.11, CUDA 12.8) at B=8 and 218
// hypotheses; at other shapes cuBLAS may take other kernels, and the
// results then differ from the plain version's in the last bits.  The sums
// over all the points
// (the LO rounds' errors, the refits' Hartley sums and normal matrices)
// stay with PyTorch, whose block and grid reductions they would otherwise
// have to copy.

#include <cuda_runtime.h>

#include <cstdint>

#include "ransac_algebra.cuh"

namespace ofps_multiview {

// kernels/multiview.py _Args, field for field.
struct Args {
  const float* x1;       // (B, N, 2) normalized coordinates, packed
  const float* x2;       // (B, N, 2)
  const float* w;        // (B, N) point weights, packed
  const int64_t* idx;    // (B, H, 5) minimal samples, batch stride idx_sb
  const int64_t* eidx;   // (B, S) eval subset, batch stride eidx_sb
  const float* we;       // (B, S) its weights, batch stride we_sb
  const float* thr;      // the threshold, per stream at thr_sb
  const float* consts;   // kConsts floats (kernels/multiview.py _tables)
  float* models;         // (B, HM, 9) scratch: the candidates
  int* valid;            // (B, HM) scratch
  float* med;            // (B, HM) scratch: prescore medians
  int* pre;              // (B, HM) scratch: prescore counts (-1 invalid)
  float* thr2;           // (B,) scratch: the adapted squared cut
  int64_t* cand;         // (B, F) the finalists
  float* out_model;      // (B, 9) the winning candidate
  float* out_err;        // (B, N) its Sampson errors times its inliers
  float* out_inl;        // (B, N) its inliers, 0 or 1
  int64_t* out_best;     // (B,) its index
  int64_t idx_sb, eidx_sb, we_sb, thr_sb;
  float sigma_c;         // 2.5 * 1.4826 in float32
  int B, N, H, S, P, F;
};

// mv_points_kernel's arguments (kernels/multiview.py _PointArgs, field
// for field): the elementwise stages around PyTorch's sums over the
// points.  Each writes the tensor the plain version hands to torch.sum,
// bit for bit, so the sums stay PyTorch's own.
struct PointArgs {
  const float* a;    // (B, N, 2) screen positions, or normalized x1
  const float* b;    // (B, N, 2) motions, or normalized x2
  const float* w;    // (B, N) weights
  const float* m;    // (3, 3) K^-1; (B, 2) centroid of x1; (B, 3, 3) a model
  const float* m2;   // (B, 2) centroid of x2; (B,) the squared cut
  const float* s1;   // (B,) mean distance of x1; (B, N) current inliers
  const float* s2;   // (B,) mean distance of x2
  float* o1;         // outputs, by stage
  float* o2;
  float* o3;
  int B, N;
};

}  // namespace ofps_multiview

using ofps_multiview::Args;
using ofps_multiview::PointArgs;

namespace {

constexpr int kSample = 5;
constexpr int kRoots = 14;            // 10 bracketed roots + 4 tangent seeds
constexpr int kMaxRoots = 10;
constexpr int kSeeds = 4;
constexpr int kModels = 2 * kRoots;   // candidates a hypothesis
constexpr int kGrid = 512;
constexpr int kMaxPrescore = 128;     // 4 points a lane
constexpr int kMaxFinalists = 32;     // a warp each
constexpr int kFitThreads = 64;
constexpr int kScoreThreads = 256;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// Offsets into Args::consts (kernels/multiview.py _tables).
constexpr int kPX = 0, kPY = 20, kPZ = 40;   // the 20 probe points
constexpr int kV20 = 60;                     // (20, 20) probe inverse
constexpr int kTrig = kV20 + 400;            // (11, 11) trig inverse
constexpr int kSC4 = kTrig + 121;            // (11, 5) node powers
constexpr int kCos2 = kSC4 + 55;             // (11,)
constexpr int kGridB = kCos2 + 11;           // (512, 11) trig basis
constexpr int kGridTh = kGridB + kGrid * 11; // (512,)
constexpr int kHad = kGridTh + kGrid;        // (4, 4)
constexpr int kStart4 = kHad + 16;           // (9, 4) inverse iteration start
constexpr int kStart1 = kStart4 + 36;        // (9, 1)
constexpr int kConsts = kStart1 + 9;
static_assert(kConsts == 6852, "kernels/multiview.py _tables");

// ops/epipolar.py project_to_essential.
__device__ void project_essential(const float* e, float* out) {
  float u[9], s[3], vt[9], us[9];
  svd3(e, u, s, vt);
  const float sm = (s[0] + s[1]) * 0.5f;
  const float sn[3] = {sm, sm, 0.0f};
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) us[i * 3 + k] = u[i * 3 + k] * sn[k];
  matmul3(us, vt, out);
}

// ops/epipolar.py sampson_error of one correspondence x1 -> x2.
__device__ __forceinline__ float sampson(const float* f, float x, float y, float u, float v) {
  const float fx0 = (f[0] * x + f[1] * y) + f[2];
  const float fx1 = (f[3] * x + f[4] * y) + f[5];
  const float fx2 = (f[6] * x + f[7] * y) + f[8];
  const float ft0 = (f[0] * u + f[3] * v) + f[6];
  const float ft1 = (f[1] * u + f[4] * v) + f[7];
  const float num = (u * fx0 + v * fx1) + fx2;
  const float den = ((fx0 * fx0 + fx1 * fx1) + ft0 * ft0) + ft1 * ft1;
  return num * num / clamp_min(den, 1e-20f);
}

// ops/five_point.py _trig_eval: P(th) and, with `grad`, dP/dth.
__device__ float trig_eval(const float* coefs, float th, float* grad) {
  const float c2 = cosf(2.0f * th), s2 = sinf(2.0f * th);
  float acc = coefs[0], g = 0.0f, ck = c2, sk = s2;
  for (int i = 1; i < 6; ++i) {
    const float ac = coefs[2 * i - 1], as = coefs[2 * i];
    acc = (acc + ac * ck) + as * sk;
    if (grad != nullptr) g = g + (2.0f * (float)i) * (as * ck - ac * sk);
    if (i < 5) {
      const float cn = ck * c2 - sk * s2;
      sk = sk * c2 + ck * s2;
      ck = cn;
    }
  }
  if (grad != nullptr) *grad = g;
  return acc;
}

// ops/five_point.py _reduced_bpoly for one chart: B(z) coefficients
// bp[3][3][5] of the null-space basis (4, 9).
__device__ void reduced_bpoly(const float* cst, const float (*basis)[9], float (*bp)[3][5]) {
  float coef[10][20];
  {
    float cons[20][10];
    for (int p = 0; p < 20; ++p) {
      const float px = cst[kPX + p], py = cst[kPY + p], pz = cst[kPZ + p];
      float e[9], et[9], eet[9], ee[9];
      for (int i = 0; i < 9; ++i)
        e[i] = ((px * basis[0][i] + py * basis[1][i]) + pz * basis[2][i]) + basis[3][i];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) et[i * 3 + j] = e[j * 3 + i];
      matmul3(e, et, eet);
      const float tr = (eet[0] + eet[4]) + eet[8];
      matmul3(eet, e, ee);
      cons[p][0] = det3(e);
      for (int i = 0; i < 9; ++i) cons[p][1 + i] = 2.0f * ee[i] - tr * e[i];
    }
    for (int r = 0; r < 10; ++r)
      for (int q = 0; q < 20; ++q) {
        float acc = cons[0][r] * cst[kV20 + q];
        for (int p = 1; p < 20; ++p) acc = __fmaf_rn(cons[p][r], cst[kV20 + p * 20 + q], acc);
        coef[r][q] = acc;
      }
  }
  // ops/solve.py gauss_solve_pivoted over [A | B] = coef, its one-hot row
  // swap and elimination as written (their NaN and signed-zero results).
  for (int k = 0; k < 10; ++k) {
    int p = k;
    float pv = fabsf(coef[k][k]);
    for (int r = k + 1; r < 10; ++r) {
      const float v = fabsf(coef[r][k]);
      if (!isnan(pv) && (isnan(v) || v > pv)) {
        p = r;
        pv = v;
      }
    }
    for (int j = 0; j < 20; ++j) {
      float prod[10];
      for (int r = 0; r < 10; ++r) prod[r] = (r == p ? 1.0f : 0.0f) * coef[r][j];
      const float delta = sum_outer<10>(prod) - coef[k][j];
      for (int r = 0; r < 10; ++r)
        coef[r][j] = (coef[r][j] + (r == k ? 1.0f : 0.0f) * delta) - (r == p ? 1.0f : 0.0f) * delta;
    }
    const float piv = coef[k][k];
    const float safe = fabsf(piv) > 1e-30f ? piv : 1e-30f;
    float factor[10], rowk[20];
    for (int r = 0; r < 10; ++r) factor[r] = r != k ? coef[r][k] / safe : 0.0f;
    for (int j = 0; j < 20; ++j) rowk[j] = coef[k][j];
    for (int r = 0; r < 10; ++r)
      for (int j = 0; j < 20; ++j) coef[r][j] = coef[r][j] - factor[r] * rowk[j];
  }
  // t = aug[:, 10:] / diag: rows 4..9 are the ones B(z) takes.
  float ta[3][10], tb[3][10];
  for (int q = 0; q < 3; ++q)
    for (int j = 0; j < 10; ++j) {
      ta[q][j] = coef[4 + 2 * q][10 + j] / coef[4 + 2 * q][4 + 2 * q];
      tb[q][j] = coef[5 + 2 * q][10 + j] / coef[5 + 2 * q][5 + 2 * q];
    }
  for (int q = 0; q < 3; ++q) {
    for (int c = 0; c < 2; ++c) {
      const int i0 = 3 * c;
      bp[q][c][0] = ta[q][i0 + 2];
      bp[q][c][1] = ta[q][i0 + 1] - tb[q][i0 + 2];
      bp[q][c][2] = ta[q][i0] - tb[q][i0 + 1];
      bp[q][c][3] = -tb[q][i0];
      bp[q][c][4] = 0.0f;
    }
    bp[q][2][0] = ta[q][9];
    bp[q][2][1] = ta[q][8] - tb[q][9];
    bp[q][2][2] = ta[q][7] - tb[q][8];
    bp[q][2][3] = ta[q][6] - tb[q][7];
    bp[q][2][4] = -tb[q][6];
  }
  float mag = 0.0f;
  for (int q = 0; q < 3; ++q)
    for (int c = 0; c < 3; ++c)
      for (int d = 0; d < 5; ++d) mag = nan_max(mag, fabsf(bp[q][c][d]));
  const float div = clamp_min(mag, 1e-30f);
  for (int q = 0; q < 3; ++q)
    for (int c = 0; c < 3; ++c)
      for (int d = 0; d < 5; ++d) bp[q][c][d] = bp[q][c][d] / div;
}

// ops/five_point.py _solve_chart: 14 candidates (row-major 3x3) and their
// validity from one chart's basis.
__device__ void solve_chart(const float* cst, const float (*basis)[9], float (*es)[9],
                            bool* valid) {
  float bp[3][3][5];
  reduced_bpoly(cst, basis, bp);
  float coefs[11];
  {
    float pn[11];
    float scale = 0.0f;
    for (int n = 0; n < 11; ++n) {
      float bt[9];
      for (int q = 0; q < 3; ++q)
        for (int c = 0; c < 3; ++c) {
          float t[5];
          for (int d = 0; d < 5; ++d) t[d] = bp[q][c][d] * cst[kSC4 + n * 5 + d];
          bt[q * 3 + c] = sum_tree<5>(t);
        }
      pn[n] = det3(bt) / cst[kCos2 + n];
      scale = nan_max(scale, fabsf(pn[n]));
    }
    scale = clamp_min(scale, 1e-30f);
    for (int n = 0; n < 11; ++n) pn[n] = pn[n] / scale;
    for (int k = 0; k < 11; ++k) {
      float t[11];
      for (int n = 0; n < 11; ++n) t[n] = cst[kTrig + k * 11 + n] * pn[n];
      coefs[k] = sum_tree<11>(t);
    }
  }
  // The sign scan over the grid, the earliest bracketed intervals (then,
  // filling the top-10, the earliest unbracketed ones), and the deepest
  // local minima of |P| (descending -|P|, the lower index first among
  // ties; -inf where no minimum), all in one pass.
  int chg[kMaxRoots], nochg[kMaxRoots], nc = 0, nn = 0;
  float mval[kSeeds];
  int midx[kSeeds];
  for (int i = 0; i < kSeeds; ++i) {
    mval[i] = -f_inf();
    midx[i] = -1;
  }
  float pm2 = 0.0f, pm1 = 0.0f;
  for (int g = 0; g < kGrid; ++g) {
    float pv = coefs[0] * cst[kGridB + g * 11];
    for (int k = 1; k < 11; ++k) pv = __fmaf_rn(coefs[k], cst[kGridB + g * 11 + k], pv);
    if (g >= 1) {
      const bool change = sign_of(pm1) * sign_of(pv) < 0.0f;
      if (change) {
        if (nc < kMaxRoots) chg[nc++] = g - 1;
      } else if (nn < kMaxRoots) {
        nochg[nn++] = g - 1;
      }
    }
    if (g >= 2) {
      const float mid = fabsf(pm1);
      const bool locmin = mid <= fabsf(pm2) && mid <= fabsf(pv);
      const float score = locmin ? -mid : -f_inf();
      const int m = g - 2;
      // Insert after the entries it does not beat (ties keep index order).
      int pos = kSeeds;
      for (int i = kSeeds - 1; i >= 0; --i) {
        if (midx[i] < 0 || score > mval[i]) pos = i;
        else break;
      }
      if (pos < kSeeds) {
        for (int i = kSeeds - 1; i > pos; --i) {
          mval[i] = mval[i - 1];
          midx[i] = midx[i - 1];
        }
        mval[pos] = score;
        midx[pos] = m;
      }
    }
    pm2 = pm1;
    pm1 = pv;
  }
  const float* gth = cst + kGridTh;
  float th[kRoots];
  bool brk[kRoots];
  for (int r = 0; r < kMaxRoots; ++r) {
    const bool b = r < nc;
    const int i = b ? chg[r] : nochg[r - nc];
    float lo = gth[i], hi = gth[i + 1];
    float flo = trig_eval(coefs, lo, nullptr);
    for (int it = 0; it < 20; ++it) {
      const float mid = 0.5f * (lo + hi);
      const float fmid = trig_eval(coefs, mid, nullptr);
      const bool same = sign_of(fmid) == sign_of(flo);
      lo = same ? mid : lo;
      flo = same ? fmid : flo;
      hi = same ? hi : mid;
    }
    th[r] = 0.5f * (lo + hi);
    brk[r] = b;
  }
  for (int i = 0; i < kSeeds; ++i) {
    th[kMaxRoots + i] = gth[midx[i] + 1];
    brk[kMaxRoots + i] = true;
  }
  for (int r = 0; r < kRoots; ++r) {
    float t = th[r];
    for (int it = 0; it < 3; ++it) {
      float fp;
      const float f0 = trig_eval(coefs, t, &fp);
      const float step = f0 / (fabsf(fp) > 1e-20f ? fp : 1e-20f);
      t = t - clamp_max(clamp_min(step, -0.02f), 0.02f);
    }
    bool ok = brk[r] && fabsf(trig_eval(coefs, t, nullptr)) < 1e-3f;
    const float z = tanf(t);
    const float s = sinf(t), c = cosf(t);
    const float sc[5] = {1.0f * powf(c, 4.0f), s * (c * c * c), (s * s) * (c * c),
                         (s * s * s) * c, powf(s, 4.0f) * 1.0f};
    float b3[9];
    for (int q = 0; q < 3; ++q)
      for (int cc = 0; cc < 3; ++cc) {
        float t[5];
        for (int d = 0; d < 5; ++d) t[d] = bp[q][cc][d] * sc[d];
        b3[q * 3 + cc] = sum_tree<5>(t);
      }
    float t00[3], t01[3], t10[3], t11[3], tb0[3], tb1[3];
    for (int q = 0; q < 3; ++q) {
      const float a0 = b3[q * 3], a1 = b3[q * 3 + 1], bq = -b3[q * 3 + 2];
      t00[q] = a0 * a0;
      t01[q] = a0 * a1;
      t10[q] = a1 * a0;
      t11[q] = a1 * a1;
      tb0[q] = a0 * bq;
      tb1[q] = a1 * bq;
    }
    float g00 = sum_outer<3>(t00), g01 = sum_outer<3>(t01), g10 = sum_outer<3>(t10);
    float g11 = sum_outer<3>(t11);
    const float gb0 = sum_outer<3>(tb0), gb1 = sum_outer<3>(tb1);
    const float tr2 = g00 + g11;
    const float reg = 1e-10f * tr2;
    g00 = g00 + reg * 1.0f;
    g01 = g01 + reg * 0.0f;
    g10 = g10 + reg * 0.0f;
    g11 = g11 + reg * 1.0f;
    const float d2 = g00 * g11 - g01 * g10;
    const float d2s = fabsf(d2) > 1e-30f ? d2 : 1e-30f;
    const float x = (g11 * gb0 - g01 * gb1) / d2s;
    const float y = (g00 * gb1 - g10 * gb0) / d2s;
    ok = ok && isfinite(x) && isfinite(y) && nan_max(fabsf(x), fabsf(y)) < 1e6f;
    float e[9], pe[9];
    for (int i = 0; i < 9; ++i)
      e[i] = ((x * basis[0][i] + y * basis[1][i]) + z * basis[2][i]) + basis[3][i];
    project_essential(e, pe);
    float sq[9];
    for (int i = 0; i < 9; ++i) sq[i] = pe[i] * pe[i];
    const float n = sqrtf(sum_tree<9>(sq));
    const float div = clamp_min(n, 1e-20f);
    for (int i = 0; i < 9; ++i) es[r][i] = pe[i] / div;
    valid[r] = ok && all_finite(es[r], 9) && n > 1e-20f;
  }
}

__global__ void __launch_bounds__(kFitThreads)
mv_fit_kernel(Args p) {
  const int64_t t = (int64_t)blockIdx.x * kFitThreads + threadIdx.x;
  if (t >= (int64_t)p.B * p.H * 2) return;
  const int chart = (int)(t % 2);
  const int h = (int)((t / 2) % p.H);
  const int b = (int)(t / (2 * (int64_t)p.H));
  const float* cst = p.consts;
  // The sample's epipolar rows, weighted, and their gram.
  float rows[kSample][9];
  for (int j = 0; j < kSample; ++j) {
    const int64_t i = p.idx[b * p.idx_sb + (int64_t)h * kSample + j];
    const float* a = p.x1 + ((int64_t)b * p.N + i) * 2;
    const float* c = p.x2 + ((int64_t)b * p.N + i) * 2;
    const float wj = p.w[(int64_t)b * p.N + i];
    const float u1 = a[0], v1 = a[1], u2 = c[0], v2 = c[1];
    const float r[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.0f};
    for (int k = 0; k < 9; ++k) rows[j][k] = r[k] * wj;
  }
  float gram[81];
  for (int i = 0; i < 9; ++i)
    for (int k = 0; k < 9; ++k) {
      float t[kSample];
      for (int j = 0; j < kSample; ++j) t[j] = rows[j][i] * rows[j][k];
      gram[i * 9 + k] = sum_outer<kSample>(t);
    }
  float nullb[36];
  smallest_eigvecs9<4>(gram, 4, cst + kStart4, false, nullb);
  float basis[4][9];
  for (int a = 0; a < 4; ++a)
    for (int i = 0; i < 9; ++i) basis[a][i] = nullb[i * 4 + a];
  if (chart == 1) {
    float mixed[4][9];
    for (int a = 0; a < 4; ++a)
      for (int i = 0; i < 9; ++i) {
        float t[4];
        for (int c = 0; c < 4; ++c) t[c] = cst[kHad + a * 4 + c] * basis[c][i];
        mixed[a][i] = sum_tree<4>(t);
      }
    for (int a = 0; a < 4; ++a)
      for (int i = 0; i < 9; ++i) basis[a][i] = mixed[a][i];
  }
  float es[kRoots][9];
  bool valid[kRoots];
  solve_chart(cst, basis, es, valid);
  const int64_t HM = (int64_t)p.H * kModels;
  const int64_t m0 = (int64_t)b * HM + (int64_t)h * kModels + chart * kRoots;
  for (int r = 0; r < kRoots; ++r) {
    for (int i = 0; i < 9; ++i) p.models[(m0 + r) * 9 + i] = es[r][i];
    // robust_fit's gate: a non-finite candidate is not valid.
    p.valid[m0 + r] = valid[r] && all_finite(es[r], 9) ? 1 : 0;
  }
}

// The Sampson errors of model `f` on the prescore points held by this
// lane (point j = lane + 32 q, eval slot j * stride) and their validity.
__device__ __forceinline__ void prescore_errors(const Args& p, int b, const float* f, int lane,
                                                float* err, bool* ok) {
  const int stride = p.S / p.P;
  for (int q = 0; q < kMaxPrescore / 32; ++q) {
    const int j = lane + 32 * q;
    err[q] = 0.0f;
    ok[q] = false;
    if (j < p.P) {
      const int64_t slot = (int64_t)j * stride;
      const int64_t i = p.eidx[b * p.eidx_sb + slot];
      const float* a = p.x1 + ((int64_t)b * p.N + i) * 2;
      const float* c = p.x2 + ((int64_t)b * p.N + i) * 2;
      err[q] = sampson(f, a[0], a[1], c[0], c[1]);
      ok[q] = p.we[b * p.we_sb + slot] > 0.5f;
    }
  }
}

__global__ void __launch_bounds__(kScoreThreads)
mv_prescore_kernel(Args p) {
  const int b = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int HM = p.H * kModels;
  const int c = blockIdx.x * (kScoreThreads / 32) + warp;
  if (c >= HM) return;  // uniform over the warp
  float f[9];
  for (int i = 0; i < 9; ++i) f[i] = p.models[((int64_t)b * HM + c) * 9 + i];
  float err[kMaxPrescore / 32];
  bool ok[kMaxPrescore / 32];
  prescore_errors(p, b, f, lane, err, ok);
  // ops/robust.py masked_median: the bit patterns of max(err, 0) (NaNs
  // keep theirs), invalid entries above every candidate, 31 rounds.
  uint64_t u[kMaxPrescore / 32];
  int nv = 0;
  for (int q = 0; q < kMaxPrescore / 32; ++q) {
    const uint32_t bits = __float_as_uint(err[q]);
    const bool negative = bits >= 0x80000000u && (bits & 0x7fffffffu) <= 0x7f800000u;
    u[q] = ok[q] ? (negative ? 0ull : (uint64_t)bits) : (1ull << 32);
    nv += ok[q] ? 1 : 0;
  }
  const int nvalid = warp_sum(nv);
  const int kp1 = (nvalid - 1 > 0 ? nvalid - 1 : 0) / 2 + 1;
  uint64_t pm = 0;
  for (int i = 0; i < 31; ++i) {
    const uint64_t t = pm | (1ull << (30 - i));
    int cnt = 0;
    for (int q = 0; q < kMaxPrescore / 32; ++q) cnt += u[q] < t ? 1 : 0;
    if (warp_sum(cnt) < kp1) pm = t;
  }
  if (lane == 0)
    p.med[(int64_t)b * HM + c] = nvalid > 0 ? __uint_as_float((uint32_t)pm) : 1e30f;
}

// The stream's adapted squared cut (robust_fit's raise_to_lmeds_cut on
// the prescore medians), the same bits in every thread.
__device__ float adapted_cut(const Args& p, int b, float (*buf)[kWarps][2], int parity) {
  const int HM = p.H * kModels;
  const int tid = threadIdx.x;
  float mn = f_inf(), swe = 0.0f;
  for (int c = tid; c < HM; c += kThreads) {
    const int64_t k = (int64_t)b * HM + c;
    mn = nan_min(mn, p.valid[k] ? p.med[k] : 1e30f);
  }
  for (int s = tid; s < p.S; s += kThreads) swe += p.we[b * p.we_sb + s];
  const int lane = tid % 32, warp = tid / 32;
  for (int off = 16; off >= 1; off /= 2) {
    mn = nan_min(mn, __shfl_xor_sync(kFull, mn, off));
    swe += __shfl_xor_sync(kFull, swe, off);
  }
  if (lane == 0) {
    buf[parity][warp][0] = mn;
    buf[parity][warp][1] = swe;
  }
  __syncthreads();
  float med_best = buf[parity][0][0], nvalid = buf[parity][0][1];
  for (int i = 1; i < kWarps; ++i) {
    med_best = nan_min(med_best, buf[parity][i][0]);
    nvalid += buf[parity][i][1];
  }
  // nvalid = clamp(sum(we), min=k + 1); sigma_k = 2.5 * 1.4826 * (1 + 5
  // / (nvalid - k)), the division a reciprocal times 5 (__rtruediv__).
  nvalid = clamp_min(nvalid, (float)kSample + 1.0f);
  const float sigma = p.sigma_c * (1.0f + (1.0f / (nvalid - (float)kSample)) * 5.0f);
  const float t = p.thr[b * p.thr_sb];
  return nan_max(t * t, (sigma * sigma) * clamp_min(med_best, 0.0f));
}

__global__ void __launch_bounds__(kThreads)
mv_count_kernel(Args p) {
  __shared__ float s_buf[2][kWarps][2];
  const int b = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float thr2 = adapted_cut(p, b, s_buf, 0);
  if (blockIdx.x == 0 && threadIdx.x == 0) p.thr2[b] = thr2;
  const int HM = p.H * kModels;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= HM) return;
  float f[9];
  for (int i = 0; i < 9; ++i) f[i] = p.models[((int64_t)b * HM + c) * 9 + i];
  float err[kMaxPrescore / 32];
  bool ok[kMaxPrescore / 32];
  prescore_errors(p, b, f, lane, err, ok);
  int cnt = 0;
  for (int q = 0; q < kMaxPrescore / 32; ++q) cnt += (ok[q] && err[q] <= thr2) ? 1 : 0;
  cnt = warp_sum(cnt);
  if (lane == 0) p.pre[(int64_t)b * HM + c] = p.valid[(int64_t)b * HM + c] ? cnt : -1;
}

struct SelectShared {
  int hist[kMaxPrescore + 2];
  int above[kMaxFinalists], ties[kMaxFinalists];
  int fin[kMaxFinalists], score[kMaxFinalists];
  int na, cstar, best;
  float model[9];
};

__device__ __forceinline__ void load_pt(const Args& p, int b, int64_t i, float& x, float& y,
                                        float& u, float& v) {
  const float* a = p.x1 + ((int64_t)b * p.N + i) * 2;
  const float* c = p.x2 + ((int64_t)b * p.N + i) * 2;
  x = a[0];
  y = a[1];
  u = c[0];
  v = c[1];
}

__global__ void __launch_bounds__(kThreads)
mv_select_kernel(Args p) {
  __shared__ SelectShared sh;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int HM = p.H * kModels;
  const int64_t hm0 = (int64_t)b * HM;
  const float thr2 = p.thr2[b];

  // The finalists: jax.lax.top_k's order of the prescore counts
  // (descending, the lower index first among ties).  The counts lie in
  // [-1, P]: the histogram gives the count c* of the last finalist and how
  // many counts exceed it.
  for (int i = tid; i < kMaxPrescore + 2; i += kThreads) sh.hist[i] = 0;
  __syncthreads();
  for (int c = tid; c < HM; c += kThreads) atomicAdd(&sh.hist[p.pre[hm0 + c] + 1], 1);
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
    for (int base = 0; base < HM; base += 32) {
      const int c = base + lane;
      const int v = c < HM ? p.pre[hm0 + c] : -2;
      const unsigned lt = (1u << lane) - 1u;
      const unsigned ab = __ballot_sync(kFull, v > cs);
      const unsigned ti = __ballot_sync(kFull, v == cs);
      if (v > cs) sh.above[na + __popc(ab & lt)] = c;
      if (v == cs && nt + __popc(ti & lt) < need) sh.ties[nt + __popc(ti & lt)] = c;
      na += __popc(ab);
      nt += __popc(ti);
    }
    __syncwarp();
    if (lane == 0) {
      // A stable insertion sort of the counts above c*, descending.
      for (int i = 1; i < na; ++i) {
        const int key = sh.above[i], kv = p.pre[hm0 + key];
        int j = i - 1;
        while (j >= 0 && p.pre[hm0 + sh.above[j]] < kv) {
          sh.above[j + 1] = sh.above[j];
          --j;
        }
        sh.above[j + 1] = key;
      }
      for (int i = 0; i < p.F; ++i) sh.fin[i] = i < na ? sh.above[i] : sh.ties[i - na];
    }
  }
  __syncthreads();
  // Each finalist's inliers on the eval subset, a warp each.
  if (warp < p.F) {
    const int64_t c = hm0 + sh.fin[warp];
    float f[9];
    for (int i = 0; i < 9; ++i) f[i] = p.models[c * 9 + i];
    int cnt = 0;
    for (int s = lane; s < p.S; s += 32) {
      float x, y, u, v;
      load_pt(p, b, p.eidx[b * p.eidx_sb + s], x, y, u, v);
      cnt += (sampson(f, x, y, u, v) <= thr2 && p.we[b * p.we_sb + s] > 0.5f) ? 1 : 0;
    }
    cnt = warp_sum(cnt);
    if (lane == 0) sh.score[warp] = p.valid[c] ? cnt : -1;
  }
  __syncthreads();
  if (tid == 0) {
    int best = 0;
    for (int i = 1; i < p.F; ++i)
      if (sh.score[i] > sh.score[best]) best = i;  // first maximum
    sh.best = sh.fin[best];
    for (int i = 0; i < 9; ++i) {
      sh.model[i] = p.models[(hm0 + sh.best) * 9 + i];
      p.out_model[(int64_t)b * 9 + i] = sh.model[i];
    }
    for (int i = 0; i < p.F; ++i) p.cand[(int64_t)b * p.F + i] = sh.fin[i];
    p.out_best[b] = sh.best;
  }
  __syncthreads();
  // The winner's errors and inliers over all points.
  float model[9];
  for (int i = 0; i < 9; ++i) model[i] = sh.model[i];
  for (int n = tid; n < p.N; n += kThreads) {
    float x, y, u, v;
    load_pt(p, b, n, x, y, u, v);
    const float e = sampson(model, x, y, u, v);
    const float in = (e <= thr2 && p.w[(int64_t)b * p.N + n] > 0.5f) ? 1.0f : 0.0f;
    p.out_err[(int64_t)b * p.N + n] = e * in;
    p.out_inl[(int64_t)b * p.N + n] = in;
  }
}

// ops/epipolar.py eight_point_fundamental after its sums over the points
// (the Hartley transforms t1, t2 and the normal matrix ata, taken by
// PyTorch), then project_to_essential: a thread per stream.
__global__ void __launch_bounds__(kFitThreads)
mv_eight_point_kernel(const float* ata, const float* t1, const float* t2, const float* start,
                      float* out, int B) {
  const int b = blockIdx.x * kFitThreads + threadIdx.x;
  if (b >= B) return;
  float f[9], u[9], s[3], vt[9], us[9], fr[9], t2t[9], tmp[9], fd[9], sq[9];
  smallest_eigvecs9<1>(ata + (int64_t)b * 81, 3, start, true, f);
  svd3(f, u, s, vt);
  const float sr[3] = {s[0], s[1], 0.0f};
  for (int i = 0; i < 3; ++i)
    for (int c = 0; c < 3; ++c) us[i * 3 + c] = u[i * 3 + c] * sr[c];
  matmul3(us, vt, fr);
  // Denormalize: T2^T F T1.
  const float* a1 = t1 + (int64_t)b * 9;
  const float* a2 = t2 + (int64_t)b * 9;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) t2t[i * 3 + j] = a2[j * 3 + i];
  matmul3(t2t, fr, tmp);
  matmul3(tmp, a1, fd);
  for (int i = 0; i < 9; ++i) sq[i] = fd[i] * fd[i];
  const float div = clamp_min(sqrtf(sum_tree<9>(sq)), 1e-20f);
  for (int i = 0; i < 9; ++i) fd[i] = fd[i] / div;
  project_essential(fd, out + (int64_t)b * 9);
}

enum Stage { kNormalize = 0, kDistances = 1, kNormalRows = 2, kLoScore = 3 };

__global__ void __launch_bounds__(kScoreThreads)
mv_points_kernel(PointArgs p, int stage) {
  const int64_t t = (int64_t)blockIdx.x * kScoreThreads + threadIdx.x;
  if (t >= (int64_t)p.B * p.N) return;
  const int b = (int)(t / p.N);
  if (stage == kNormalize) {
    // estimators/multiview.py normalized_coords of pos and pos + motion:
    // h = transform_points(homogeneous(q), K^-1), then h[:2] / h[2].
    const float* k = p.m;
    const float px = p.a[t * 2], py = p.a[t * 2 + 1];
    const float q[2][2] = {{px, py}, {px + p.b[t * 2], py + p.b[t * 2 + 1]}};
    float* out[2] = {p.o1, p.o2};
    for (int v = 0; v < 2; ++v) {
      float h[3];
      for (int i = 0; i < 3; ++i)
        h[i] = (q[v][0] * k[i * 3] + q[v][1] * k[i * 3 + 1]) + 1.0f * k[i * 3 + 2];
      out[v][t * 2] = h[0] / h[2];
      out[v][t * 2 + 1] = h[1] / h[2];
    }
    return;
  }
  const float x = p.a[t * 2], y = p.a[t * 2 + 1], u = p.b[t * 2], v = p.b[t * 2 + 1];
  const float wt = p.w[t];
  if (stage == kDistances) {
    // ops/epipolar.py hartley_normalization: d * w of each view.
    const float dx = x - p.m[b * 2], dy = y - p.m[b * 2 + 1];
    const float du = u - p.m2[b * 2], dv = v - p.m2[b * 2 + 1];
    p.o1[t] = sqrtf(dx * dx + dy * dy) * wt;
    p.o2[t] = sqrtf(du * du + dv * dv) * wt;
  } else if (stage == kNormalRows) {
    // The Hartley transforms, the weighted epipolar rows of the
    // normalized points and their outer products (the terms of gram).
    const float sqrt2 = 1.41421356237309515f;
    const float s1 = (1.0f / clamp_min(p.s1[b], 1e-12f)) * sqrt2;
    const float s2 = (1.0f / clamp_min(p.s2[b], 1e-12f)) * sqrt2;
    const float t1x = -s1 * p.m[b * 2], t1y = -s1 * p.m[b * 2 + 1];
    const float t2x = -s2 * p.m2[b * 2], t2y = -s2 * p.m2[b * 2 + 1];
    if (t % p.N == 0) {
      const float t1[9] = {s1, 0.0f, t1x, 0.0f, s1, t1y, 0.0f, 0.0f, 1.0f};
      const float t2[9] = {s2, 0.0f, t2x, 0.0f, s2, t2y, 0.0f, 0.0f, 1.0f};
      for (int i = 0; i < 9; ++i) {
        p.o1[b * 9 + i] = t1[i];
        p.o2[b * 9 + i] = t2[i];
      }
    }
    const float u1 = (x * s1 + y * 0.0f) + 1.0f * t1x;
    const float v1 = (x * 0.0f + y * s1) + 1.0f * t1y;
    const float u2 = (u * s2 + v * 0.0f) + 1.0f * t2x;
    const float v2 = (u * 0.0f + v * s2) + 1.0f * t2y;
    const float r0[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.0f};
    float r[9];
    for (int i = 0; i < 9; ++i) r[i] = r0[i] * wt;
    float* g = p.o3 + t * 81;
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < 9; ++j) g[i * 9 + j] = r[i] * r[j];
  } else {
    // A LO round of robust_fit: the refit's Sampson errors, its inliers,
    // and the errors weighted by the current and by its inliers.
    const float e = sampson(p.m + b * 9, x, y, u, v);
    const float in2 = (e <= p.m2[b] && wt > 0.5f) ? 1.0f : 0.0f;
    p.o1[t] = e * p.s1[t];
    p.o2[t] = in2;
    p.o3[t] = e * in2;
  }
}

}  // namespace

extern "C" int ofps_multiview_ransac(const Args* args, void* stream) {
  const Args a = *args;
  const cudaStream_t s = (cudaStream_t)stream;
  const int hm = a.H * kModels;
  if (a.P < 1 || a.P > kMaxPrescore || a.F < 1 || a.F > kMaxFinalists || a.F >= hm ||
      a.P >= a.S)
    return (int)cudaErrorInvalidValue;
  const int64_t fits = (int64_t)a.B * a.H * 2;
  mv_fit_kernel<<<(int)((fits + kFitThreads - 1) / kFitThreads), kFitThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per = kScoreThreads / 32;
  mv_prescore_kernel<<<dim3((hm + per - 1) / per, a.B), kScoreThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mv_count_kernel<<<dim3((hm + kWarps - 1) / kWarps, a.B), kThreads, 0, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mv_select_kernel<<<a.B, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int ofps_multiview_points(const PointArgs* args, int stage, void* stream) {
  const PointArgs a = *args;
  const int64_t total = (int64_t)a.B * a.N;
  mv_points_kernel<<<(int)((total + kScoreThreads - 1) / kScoreThreads), kScoreThreads, 0,
                     (cudaStream_t)stream>>>(a, stage);
  return (int)cudaGetLastError();
}

extern "C" int ofps_multiview_eight_point(const float* ata, const float* t1, const float* t2,
                                          const float* start, float* out, int B, void* stream) {
  mv_eight_point_kernel<<<(B + kFitThreads - 1) / kFitThreads, kFitThreads, 0,
                          (cudaStream_t)stream>>>(ata, t1, t2, start, out, B);
  return (int)cudaGetLastError();
}
