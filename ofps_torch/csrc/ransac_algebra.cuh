// Small float32 algebra shared by the RANSAC kernels (multiview_ransac.cu,
// homography_ransac.cu): PyTorch's NaN rules, its reduction orders on the
// card, cuBLAS's 3x3 products, linalg.cross, and ops/solve.py's det3,
// eigh3x3, svd3x3 and inverse iteration, each operation as the plain
// version takes it on an H100 (torch 2.11, CUDA 12.8).  Built with
// -fmad=false: every multiply and add not written as __fmaf_rn is
// separately rounded.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float f_inf() { return __uint_as_float(0x7f800000u); }

// torch.clamp(min=) / clamp(max=): a NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x > hi ? hi : x; }
// torch.maximum / torch.amax / torch.min: NaN wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b > a ? b : a));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : (b < a ? b : a));
}
// torch.sign: (0 < a) - (a < 0), so 0 for a NaN.
__device__ __forceinline__ float sign_of(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}

// PyTorch's reductions on the card (ATen/native/cuda/Reduce.cuh) for the
// small sizes here.  Four accumulators a thread, starting at 0, take the
// thread's values in turn, then add up in order.  A reduction over the
// contiguous axis (sum_tree) spreads the n values over lastpow2(n) lanes,
// value i to lane i % lanes, and adds the lanes by a shuffle-down tree
// with decreasing offsets; one over an outer axis (sum_outer) is one
// thread's.  Checked bit for bit against torch.sum on an H100.
__device__ __forceinline__ float acc4(const float* x, int first, int count, int step) {
  float vl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int i = 0;
  for (; i + 3 < count; i += 4)
    for (int j = 0; j < 4; ++j) vl[j] = vl[j] + x[first + (i + j) * step];
  for (int j = 0; i + j < count; ++j) vl[j] = vl[j] + x[first + (i + j) * step];
  return ((vl[0] + vl[1]) + vl[2]) + vl[3];
}

template <int N>
__device__ __forceinline__ float sum_outer(const float* x) {
  return acc4(x, 0, N, 1);
}

template <int N>
__device__ __forceinline__ float sum_tree(const float* x) {
  constexpr int kLanes = N >= 32 ? 32 : (N >= 16 ? 16 : (N >= 8 ? 8 : (N >= 4 ? 4 : (N >= 2 ? 2 : 1))));
  float lane[kLanes];
  for (int l = 0; l < kLanes; ++l) lane[l] = acc4(x, l, (N - l + kLanes - 1) / kLanes, kLanes);
  for (int off = kLanes / 2; off > 0; off /= 2)
    for (int l = 0; l < off; ++l) lane[l] = lane[l] + lane[l + off];
  return lane[0];
}

// cuBLAS's float32 products at these shapes: each output a fused
// multiply-add chain over k in order (the batch-8 9x9 by 9x1 splits k in
// two halves, sum_split2).  Checked bit for bit on an H100.
__device__ __forceinline__ void matmul3(const float* a, const float* b, float* o) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[i * 3 + j] = __fmaf_rn(a[i * 3 + 2], b[6 + j],
                               __fmaf_rn(a[i * 3 + 1], b[3 + j], a[i * 3] * b[j]));
}

// torch.linalg.cross: its kernel, built with contraction, fuses the first
// product.
__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
  o[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
  o[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
}

// torch.sum(a * b, dim=-1) over 3.
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  const float p[3] = {a[0] * b[0], a[1] * b[1], a[2] * b[2]};
  return sum_tree<3>(p);
}

__device__ __forceinline__ float norm3(const float* v) { return sqrtf(dot3(v, v)); }

// ops/solve.py det3, row-major.
__device__ __forceinline__ float det3(const float* a) {
  return a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6]) +
         a[2] * (a[3] * a[7] - a[4] * a[6]);
}

// ops/solve.py eigh3x3: ascending eigenvalues, eigenvectors as columns of
// vecs (row-major 3x3).
__device__ void eigh3(const float* a, float* vals, float* vecs) {
  const float diag[3] = {a[0], a[4], a[8]};
  const float q = sum_tree<3>(diag) * (1.0f / 3.0f);
  float b[9], bb[9];
  for (int i = 0; i < 9; ++i) b[i] = a[i] - (i % 4 == 0 ? q : q * 0.0f);
  for (int i = 0; i < 9; ++i) bb[i] = b[i] * b[i];
  const float p2 = sum_tree<9>(bb) * (1.0f / 6.0f);
  const float p = sqrtf(clamp_min(p2, 1e-30f));
  const float detb = det3(b);
  const float r = detb / clamp_min(2.0f * (p * p * p), 1e-30f);
  const float phi = acosf(clamp_max(clamp_min(r, -1.0f), 1.0f)) * (1.0f / 3.0f);
  const float e0 = q + (2.0f * p) * cosf(phi + 2.0943951023931953f);
  const float e2 = q + (2.0f * p) * cosf(phi);
  const float e1 = (3.0f * q - e0) - e2;
  vals[0] = e0;
  vals[1] = e1;
  vals[2] = e2;
  // (A - o1 I)(A - o2 I): its largest column (first maximum).
  auto eigvec = [&](float o1, float o2, float* v) {
    float m1[9], m2[9], m[9];
    for (int i = 0; i < 9; ++i) {
      m1[i] = a[i] - (i % 4 == 0 ? o1 : o1 * 0.0f);
      m2[i] = a[i] - (i % 4 == 0 ? o2 : o2 * 0.0f);
    }
    matmul3(m1, m2, m);
    float norms[3];
    for (int j = 0; j < 3; ++j) {
      const float c[3] = {m[j] * m[j], m[3 + j] * m[3 + j], m[6 + j] * m[6 + j]};
      norms[j] = sum_outer<3>(c);
    }
    int best = 0;
    for (int j = 1; j < 3 && !isnan(norms[best]); ++j)  // torch.argmax: a NaN is the maximum
      if (isnan(norms[j]) || norms[j] > norms[best]) best = j;
    for (int i = 0; i < 3; ++i) v[i] = m[i * 3 + best];
    const float n = norm3(v);
    const float inv = clamp_min(n, 1e-30f);
    const bool ok = n > 1e-20f;
    for (int i = 0; i < 3; ++i) v[i] = ok ? v[i] / inv : (i == 0 ? 1.0f : 0.0f);
  };
  float v0[3], v1[3], v2[3];
  eigvec(e1, e2, v0);
  eigvec(e0, e1, v2);
  const float d = dot3(v2, v0);
  for (int i = 0; i < 3; ++i) v2[i] = v2[i] - d * v0[i];
  const float n2 = norm3(v2);
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
  float alt[3], alt2[3];
  cross3(v0, ex, alt);
  cross3(v0, ey, alt2);
  const float alt_n = norm3(alt);
  const float alt2_n = clamp_min(norm3(alt2), 1e-30f);
  for (int i = 0; i < 3; ++i)
    alt[i] = alt_n > 0.1f ? alt[i] / clamp_min(alt_n, 1e-30f) : alt2[i] / alt2_n;
  for (int i = 0; i < 3; ++i) v2[i] = n2 > 1e-10f ? v2[i] / clamp_min(n2, 1e-30f) : alt[i];
  cross3(v2, v0, v1);
  for (int i = 0; i < 3; ++i) {
    vecs[i * 3] = v0[i];
    vecs[i * 3 + 1] = v1[i];
    vecs[i * 3 + 2] = v2[i];
  }
}

// ops/solve.py svd3x3: u, s (descending), vt, row-major.
__device__ void svd3(const float* m, float* u, float* s, float* vt) {
  float mt[9], ata[9], vals[3], vecs[9], v[9], mv[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) mt[i * 3 + j] = m[j * 3 + i];
  matmul3(mt, m, ata);
  eigh3(ata, vals, vecs);
  for (int k = 0; k < 3; ++k) s[k] = sqrtf(clamp_min(vals[2 - k], 0.0f));
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) v[i * 3 + k] = vecs[i * 3 + 2 - k];
  matmul3(m, v, mv);
  float u0[3], u1[3], u2[3], mv2[3];
  const float s0 = clamp_min(s[0], 1e-30f), s1 = clamp_min(s[1], 1e-30f);
  for (int i = 0; i < 3; ++i) {
    u0[i] = mv[i * 3] / s0;
    u1[i] = mv[i * 3 + 1] / s1;
    mv2[i] = mv[i * 3 + 2];
  }
  const float n0 = clamp_min(norm3(u0), 1e-30f);
  for (int i = 0; i < 3; ++i) u0[i] = u0[i] / n0;
  const float d = dot3(u1, u0);
  for (int i = 0; i < 3; ++i) u1[i] = u1[i] - d * u0[i];
  const float n1 = clamp_min(norm3(u1), 1e-30f);
  for (int i = 0; i < 3; ++i) u1[i] = u1[i] / n1;
  cross3(u0, u1, u2);
  const float sgn = dot3(mv2, u2) < 0.0f ? -1.0f : 1.0f;
  const bool use_m = s[2] > 1e-12f * clamp_min(s[0], 1e-30f);
  for (int i = 0; i < 3; ++i) {
    u[i * 3] = u0[i];
    u[i * 3 + 1] = u1[i];
    u[i * 3 + 2] = use_m ? u2[i] * sgn : u2[i];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) vt[i * 3 + j] = v[j * 3 + i];
}

// ops/solve.py smallest_eigvecs_inverse_iteration for n = 9: K columns of
// out (9, K) from the start block `start` (9, K).  `split2`: the product
// with the inverse as cuBLAS takes it for the eight-point's (B, 9, 9) by
// (B, 9, 1), k in two halves; else one chain (the five-point's 9x4).
template <int K>
__device__ void smallest_eigvecs9(const float* a, int iters, const float* start, bool split2,
                                  float* out) {
  float aug[9][18];
  float diag[9];
  for (int i = 0; i < 9; ++i) diag[i] = a[i * 9 + i];
  const float tr = sum_tree<9>(diag);
  const float shift = ((1e-7f * tr) * (1.0f / 9.0f)) + 1e-30f;
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < 9; ++j) {
      aug[i][j] = a[i * 9 + j] + (i == j ? shift : shift * 0.0f);
      aug[i][9 + j] = i == j ? 1.0f : 0.0f;
    }
  // ops/solve.py gauss_solve: unpivoted Gauss-Jordan.
  for (int k = 0; k < 9; ++k) {
    float piv[18];
    const float d = aug[k][k];
    for (int j = 0; j < 18; ++j) piv[j] = aug[k][j] / d;
    for (int i = 0; i < 9; ++i) {
      if (i == k) continue;
      const float f = aug[i][k];
      for (int j = 0; j < 18; ++j) aug[i][j] = aug[i][j] - f * piv[j];
    }
    for (int j = 0; j < 18; ++j) aug[k][j] = piv[j];
  }
  float v[9][K];
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < K; ++j) v[i][j] = start[i * K + j];
  for (int it = 0; it < iters; ++it) {
    float nv[9][K];
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < K; ++j) {
        if (split2) {
          float lo = aug[i][9] * v[0][j], hi = aug[i][14] * v[5][j];
          for (int l = 1; l < 5; ++l) lo = __fmaf_rn(aug[i][9 + l], v[l][j], lo);
          for (int l = 6; l < 9; ++l) hi = __fmaf_rn(aug[i][9 + l], v[l][j], hi);
          nv[i][j] = lo + hi;
        } else {
          float acc = aug[i][9] * v[0][j];
          for (int l = 1; l < 9; ++l) acc = __fmaf_rn(aug[i][9 + l], v[l][j], acc);
          nv[i][j] = acc;
        }
      }
    for (int j = 0; j < K; ++j) {
      float c[9], pr[9];
      for (int i = 0; i < 9; ++i) c[i] = nv[i][j];
      for (int pj = 0; pj < j; ++pj) {
        for (int i = 0; i < 9; ++i) pr[i] = c[i] * nv[i][pj];
        const float d = sum_tree<9>(pr);
        for (int i = 0; i < 9; ++i) c[i] = c[i] - d * nv[i][pj];
      }
      for (int i = 0; i < 9; ++i) pr[i] = c[i] * c[i];
      const float n = clamp_min(sqrtf(sum_tree<9>(pr)), 1e-30f);
      for (int i = 0; i < 9; ++i) nv[i][j] = c[i] / n;
    }
    for (int i = 0; i < 9; ++i)
      for (int j = 0; j < K; ++j) v[i][j] = nv[i][j];
  }
  for (int i = 0; i < 9; ++i)
    for (int j = 0; j < K; ++j) out[i * K + j] = v[i][j];
}

__device__ __forceinline__ bool all_finite(const float* m, int n) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && isfinite(m[i]);
  return ok;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off >= 1; off /= 2) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

}  // namespace
