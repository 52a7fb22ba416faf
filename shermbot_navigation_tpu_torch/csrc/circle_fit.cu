// The circle fit of a batch of clusters, for sm_90a: the masked moments of
// each cluster's points and the whole per-cluster fit behind them.
//
// Replaces the TPU kernel
// shermbot_navigation_tpu/ops/pallas/circle_moments.py (circle_moments_raw)
// and the eigen-chain that XLA fused behind it on the TPU
// (shermbot_navigation_tpu/ops/circle_fit.py, _fit_tail_c). Three entries:
//
//   circle_fit       points + counts + valid -> moments, centre, radius, ok
//                    (the buffered perception path): one read of the
//                    points, one launch.
//   circle_fit_tail  moments (16 row-major, or the 10 distinct ones at a
//                    row stride) + centroid + zbar + count + valid ->
//                    centre, radius, ok (the segmented perception path,
//                    whose moments come from one-hot segment sums).
//   circle_moments   the moments alone: the same kernel with the tail
//                    stage switched off by a template flag.
//
// Moments. Per cluster c of P padded points with `count` valid ones:
//
//   w_i = [i < count],  n = max(count, 1)
//   cx = sum x_i w_i / n,  cy = sum y_i w_i / n
//   xc_i = (x_i - cx) w_i,  yc_i = (y_i - cy) w_i,  z_i = xc_i^2 + yc_i^2
//   M = Z^T Z with Z rows [z_i, xc_i, yc_i, w_i]   (16 entries, row-major)
//   zbar = sum z_i / n
//
// `count` may exceed P (the clustering drops overflow rows but keeps the
// full count): the mask then covers all P rows while the divisions use the
// full count. Rows at and past `count` may hold anything.
//
// Tail. The plain version's _fit_tail_c, op for op, for every slot: the
// symmetrized cyclic Jacobi (8 sweeps over the pairs (0,1) (0,2) (0,3)
// (1,2) (1,3) (2,3), theta = atan2(2 A_pq, A_qq - A_pp) / 2, rows, then
// columns, then V; the 5-comparator sort), the clamp and square root,
// Y = V S V^T, Y Hinv in closed form, Q = (Y Hinv) Y, the second Jacobi,
// the strict-< running argmin over the positive eigenvalues, the bumped
// adjugate solve (products first, then the divide), the rank switch
// sigma4 < 1e-12 and the circle with its 1e-30 floor. The plain version
// runs every multiply, add and subtract as its own elementwise kernel,
// rounded once; here each is __fmul_rn / __fadd_rn / __fsub_rn, which the
// compiler never contracts into an FMA, and divisions and square roots are
// the IEEE ones (__fdiv_rn, __fsqrt_rn); atan2f, cosf and sinf are the
// CUDA math library's, as the plain version's kernels call them. So the
// kernel gives the plain version's bits, which matters: on a noise-free
// arc the rank switch sits on f32 rounding, and an ulp decides the branch.
// The moment stage is written out step by step as well (its multiply-adds
// as __fmaf_rn), so the whole-fit entry's moments are the moment-only
// entry's, bit for bit.
//
// What bounds it on an H100. The bytes are few (the points once, 8.4 MB at
// C=16384, P=64, of which the rows below the counts are ~0.5 MB; 19 floats
// out and 4 back a cluster) and so are the operations (~15k flops and 288
// transcendental calls a cluster: ~4 us at 67 TFLOP/s). The floor is the
// tail's dependent chain: 96 rotations, each an atan2f, a cosf and a
// sinf and the update that feeds the next angle, run by one thread a
// cluster. Design: one thread a cluster for the tail (C = 16384 is ~4
// warps an SM, one a sub-partition). In circle_fit a block of 4 warps
// takes 32 clusters: each warp reduces 8 clusters' moments (one warp a
// cluster, a float2 load a point, shuffle trees), stages them in shared
// memory, and one warp then runs the 32 tails, a cluster a lane; which
// warp does it rotates with the block, so that the tail warps of the
// blocks an SM holds spread over its four sub-partitions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;          // circle_moments: clusters (warps) a block
constexpr int kHold = 4;           // points a lane keeps in registers
constexpr int kFitWarps = 4;       // circle_fit: warps a block
constexpr int kFitClusters = 32;   // circle_fit: clusters a block
constexpr int kTailThreads = 128;  // circle_fit_tail: clusters a block
constexpr int kMom = 19;           // staged floats a cluster: 16 + cx cy zbar

// ------------------------------------------------------------------ moments

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One lane's partial sums of the ten distinct entries of M. Every step is
// written out (the fused multiply-adds too), so that both entries that
// reduce moments give the same bits whatever the compiler would contract.
struct Sums {
  float zz = 0.0f, zx = 0.0f, zy = 0.0f, z = 0.0f, xx = 0.0f;
  float xy = 0.0f, x = 0.0f, yy = 0.0f, y = 0.0f, n = 0.0f;
  __device__ __forceinline__ void add(float2 p, float cx, float cy) {
    const float xc = __fsub_rn(p.x, cx), yc = __fsub_rn(p.y, cy);
    const float r = __fmaf_rn(xc, xc, __fmul_rn(yc, yc));
    zz = __fmaf_rn(r, r, zz);
    zx = __fmaf_rn(r, xc, zx);
    zy = __fmaf_rn(r, yc, zy);
    z = __fadd_rn(z, r);
    xx = __fmaf_rn(xc, xc, xx);
    xy = __fmaf_rn(xc, yc, xy);
    x = __fadd_rn(x, xc);
    yy = __fmaf_rn(yc, yc, yy);
    y = __fadd_rn(y, yc);
    n = __fadd_rn(n, 1.0f);
  }
};

// The moments of cluster c, reduced by one warp: every lane ends with all
// of them in `out` (16 row-major entries, then cx, cy, zbar).
__device__ __forceinline__ void warp_moments(const float2* __restrict__ src,
                                             int count, int P, int lane,
                                             float (&out)[kMom]) {
  const float n = fmaxf((float)count, 1.0f);
  const bool held = P <= 32 * kHold;

  // pass 1: masked coordinate sums
  float2 keep[kHold];
  float sx = 0.0f, sy = 0.0f;
  if (held) {
#pragma unroll
    for (int k = 0; k < kHold; ++k) {
      const int i = lane + 32 * k;
      keep[k] = make_float2(0.0f, 0.0f);
      if (i < P && i < count) {
        keep[k] = src[i];
        sx = __fadd_rn(sx, keep[k].x);
        sy = __fadd_rn(sy, keep[k].y);
      }
    }
  } else {
    for (int i = lane; i < P && i < count; i += 32) {
      const float2 p = src[i];
      sx = __fadd_rn(sx, p.x);
      sy = __fadd_rn(sy, p.y);
    }
  }
  const float cx = __fdiv_rn(warp_sum(sx), n);
  const float cy = __fdiv_rn(warp_sum(sy), n);

  // pass 2: the ten distinct sums of M
  Sums a;
  if (held) {
#pragma unroll
    for (int k = 0; k < kHold; ++k) {
      const int i = lane + 32 * k;
      if (i < P && i < count) a.add(keep[k], cx, cy);
    }
  } else {
    for (int i = lane; i < P && i < count; i += 32) a.add(src[i], cx, cy);
  }
  const float szz = warp_sum(a.zz), szx = warp_sum(a.zx);
  const float szy = warp_sum(a.zy), sz = warp_sum(a.z);
  const float sxx = warp_sum(a.xx), sxy = warp_sum(a.xy);
  const float sxc = warp_sum(a.x), syy = warp_sum(a.yy);
  const float syc = warp_sum(a.y), sn = warp_sum(a.n);
  const float row[kMom] = {szz, szx, szy, sz,  szx, sxx, sxy, sxc,
                           szy, sxy, syy, syc, sz,  sxc, syc, sn,
                           cx,  cy,  __fdiv_rn(sz, n)};
#pragma unroll
  for (int k = 0; k < kMom; ++k) out[k] = row[k];
}

__device__ __forceinline__ void store_moments(const float (&m)[kMom], int c,
                                              float* __restrict__ m16,
                                              float* __restrict__ cent,
                                              float* __restrict__ zbar) {
  float4* out = reinterpret_cast<float4*>(m16 + (size_t)c * 16);
  out[0] = make_float4(m[0], m[1], m[2], m[3]);
  out[1] = make_float4(m[4], m[5], m[6], m[7]);
  out[2] = make_float4(m[8], m[9], m[10], m[11]);
  out[3] = make_float4(m[12], m[13], m[14], m[15]);
  cent[2 * (size_t)c] = m[16];
  cent[2 * (size_t)c + 1] = m[17];
  zbar[c] = m[18];
}

// --------------------------------------------------------------------- tail
// Every arithmetic step below is one elementwise operation of the plain
// version, rounded once and never fused.

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// The same bits, through a move the compiler cannot see through.
__device__ __forceinline__ float opaque(float v) {
  float r;
  asm("mov.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// torch.clamp_min(v, 0): NaN passes through.
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// The trace of one cluster's tail (circle_fit_trace): every angle, cosine
// and sine, the sorted eigenpairs, Y, Q, the chosen vector, the branch and
// the result, in the order ops/kernels/circle_fit.trace_names lists them.
struct NoTrace {
  __device__ __forceinline__ void operator()(float) {}
};
struct Trace {
  float* out;
  int k = 0;
  __device__ __forceinline__ void operator()(float v) { out[k++] = v; }
};

// The rotation pairs (0,1) (0,2) (0,3) (1,2) (1,3) (2,3) and the sort's
// comparators (0,1) (2,3) (0,2) (1,3) (1,2), as functions so that the
// unrolled loops fold them to constants.
__device__ constexpr int pair_p(int r) { return r < 3 ? 0 : r < 5 ? 1 : 2; }
__device__ constexpr int pair_q(int r) {
  return r == 0 ? 1 : r == 1 || r == 3 ? 2 : 3;
}
__device__ constexpr int sort_k(int r) { return r == 1 ? 2 : r >= 3 ? 1 : 0; }
__device__ constexpr int sort_l(int r) {
  return r == 0 ? 1 : r == 1 || r == 3 ? 3 : 2;
}
// Column k of a 16-entry row from the 10 distinct moments.
__device__ constexpr int distinct(int k) {
  return k < 4 ? k : k == 4 ? 1 : k < 8 ? k - 1 : k == 8 ? 2 : k == 9 ? 5
       : k < 12 ? k - 3 : k == 12 ? 3 : k == 13 ? 6 : k == 14 ? 8 : 9;
}

// Symmetric 4x4 eigendecomposition by cyclic Jacobi (smallalg.eigh4_jacobi_c):
// `a` the 16 entries row-major; lam ascending, V's columns the vectors.
template <class Tr>
__device__ __forceinline__ void eigh4(const float (&a)[16], float (&lam)[4],
                                      float (&V)[4][4], Tr& tr) {
  float A[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      A[i][j] = mul(0.5f, add(a[i * 4 + j], a[j * 4 + i]));
      V[i][j] = i == j ? 1.0f : 0.0f;
    }
#pragma unroll 1
  for (int sweep = 0; sweep < 8; ++sweep) {
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const int p = pair_p(r), q = pair_q(r);
      const float theta =
          mul(0.5f, atan2f(mul(2.0f, A[p][q]), sub(A[q][q], A[p][p])));
      // cos and sin as two calls, as the plain version's two kernels make
      // them: the opaque copy keeps the compiler from merging them into
      // one sincosf
      const float c = cosf(theta);
      const float s = sinf(opaque(theta));
      tr(theta);
      tr(c);
      tr(s);
      // rows p, q of G^T A
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float ap = A[p][k], aq = A[q][k];
        A[p][k] = sub(mul(c, ap), mul(s, aq));
        A[q][k] = add(mul(s, ap), mul(c, aq));
      }
      // then columns p, q of (G^T A) G, and V G
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float bp = A[i][p], bq = A[i][q];
        A[i][p] = sub(mul(c, bp), mul(s, bq));
        A[i][q] = add(mul(s, bp), mul(c, bq));
        const float vp = V[i][p], vq = V[i][q];
        V[i][p] = sub(mul(c, vp), mul(s, vq));
        V[i][q] = add(mul(s, vp), mul(c, vq));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) lam[i] = A[i][i];
  // ascending: the 5-comparator network, swapping (value, column)
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    const int k = sort_k(r), l = sort_l(r);
    const bool take = lam[k] > lam[l];
    const float lk = lam[k], ll = lam[l];
    lam[k] = take ? ll : lk;
    lam[l] = take ? lk : ll;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float vk = V[i][k], vl = V[i][l];
      V[i][k] = take ? vl : vk;
      V[i][l] = take ? vk : vl;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) tr(lam[i]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tr(V[i][j]);
}

// The fit of one cluster from its 16 moments, centroid and zbar; `live` is
// valid && count >= 4. Writes the centre, the radius and ok.
template <class Tr>
__device__ __forceinline__ void fit_tail(const float (&m)[16], float cx,
                                         float cy, float zbar, bool live,
                                         float& ocx, float& ocy, float& orad,
                                         bool& ok, Tr& tr) {
  float lam[4], V[4][4];
  eigh4(m, lam, V, tr);
  float s[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[k] = __fsqrt_rn(clamp0(lam[k]));
    tr(s[k]);
  }
  const float sigma4 = s[0];

  // Y = V S V^T, symmetric: each sum starts from 0 as Python's sum() does
  float Y[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = add(acc, mul(mul(V[i][k], s[k]), V[j][k]));
      Y[i][j] = Y[j][i] = acc;
      tr(acc);
    }
  // Y Hinv with the closed-form Hinv (0.5 anti-diagonal corners, identity
  // middle, -2 zbar at [3,3])
  const float z2 = mul(2.0f, zbar);
  float YH[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    YH[i][0] = mul(0.5f, Y[i][3]);
    YH[i][1] = Y[i][1];
    YH[i][2] = Y[i][2];
    YH[i][3] = sub(mul(0.5f, Y[i][0]), mul(z2, Y[i][3]));
  }
  float Q[16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) acc = add(acc, mul(YH[i][k], Y[k][j]));
      Q[i * 4 + j] = Q[j * 4 + i] = acc;
      tr(acc);
    }

  float eq[4], EV[4][4];
  eigh4(Q, eq, EV, tr);
  // the smallest positive eigenvalue, column 0 if none is positive
  float big[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) big[k] = eq[k] > 0.0f ? eq[k] : INFINITY;
  float best = big[0];
  float As[4] = {EV[0][0], EV[1][0], EV[2][0], EV[3][0]};
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const bool take = big[k] < best;
    best = take ? big[k] : best;
#pragma unroll
    for (int i = 0; i < 4; ++i) As[i] = take ? EV[i][k] : As[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) tr(As[i]);

  // A = solve(Y + bump I, A*): adjugate times the vector, then the divide
  const bool rank_def = sigma4 < 1e-12f;
  tr(rank_def ? 1.0f : 0.0f);
  const float bump = rank_def ? 1.0f : 0.0f;
  float M[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      M[i][j] = add(Y[i][j], mul(bump, i == j ? 1.0f : 0.0f));
  const float s0 = sub(mul(M[2][0], M[3][1]), mul(M[2][1], M[3][0]));
  const float s1 = sub(mul(M[2][0], M[3][2]), mul(M[2][2], M[3][0]));
  const float s2 = sub(mul(M[2][0], M[3][3]), mul(M[2][3], M[3][0]));
  const float s3 = sub(mul(M[2][1], M[3][2]), mul(M[2][2], M[3][1]));
  const float s4 = sub(mul(M[2][1], M[3][3]), mul(M[2][3], M[3][1]));
  const float s5 = sub(mul(M[2][2], M[3][3]), mul(M[2][3], M[3][2]));
  const float c0 = sub(mul(M[0][0], M[1][1]), mul(M[0][1], M[1][0]));
  const float c1 = sub(mul(M[0][0], M[1][2]), mul(M[0][2], M[1][0]));
  const float c2 = sub(mul(M[0][0], M[1][3]), mul(M[0][3], M[1][0]));
  const float c3 = sub(mul(M[0][1], M[1][2]), mul(M[0][2], M[1][1]));
  const float c4 = sub(mul(M[0][1], M[1][3]), mul(M[0][3], M[1][1]));
  const float c5 = sub(mul(M[0][2], M[1][3]), mul(M[0][3], M[1][2]));
  float det = add(sub(add(add(sub(mul(c0, s5), mul(c1, s4)), mul(c2, s3)),
                          mul(c3, s2)),
                      mul(c4, s1)),
                  mul(c5, s0));
  det = fabsf(det) < 1e-30f ? 1e-30f : det;
  // the adjugate, row by row: (+ - +) and (- + -) cofactor sums
  const float adj[4][4] = {
      {add(sub(mul(M[1][1], s5), mul(M[1][2], s4)), mul(M[1][3], s3)),
       sub(add(mul(-M[0][1], s5), mul(M[0][2], s4)), mul(M[0][3], s3)),
       add(sub(mul(M[3][1], c5), mul(M[3][2], c4)), mul(M[3][3], c3)),
       sub(add(mul(-M[2][1], c5), mul(M[2][2], c4)), mul(M[2][3], c3))},
      {sub(add(mul(-M[1][0], s5), mul(M[1][2], s2)), mul(M[1][3], s1)),
       add(sub(mul(M[0][0], s5), mul(M[0][2], s2)), mul(M[0][3], s1)),
       sub(add(mul(-M[3][0], c5), mul(M[3][2], c2)), mul(M[3][3], c1)),
       add(sub(mul(M[2][0], c5), mul(M[2][2], c2)), mul(M[2][3], c1))},
      {add(sub(mul(M[1][0], s4), mul(M[1][1], s2)), mul(M[1][3], s0)),
       sub(add(mul(-M[0][0], s4), mul(M[0][1], s2)), mul(M[0][3], s0)),
       add(sub(mul(M[3][0], c4), mul(M[3][1], c2)), mul(M[3][3], c0)),
       sub(add(mul(-M[2][0], c4), mul(M[2][1], c2)), mul(M[2][3], c0))},
      {sub(add(mul(-M[1][0], s3), mul(M[1][1], s1)), mul(M[1][2], s0)),
       add(sub(mul(M[0][0], s3), mul(M[0][1], s1)), mul(M[0][2], s0)),
       sub(add(mul(-M[3][0], c3), mul(M[3][1], c1)), mul(M[3][2], c0)),
       add(sub(mul(M[2][0], c3), mul(M[2][1], c1)), mul(M[2][2], c0))}};
  float A[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = dvd(add(add(add(mul(adj[i][0], As[0]), mul(adj[i][1], As[1])),
                                mul(adj[i][2], As[2])),
                            mul(adj[i][3], As[3])),
                        det);
    tr(x);
    A[i] = rank_def ? V[i][0] : x;      // the null vector when rank-deficient
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) tr(A[i]);

  // the circle, relative to the centroid, with the 1e-30 floor on A0
  const float A0 = fabsf(A[0]) < 1e-30f ? 1e-30f : A[0];
  const float a = dvd(-A[1], mul(2.0f, A0));
  const float b = dvd(-A[2], mul(2.0f, A0));
  const float R2 = dvd(sub(add(mul(A[1], A[1]), mul(A[2], A[2])),
                           mul(mul(4.0f, A[0]), A[3])),
                       mul(mul(4.0f, A0), A0));
  orad = __fsqrt_rn(clamp0(R2));
  ocx = add(a, cx);
  ocy = add(b, cy);
  ok = live && isfinite(ocx) && isfinite(ocy) && isfinite(orad);
  tr(ocx);
  tr(ocy);
  tr(orad);
  tr(ok ? 1.0f : 0.0f);
}

// ------------------------------------------------------------------ kernels

// kTail = false: the moments alone, one warp a cluster, kWarps a block.
// kTail = true: kFitWarps warps take kFitClusters clusters' moments, then
// one warp fits them, a cluster a lane.
template <bool kTail>
__global__ void __launch_bounds__(kTail ? kFitWarps * 32 : kWarps * 32)
circle_fit_kernel(const float2* __restrict__ points,
                  const int32_t* __restrict__ counts,
                  const uint8_t* __restrict__ valid, float* __restrict__ m16,
                  float* __restrict__ cent, float* __restrict__ zbar,
                  float2* __restrict__ center, float* __restrict__ radius,
                  uint8_t* __restrict__ ok, int C, int P) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (!kTail) {
    const int c = blockIdx.x * kWarps + warp;
    if (c >= C) return;                   // whole warp leaves together
    float m[kMom];
    warp_moments(points + (size_t)c * P, counts[c], P, lane, m);
    if (lane == 0) store_moments(m, c, m16, cent, zbar);
  } else {
    __shared__ float staged[kFitClusters][kMom + 1];
    const int base = blockIdx.x * kFitClusters;
    for (int j = warp; j < kFitClusters; j += kFitWarps) {
      const int c = base + j;
      if (c >= C) break;                  // whole warp leaves together
      float m[kMom];
      warp_moments(points + (size_t)c * P, counts[c], P, lane, m);
      if (lane == 0) {
        store_moments(m, c, m16, cent, zbar);
#pragma unroll
        for (int k = 0; k < kMom; ++k) staged[j][k] = m[k];
      }
    }
    __syncthreads();
    if (warp != (int)(blockIdx.x % kFitWarps)) return;
    const int c = base + lane;
    if (c >= C) return;
    float m[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = staged[lane][k];
    const bool live = valid[c] != 0 && counts[c] >= 4;
    float ox, oy, orad;
    bool good;
    NoTrace tr;
    fit_tail(m, staged[lane][16], staged[lane][17], staged[lane][18], live,
             ox, oy, orad, good, tr);
    center[c] = make_float2(ox, oy);
    radius[c] = orad;
    ok[c] = good;
  }
}

// The 16 moments of cluster c from a row of `mom`: all 16 row-major
// (layout 16) or the 10 distinct ones zz zx zy z xx xy x yy y n (layout 10).
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int layout, float (&m)[16]) {
  if (layout == 16) {
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = row[k];
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = row[distinct(k)];
  }
}

__global__ void __launch_bounds__(kTailThreads)
circle_fit_tail_kernel(const float* __restrict__ mom, int stride, int layout,
                       const float* __restrict__ cx,
                       const float* __restrict__ cy,
                       const float* __restrict__ zbar,
                       const int32_t* __restrict__ count,
                       const uint8_t* __restrict__ valid,
                       float2* __restrict__ center, float* __restrict__ radius,
                       uint8_t* __restrict__ ok, int C) {
  const int c = blockIdx.x * kTailThreads + threadIdx.x;
  if (c >= C) return;
  float m[16];
  load_row(mom + (size_t)c * stride, layout, m);
  const bool live = valid[c] != 0 && count[c] >= 4;
  float ox, oy, orad;
  bool good;
  NoTrace tr;
  fit_tail(m, cx[c], cy[c], zbar[c], live, ox, oy, orad, good, tr);
  center[c] = make_float2(ox, oy);
  radius[c] = orad;
  ok[c] = good;
}

// One cluster's tail with every intermediate written to `trace`.
__global__ void circle_fit_trace_kernel(const float* __restrict__ in, int live,
                                        float* __restrict__ trace) {
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = in[k];
  float ox, oy, orad;
  bool good;
  Trace tr{trace};
  fit_tail(m, in[16], in[17], in[18], live != 0, ox, oy, orad, good, tr);
}

// The tail's dependent chain alone: one warp, each lane fitting its
// cluster `iters` times, each fit waiting for the last one's radius
// through an opaque zero, so that nothing overlaps and nothing is read
// from memory inside the loop.
__global__ void circle_fit_probe_kernel(const float* __restrict__ in,
                                        float* __restrict__ out, int iters) {
  const float* row = in + threadIdx.x * kMom;
  float m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m[k] = row[k];
  const float cx = row[16], cy = row[17], zb = row[18];
  float acc = 0.0f;
  NoTrace tr;
  for (int it = 0; it < iters; ++it) {
    float ox, oy, orad;
    bool good;
    fit_tail(m, cx, cy, zb, true, ox, oy, orad, good, tr);
    unsigned zero;
    asm volatile("and.b32 %0, %1, 0;" : "=r"(zero) : "r"(__float_as_uint(orad)));
    m[0] = __uint_as_float(__float_as_uint(m[0]) ^ zero);
    acc = add(acc, good ? ox : oy);
  }
  out[threadIdx.x] = acc;
}

}  // namespace

// Every entry returns cudaGetLastError() after its launch (0 = launched).

// points (C, P, 2) f32 contiguous, 8-byte aligned; counts (C,) int32;
// m16 (C, 16) 16-byte aligned, cent (C, 2), zbar (C,).
extern "C" int circle_moments(const void* points, const void* counts,
                              void* m16, void* cent, void* zbar, int C,
                              int P, void* stream) {
  if (C <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (C + kWarps - 1) / kWarps;
  circle_fit_kernel<false><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float2*)points, (const int32_t*)counts, nullptr, (float*)m16,
      (float*)cent, (float*)zbar, nullptr, nullptr, nullptr, C, P);
  return (int)cudaGetLastError();
}

// As circle_moments, plus valid (C,) bool, and out: center (C, 2) 8-byte
// aligned, radius (C,), ok (C,) bool.
extern "C" int circle_fit(const void* points, const void* counts,
                          const void* valid, void* m16, void* cent,
                          void* zbar, void* center, void* radius, void* ok,
                          int C, int P, void* stream) {
  if (C <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (C + kFitClusters - 1) / kFitClusters;
  circle_fit_kernel<true><<<blocks, kFitWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float2*)points, (const int32_t*)counts, (const uint8_t*)valid,
      (float*)m16, (float*)cent, (float*)zbar, (float2*)center,
      (float*)radius, (uint8_t*)ok, C, P);
  return (int)cudaGetLastError();
}

// mom: C rows of `layout` (16 or 10) floats, `stride` floats apart;
// cx, cy, zbar (C,) f32; count (C,) int32; valid (C,) bool; out as above.
extern "C" int circle_fit_tail(const void* mom, int stride, int layout,
                               const void* cx, const void* cy,
                               const void* zbar, const void* count,
                               const void* valid, void* center, void* radius,
                               void* ok, int C, void* stream) {
  if (C <= 0 || (layout != 16 && layout != 10) || stride < layout)
    return (int)cudaErrorInvalidValue;
  const int blocks = (C + kTailThreads - 1) / kTailThreads;
  circle_fit_tail_kernel<<<blocks, kTailThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mom, stride, layout, (const float*)cx, (const float*)cy,
      (const float*)zbar, (const int32_t*)count, (const uint8_t*)valid,
      (float2*)center, (float*)radius, (uint8_t*)ok, C);
  return (int)cudaGetLastError();
}

// in: 16 moments, cx, cy, zbar of one cluster; live = valid && count >= 4;
// trace: the intermediates (ops/kernels/circle_fit.TRACE_LEN floats).
extern "C" int circle_fit_trace(const void* in, int live, void* trace,
                                void* stream) {
  circle_fit_trace_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)in, live, (float*)trace);
  return (int)cudaGetLastError();
}

// in: 32 clusters' 19 staged floats (16 moments, cx, cy, zbar); out (32,).
extern "C" int circle_fit_probe(const void* in, void* out, int iters,
                                void* stream) {
  circle_fit_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const float*)in, (float*)out, iters);
  return (int)cudaGetLastError();
}
