// The batch-trailing filter's whole tick, one launch for all B worlds, for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package runs models/ekf_batch.step (and
// known_association_step) as XLA-fused jnp, which the port ran op for op as
// eager PyTorch (~8.8k launches a tick of config 3). Each of ~600 of those
// ops read or wrote a whole (D, D, B) covariance: ~606 GB a tick at D=43,
// B=65536, where the tick's state is ~1 GB read and written once.
//
// One tick of one world: the predict's rank-2 strip, then the tick's M
// measurements in order: association (first-hit or nearest Mahalanobis
// over the N slots, or the known id), the overflow and sticky stop rule,
// the landmark init (mean, and the analytic first-observation covariance)
// where the outcome is new, and the rank-2 Kalman update (symmetrized or
// plain downdate) where it acts. A world that does not act in a
// measurement does no work there, and its state is left as it was.
//
// What bounds it on an H100: device-memory bytes, 2 x 4 D^2 B for the
// covariance (0.97 GB at D=43, B=65536, ~0.29 ms at 3.35 TB/s); the
// arithmetic is a few GFLOP.
//
// Design (lane = world): a block holds W = 8 worlds and 32 threads a
// world, thread t serving world t % W and slice t / W. The covariance,
// mean and bookkeeping of its worlds are copied once into dynamic shared
// memory with cp.async (16-byte copies of 4 worlds of one entry where
// B % 4 == 0: the batch-trailing layout makes each entry's 8 worlds one
// 32 B sector), stay there through the predict and all M measurements,
// and are written back once. 8 worlds take 69 KB at D=43, so three blocks
// share an SM and one block's loads overlap another's arithmetic (16
// worlds, one block an SM, ran the tick 1.3x slower; 4 worlds, 16 B a
// segment, read the state at a third of the rate). Shared words
// are [entry][world], so the threads of a warp, which serve neighbouring
// worlds of neighbouring entries (or rows: D is odd), hit distinct banks.
// Full storage (not packed symmetric): the plain path's covariance is not
// exactly symmetric in float32 (its sums take the two triangles' terms in
// other orders), and the kernel keeps both triangles as that path does.
// Per measurement the slices split the work of a phase: the N slots'
// distances (a slot a slice), the new slot's rows and columns, SHt's and
// K's D rows, the downdate's D^2 entries; one thread a world takes the
// decisions. Phases are separated by block barriers; a phase that no world
// of the block needs is skipped as a whole (__syncthreads_or).
//
// Every floating-point operation is the plain path's own, in its order,
// with its rounding: products and sums through __fmul_rn / __fadd_rn (no
// contraction into FMAs), the CUDA math library's sinf, cosf, atan2f and
// IEEE sqrtf / division, which PyTorch's elementwise kernels on the card
// use too; the plain path's masked sums read one entry and add zeros,
// which is the entry. So on the card a world's tick is the plain path's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWorlds = 8;         // worlds a block (W)
constexpr int kSlices = 32;        // threads a world
constexpr int kScalars = 16;       // per-world scalars in shared memory
constexpr int kTile = 3;           // downdate tile edge (odd: see (F))
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use

// flags
constexpr int kKnown = 1, kNearest = 2, kAnalytic = 4, kSymmetrize = 8,
              kWrap = 16;
// per-world decision bits
constexpr int kIsNew = 1, kDoUpdate = 2, kOverflow = 4;
// per-world scalars: h5 rows (10), dz (2), Gx's first column (2), b (2)
constexpr int kW0 = 0, kW1 = 5, kDz0 = 10, kDz1 = 11, kG0 = 12, kG1 = 13,
              kB1 = 14, kB2 = 15;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
// se2.normalize_angle
__device__ __forceinline__ float wrap(float x) {
  return atan2f(sinf(x), cosf(x));
}
// torch.clamp_min(x, 1e-12) (NaN passes through)
__device__ __forceinline__ float clamp_d(float x) {
  return x < 1e-12f ? 1e-12f : x;
}
// ekf_batch._floor_det
__device__ __forceinline__ float floor_det(float det) {
  return fabsf(det) < 1e-30f ? 1e-30f : det;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
#else
  memcpy(dst, src, 4);
#endif
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

struct Args {
  const float* cov;       // (D, D, B)
  const float* mean;      // (D, B)
  const int* n_seen;      // (B,)
  const uint8_t* seen;    // (N, B)
  const float* twist;     // (B, 3)
  const float* zs;        // (B, M, 2)
  const uint8_t* valid;   // (B, M)
  const int* ids;         // (B, M) or null (unknown association)
  const float* Q;         // (3, 3)
  const float* R;         // (2, 2)
  float* cov_o;
  float* mean_o;
  int* n_seen_o;
  uint8_t* seen_o;
  float* margins_o;       // (B,) or null
  int D, M, B, flags;
  float match_gate, new_gate;
};

// Bytes of dynamic shared memory a block of W worlds takes; the Python
// launch plan (ops/kernels/ekf_tick.shared_bytes) computes the same.
__host__ __device__ inline int smem_bytes(int D, int M, int W) {
  const int N = (D - 3) / 2;
  const int floats = W * (D * D + 5 * D + N + 2 * M + kScalars) + 16;
  const int ints = W * (3 + M);
  const int bytes = W * (N + M);
  return (4 * (floats + ints) + bytes + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kSlices * kWorlds)
ekf_tick_kernel(const Args a) {
  constexpr int W = kWorlds;
  constexpr int T = kSlices * W;
  constexpr int S = kSlices;
  const int D = a.D, M = a.M, B = a.B;
  const int N = (D - 3) / 2;
  const int DD = D * D;
  const int w = threadIdx.x % W, s = threadIdx.x / W;
  const int b0 = blockIdx.x * W;
  const int b = b0 + w;
  const int nw = min(W, B - b0);  // live worlds of this block
  const bool live = w < nw;
  const bool known = a.flags & kKnown;
  const bool analytic = a.flags & kAnalytic;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_cov = reinterpret_cast<float*>(smem_raw);
  float* s_mean = s_cov + DD * W;
  float* s_sh0 = s_mean + D * W;
  float* s_sh1 = s_sh0 + D * W;
  float* s_k0 = s_sh1 + D * W;
  float* s_k1 = s_k0 + D * W;
  float* s_dist = s_k1 + D * W;
  float* s_zs = s_dist + N * W;
  float* s_sc = s_zs + 2 * M * W;
  float* s_qr = s_sc + kScalars * W;
  int* s_j = reinterpret_cast<int*>(s_qr + 16);
  int* s_flag = s_j + W;
  int* s_nseen = s_flag + W;
  int* s_ids = s_nseen + W;
  uint8_t* s_seen = reinterpret_cast<uint8_t*>(s_ids + M * W);
  uint8_t* s_valid = s_seen + N * W;

#define COV(i, j) s_cov[((i) * D + (j)) * W + w]
#define MEAN(i) s_mean[(i) * W + w]
#define SC(k) s_sc[(k) * W + w]

  // ---- load the block's worlds once
  if (B % 4 == 0) {
    constexpr int Q4 = W / 4;
    for (int c = threadIdx.x; c < DD * Q4; c += T) {
      const int e = c / Q4, q = 4 * (c % Q4);
      if (q < nw)
        cp_async16(s_cov + e * W + q, a.cov + (size_t)e * B + b0 + q);
    }
    for (int c = threadIdx.x; c < D * Q4; c += T) {
      const int e = c / Q4, q = 4 * (c % Q4);
      if (q < nw)
        cp_async16(s_mean + e * W + q, a.mean + (size_t)e * B + b0 + q);
    }
  } else if (live) {
    for (int e = s; e < DD; e += S)
      cp_async4(s_cov + e * W + w, a.cov + (size_t)e * B + b);
    for (int e = s; e < D; e += S)
      cp_async4(s_mean + e * W + w, a.mean + (size_t)e * B + b);
  }
  for (int n = s; n < N; n += S)
    s_seen[n * W + w] = live ? a.seen[(size_t)n * B + b] : 0;
  if (s == 0) s_nseen[w] = live ? a.n_seen[b] : 0;
  for (int i = threadIdx.x; i < W * M; i += T) {
    const int gw = i / M, k = i % M;
    const size_t g = (size_t)(b0 + gw) * M + k;
    const bool on = gw < nw;
    s_valid[k * W + gw] = on ? a.valid[g] : 0;
    s_zs[2 * k * W + gw] = on ? a.zs[2 * g] : 0.f;
    s_zs[(2 * k + 1) * W + gw] = on ? a.zs[2 * g + 1] : 0.f;
    if (known) s_ids[k * W + gw] = on ? a.ids[g] : -1;
  }
  if (threadIdx.x < 9) s_qr[threadIdx.x] = a.Q[threadIdx.x];
  else if (threadIdx.x < 13) s_qr[threadIdx.x] = a.R[threadIdx.x - 9];
  cp_async_wait_all();
  __syncthreads();
  const float R00 = s_qr[9], R01 = s_qr[10], R10 = s_qr[11], R11 = s_qr[12];

  // ---- predict (ekf_batch.predict): the motion and B - I's two nonzeros
  if (s == 0 && live) {
    const float th = MEAN(0);
    const float dth = a.twist[3 * (size_t)b], dx = a.twist[3 * (size_t)b + 1];
    const bool small = fabsf(dth) < 1e-7f;
    const float ratio = dvd(dx, small ? 1.f : dth);
    const float st = sinf(th), ct = cosf(th);
    const float st1 = sinf(add(th, dth)), ct1 = cosf(add(th, dth));
    const float dqx = small ? mul(dx, ct)
                            : add(mul(-ratio, st), mul(ratio, st1));
    const float dqy = small ? mul(dx, st)
                            : sub(mul(ratio, ct), mul(ratio, ct1));
    SC(kB1) = small ? mul(-dx, st) : add(mul(-ratio, ct), mul(ratio, ct1));
    SC(kB2) = dqx;  // b20 is dq_x's expression
    MEAN(0) = add(th, dth);
    MEAN(1) = add(MEAN(1), dqx);
    MEAN(2) = add(MEAN(2), dqy);
  }
  __syncthreads();
  if (live) {
    // the strip: rows 1, 2 and columns 1, 2 beyond the robot block gain
    // b_p times the original row 0
    const float b1 = SC(kB1), b2 = SC(kB2);
    for (int c = 3 + s; c < D; c += S) {
      const float r = COV(0, c);
      COV(1, c) = add(COV(1, c), mul(b1, r));
      COV(2, c) = add(COV(2, c), mul(b2, r));
      COV(c, 1) = add(COV(c, 1), mul(b1, r));
      COV(c, 2) = add(COV(c, 2), mul(b2, r));
    }
    if (s == 0) {
      // the robot block: row update, column update, s00 b b^T, Q
      const float bb[3] = {0.f, b1, b2};
      float r0[3], c[3][3];
      for (int i = 0; i < 3; ++i) r0[i] = COV(0, i);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) c[i][j] = COV(i, j);
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          float v = c[i][j];
          if (i > 0) v = add(v, mul(bb[i], r0[j]));
          if (j > 0) v = add(v, mul(bb[j], r0[i]));
          if (i > 0 && j > 0) v = add(v, mul(mul(r0[0], bb[i]), bb[j]));
          COV(i, j) = add(v, s_qr[3 * i + j]);
        }
    }
  }

  // ---- the M measurements, in order
  bool stopped = false;          // sticky, the same in a world's threads
  float margin = INFINITY;       // the decision thread's
  const float mg = a.match_gate, ng = a.new_gate;
  const float inv_mg = dvd(1.f, mg), inv_ng = dvd(1.f, ng);
  for (int k = 0; k < M; ++k) {
    const int jid = known ? s_ids[k * W + w] : 0;
    const bool act = live && s_valid[k * W + w] && !stopped &&
                     (!known || (jid >= 0 && jid < N));
    if (known && jid >= N) stopped = true;
    // the barrier that ends the previous measurement (or the predict)
    if (!__syncthreads_or(act)) continue;
    const float zr = s_zs[2 * k * W + w], zb = s_zs[(2 * k + 1) * W + w];

    // (A) the Mahalanobis distance to every seen slot (ekf_batch.associate)
    if (!known) {
      for (int n = s; n < N; n += S) {
        float dist = INFINITY;
        if (act && s_seen[n * W + w]) {
          const int lm = 3 + 2 * n;
          const float dx = sub(MEAN(lm), MEAN(1));
          const float dy = sub(MEAN(lm + 1), MEAN(2));
          const float d = clamp_d(add(mul(dx, dx), mul(dy, dy)));
          const float sq = sqrtf(d);
          const float a_ = dvd(dx, sq), b_ = dvd(dy, sq);
          const float c_ = dvd(dy, d), e_ = dvd(-dx, d);
          const float wr[2][5] = {{0.f, -a_, -b_, a_, b_},
                                  {-1.f, c_, e_, -c_, -e_}};
          float crr[3][3], rm[6], dg[4];
          for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) crr[i][j] = COV(i, j);
          for (int i = 0; i < 3; ++i)
            for (int p = 0; p < 2; ++p) rm[2 * i + p] = COV(i, lm + p);
          for (int p = 0; p < 2; ++p)
            for (int q = 0; q < 2; ++q) dg[2 * p + q] = COV(lm + p, lm + q);
          float psi[2][2];
          for (int l = 0; l < 2; ++l) {
            const float* wl = wr[l];
            float u[5];
            for (int i = 0; i < 3; ++i)
              u[i] = add(add(add(add(mul(crr[i][0], wl[0]),
                                     mul(crr[i][1], wl[1])),
                                 mul(crr[i][2], wl[2])),
                             mul(rm[2 * i], wl[3])),
                         mul(rm[2 * i + 1], wl[4]));
            for (int p = 0; p < 2; ++p)
              u[3 + p] = add(add(add(add(mul(rm[p], wl[0]),
                                         mul(rm[2 + p], wl[1])),
                                     mul(rm[4 + p], wl[2])),
                                 mul(dg[2 * p], wl[3])),
                             mul(dg[2 * p + 1], wl[4]));
            for (int p = 0; p < 2; ++p) {
              const float* wp = wr[p];
              psi[p][l] = add(add(add(add(add(mul(wp[0], u[0]),
                                              mul(wp[1], u[1])),
                                          mul(wp[2], u[2])),
                                      mul(wp[3], u[3])),
                                  mul(wp[4], u[4])),
                              s_qr[9 + 2 * p + l]);
            }
          }
          const float zh1 = wrap(sub(atan2f(dy, dx), MEAN(0)));
          const float dz0 = sub(zr, sq);
          float dz1 = sub(zb, zh1);
          if (a.flags & kWrap) dz1 = wrap(dz1);
          const float det = floor_det(sub(mul(psi[0][0], psi[1][1]),
                                          mul(psi[0][1], psi[1][0])));
          dist = dvd(add(mul(dz0, sub(mul(psi[1][1], dz0),
                                      mul(psi[0][1], dz1))),
                         mul(dz1, add(mul(-psi[1][0], dz0),
                                      mul(psi[0][0], dz1)))),
                     det);
        }
        s_dist[n * W + w] = dist;
      }
      __syncthreads();
    }

    // (B) one thread a world decides, inits the new slot's mean and
    // 2 x 2 block, and prepares the update's scalars
    int flag = 0;
    if (s == 0 && act) {
      const int n_seen = s_nseen[w];
      int index;
      bool is_new, do_update;
      if (known) {
        index = jid;
        const bool seen_j = s_seen[jid * W + w];
        is_new = !seen_j;
        do_update = analytic ? seen_j : true;
      } else {
        bool any_hit, first_match;
        int first = 0;
        // the gate margins (diagnostics), only where the caller asks; a
        // product by the gate's reciprocal, as PyTorch divides a tensor by
        // a host scalar on the card
        for (int n = 0; a.margins_o != nullptr && n < N; ++n) {
          if (!s_seen[n * W + w]) continue;
          const float dist = s_dist[n * W + w];
          margin = fminf(margin, fminf(mul(fabsf(sub(dist, mg)), inv_mg),
                                       mul(fabsf(sub(dist, ng)), inv_ng)));
        }
        if (a.flags & kNearest) {
          float best = INFINITY;
          for (int n = 0; n < N; ++n) {
            const float dist = s_dist[n * W + w];
            if (dist < best) {
              best = dist;
              first = n;
            }
          }
          any_hit = best < ng;
          first_match = best < mg;
        } else {
          int hit = N;
          for (int n = 0; n < N; ++n)
            if (s_dist[n * W + w] < ng) {
              hit = n;
              break;
            }
          any_hit = hit < N;
          first = any_hit ? hit : 0;
          first_match = any_hit && s_dist[first * W + w] < mg;
        }
        // ASSOC_NEW / MATCH / SKIP / OVERFLOW
        const bool fresh = n_seen == 0 || !any_hit;
        const bool full = n_seen >= N;
        is_new = fresh && !full;
        const bool is_match = !fresh && first_match;
        if (fresh && full) flag |= kOverflow;
        index = is_match ? first : min(n_seen, N - 1);
        do_update = analytic ? is_match : (is_new || is_match);
      }
      if (is_new) {
        // ekf_batch.init_landmark and _init_cov_comps
        const int lm = 3 + 2 * index;
        const float ang = add(zb, MEAN(0));
        const float ca = cosf(ang), sa = sinf(ang);
        const float m1 = MEAN(1), m2 = MEAN(2);
        MEAN(lm) = add(m1, mul(zr, ca));
        MEAN(lm + 1) = add(m2, mul(zr, sa));
        if (analytic) {
          const float gx[2][3] = {{mul(-zr, sa), 1.f, 0.f},
                                  {mul(zr, ca), 0.f, 1.f}};
          float u[2][3], gxc[2][2];
          for (int q = 0; q < 2; ++q)
            for (int i = 0; i < 3; ++i)
              u[q][i] = add(add(mul(COV(i, 0), gx[q][0]),
                                mul(COV(i, 1), gx[q][1])),
                            mul(COV(i, 2), gx[q][2]));
          for (int p = 0; p < 2; ++p)
            for (int q = 0; q < 2; ++q)
              gxc[p][q] = add(add(mul(gx[p][0], u[q][0]),
                                  mul(gx[p][1], u[q][1])),
                              mul(gx[p][2], u[q][2]));
          const float gz[2][2] = {{ca, mul(-zr, sa)}, {sa, mul(zr, ca)}};
          for (int p = 0; p < 2; ++p)
            for (int q = 0; q < 2; ++q) {
              const float gzr =
                  add(mul(gz[p][0], add(mul(R00, gz[q][0]),
                                        mul(R01, gz[q][1]))),
                      mul(gz[p][1], add(mul(R10, gz[q][0]),
                                        mul(R11, gz[q][1]))));
              COV(lm + p, lm + q) = add(gxc[p][q], gzr);
            }
          SC(kG0) = gx[0][0];
          SC(kG1) = gx[1][0];
        }
        s_nseen[w] = n_seen + 1;
        s_seen[index * W + w] = 1;
        flag |= kIsNew;
      }
      if (do_update) {
        // ekf_batch._landmark_delta, _h5_rows and the innovation
        const int lm = 3 + 2 * index;
        const float dx = sub(MEAN(lm), MEAN(1));
        const float dy = sub(MEAN(lm + 1), MEAN(2));
        const float d = clamp_d(add(mul(dx, dx), mul(dy, dy)));
        const float sq = sqrtf(d);
        const float a_ = dvd(dx, sq), b_ = dvd(dy, sq);
        const float c_ = dvd(dy, d), e_ = dvd(-dx, d);
        const float wr[10] = {0.f, -a_, -b_, a_, b_,
                              -1.f, c_, e_, -c_, -e_};
        for (int i = 0; i < 10; ++i) SC(kW0 + i) = wr[i];
        const float zh1 = wrap(sub(atan2f(dy, dx), MEAN(0)));
        float dz1 = sub(zb, zh1);
        if (a.flags & kWrap) dz1 = wrap(dz1);
        SC(kDz0) = sub(zr, sq);
        SC(kDz1) = dz1;
        flag |= kDoUpdate;
      }
      s_j[w] = index;
    }
    if (s == 0) s_flag[w] = flag;
    const bool any_init =
        __syncthreads_or(s == 0 && analytic && (flag & kIsNew));
    const int my = s_flag[w];
    if (my & kOverflow) stopped = true;
    const int lm = 3 + 2 * s_j[w];

    // (C) the new slot's rows and columns: Gx times the robot rows
    if (any_init) {
      if (analytic && (my & kIsNew)) {
        const float g0 = SC(kG0), g1 = SC(kG1);
        for (int c = s; c < D; c += S) {
          if (c == lm || c == lm + 1) continue;
          const float c0 = COV(0, c), c1 = COV(1, c), c2 = COV(2, c);
          const float x0 = add(add(mul(g0, c0), mul(1.f, c1)), mul(0.f, c2));
          const float x1 = add(add(mul(g1, c0), mul(0.f, c1)), mul(1.f, c2));
          COV(lm, c) = x0;
          COV(c, lm) = x0;
          COV(lm + 1, c) = x1;
          COV(c, lm + 1) = x1;
        }
      }
    }
    if (!__syncthreads_or(s == 0 && (my & kDoUpdate))) continue;

    // (D) the update (ekf_batch.update): SHt's rows
    const bool upd = my & kDoUpdate;
    float wr[2][5];
    for (int i = 0; i < 5; ++i) {
      wr[0][i] = SC(kW0 + i);
      wr[1][i] = SC(kW1 + i);
    }
    if (upd) {
      for (int i = s; i < D; i += S) {
        const float c0 = COV(i, 0), c1 = COV(i, 1), c2 = COV(i, 2);
        const float m0 = COV(i, lm), m1 = COV(i, lm + 1);
        float* sh[2] = {s_sh0, s_sh1};
        for (int q = 0; q < 2; ++q)
          sh[q][i * W + w] = add(add(add(add(mul(c0, wr[q][0]),
                                             mul(c1, wr[q][1])),
                                         mul(c2, wr[q][2])),
                                     mul(m0, wr[q][3])),
                                 mul(m1, wr[q][4]));
      }
    }
    __syncthreads();
    // (E) psi, its inverse, K's rows and the mean
    if (upd) {
      float psi[2][2];
      for (int q = 0; q < 2; ++q) {
        const float* sh = q ? s_sh1 : s_sh0;
        const float r5[5] = {sh[0 * W + w], sh[1 * W + w], sh[2 * W + w],
                             sh[lm * W + w], sh[(lm + 1) * W + w]};
        for (int p = 0; p < 2; ++p)
          psi[p][q] = add(add(add(add(add(mul(wr[p][0], r5[0]),
                                          mul(wr[p][1], r5[1])),
                                      mul(wr[p][2], r5[2])),
                                  mul(wr[p][3], r5[3])),
                              mul(wr[p][4], r5[4])),
                          s_qr[9 + 2 * p + q]);
      }
      const float det = floor_det(sub(mul(psi[0][0], psi[1][1]),
                                      mul(psi[0][1], psi[1][0])));
      const float i00 = dvd(psi[1][1], det), i01 = dvd(-psi[0][1], det);
      const float i10 = dvd(-psi[1][0], det), i11 = dvd(psi[0][0], det);
      const float dz0 = SC(kDz0), dz1 = SC(kDz1);
      for (int i = s; i < D; i += S) {
        const float s0 = s_sh0[i * W + w], s1 = s_sh1[i * W + w];
        const float k0 = add(mul(s0, i00), mul(s1, i10));
        const float k1 = add(mul(s0, i01), mul(s1, i11));
        s_k0[i * W + w] = k0;
        s_k1[i * W + w] = k1;
        float m = add(add(MEAN(i), mul(k0, dz0)), mul(k1, dz1));
        if (i == 0) m = wrap(m);
        MEAN(i) = m;
      }
    }
    __syncthreads();
    // (F) the downdate, over tiles of kTile x kTile entries of the upper
    // triangle, each tile with its mirror: the rows' and columns' K and
    // SHt are read once a tile, and entry (j, i) reuses the four products
    // of entry (i, j), summed in its own order (bits as entry by entry).
    // kTile is odd, so the slices of a warp, on neighbouring tiles of a
    // tile row, touch entries in distinct banks.
    if (upd) {
      const bool sym = a.flags & kSymmetrize;
      const int nt = (D + kTile - 1) / kTile;
      int I = 0, q = s;  // the tile pair: row I of the tile grid, column I + q
      while (I < nt && q >= nt - I) q -= nt - I++;
      while (I < nt) {
        const int J = I + q;
        float k0r[kTile], s0r[kTile], k1r[kTile], s1r[kTile];
        float k0c[kTile], s0c[kTile], k1c[kTile], s1c[kTile];
#pragma unroll
        for (int t = 0; t < kTile; ++t) {
          const int i = min(kTile * I + t, D - 1);
          const int j = min(kTile * J + t, D - 1);
          k0r[t] = s_k0[i * W + w];
          s0r[t] = s_sh0[i * W + w];
          k1r[t] = s_k1[i * W + w];
          s1r[t] = s_sh1[i * W + w];
          k0c[t] = s_k0[j * W + w];
          s0c[t] = s_sh0[j * W + w];
          k1c[t] = s_k1[j * W + w];
          s1c[t] = s_sh1[j * W + w];
        }
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
#pragma unroll
          for (int c = 0; c < kTile; ++c) {
            const int i = kTile * I + r, j = kTile * J + c;
            if (i >= D || j >= D || (I == J && c < r)) continue;
            const float p0 = mul(k0r[r], s0c[c]), p1 = mul(s0r[r], k0c[c]);
            const float p2 = mul(k1r[r], s1c[c]), p3 = mul(s1r[r], k1c[c]);
            float tij, tji;
            if (sym) {
              const float h = add(p0, p1);
              tij = mul(0.5f, add(add(h, p2), p3));
              tji = mul(0.5f, add(add(h, p3), p2));
            } else {
              tij = add(p0, p2);
              tji = add(p1, p3);
            }
            COV(i, j) = sub(COV(i, j), tij);
            if (j != i) COV(j, i) = sub(COV(j, i), tji);
          }
        }
        q += S;
        while (I < nt && q >= nt - I) q -= nt - I++;
      }
    }
  }
  __syncthreads();

  // ---- write the new state once
  if (B % 4 == 0) {
    constexpr int Q4 = W / 4;
    for (int c = threadIdx.x; c < DD * Q4; c += T) {
      const int e = c / Q4, q = 4 * (c % Q4);
      if (q < nw)
        *reinterpret_cast<float4*>(a.cov_o + (size_t)e * B + b0 + q) =
            *reinterpret_cast<const float4*>(s_cov + e * W + q);
    }
    for (int c = threadIdx.x; c < D * Q4; c += T) {
      const int e = c / Q4, q = 4 * (c % Q4);
      if (q < nw)
        *reinterpret_cast<float4*>(a.mean_o + (size_t)e * B + b0 + q) =
            *reinterpret_cast<const float4*>(s_mean + e * W + q);
    }
  } else if (live) {
    for (int e = s; e < DD; e += S)
      a.cov_o[(size_t)e * B + b] = s_cov[e * W + w];
    for (int e = s; e < D; e += S) a.mean_o[(size_t)e * B + b] = MEAN(e);
  }
  if (live) {
    for (int n = s; n < N; n += S)
      a.seen_o[(size_t)n * B + b] = s_seen[n * W + w];
    if (s == 0) {
      a.n_seen_o[b] = s_nseen[w];
      if (a.margins_o != nullptr) a.margins_o[b] = margin;
    }
  }
#undef COV
#undef MEAN
#undef SC
}


}  // namespace

// One tick of `B` worlds: the state (cov (D, D, B), mean (D, B), n_seen
// (B,) int32, seen (N, B) bool) in, the new state out (separate buffers),
// from twist (B, 3), zs (B, M, 2), valid (B, M) bool, ids (B, M) int32 or
// null, Q (3, 3), R (2, 2), all float32 and contiguous; margins_o (B,) or
// null. `worlds` (8) and `smem` come from the launch plan; cov,
// mean, cov_o and mean_o 16-byte aligned. Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int ekf_tick(const void* cov, const void* mean, const void* n_seen,
                        const void* seen, const void* twist, const void* zs,
                        const void* valid, const void* ids, const void* Q,
                        const void* R, void* cov_o, void* mean_o,
                        void* n_seen_o, void* seen_o, void* margins_o, int D,
                        int M, int B, int worlds, int smem, int flags,
                        float match_gate, float new_gate, void* stream) {
  if (D < 5 || D % 2 == 0 || M < 1 || B < 1 ||
      worlds != kWorlds || smem > kSmemLimit ||
      smem < smem_bytes(D, M, worlds) || ((flags & kKnown) && ids == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.cov = (const float*)cov;
  a.mean = (const float*)mean;
  a.n_seen = (const int*)n_seen;
  a.seen = (const uint8_t*)seen;
  a.twist = (const float*)twist;
  a.zs = (const float*)zs;
  a.valid = (const uint8_t*)valid;
  a.ids = (const int*)ids;
  a.Q = (const float*)Q;
  a.R = (const float*)R;
  a.cov_o = (float*)cov_o;
  a.mean_o = (float*)mean_o;
  a.n_seen_o = (int*)n_seen_o;
  a.seen_o = (uint8_t*)seen_o;
  a.margins_o = (float*)margins_o;
  a.D = D;
  a.M = M;
  a.B = B;
  a.flags = flags;
  a.match_gate = match_gate;
  a.new_gate = new_gate;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        ekf_tick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const unsigned blocks = (unsigned)((B + kWorlds - 1) / kWorlds);
  ekf_tick_kernel<<<blocks, kSlices * kWorlds, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}
