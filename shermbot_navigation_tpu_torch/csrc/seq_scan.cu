// Deferred blocked-EKF measurement scan, known or unknown association,
// for sm_90a.
//
// Replaces the TPU kernel shermbot_navigation_tpu/ops/pallas/seq_scan.py
// (deferred_seq_scan, both branches): the whole M-measurement scan of one
// tick of the deferred blocked step at map=1, batch=1.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic. The M
// measurements are a serial chain (each Kalman update reads the state the
// previous one wrote) and at batch 1 there is one robot, so there is no
// independent work to spread over the card. Per measurement the kernel
// touches O(N) strip words plus one 16N-byte grid row; at N=2048, M=8 the
// strips (~26 N words) and the op buffers (3 x 4 M N words) total about
// 0.6 MB and stay resident in L2 across the tick.
//
// Design: ONE persistent CTA of 1024 threads loops over the measurements.
// Each thread owns the lanes n = tid, tid + 1024, ... of every strip. The
// per-measurement scalars (slot choice, measurement geometry, the 2x2
// innovation inverse, the robot block update) are computed once by thread
// 0 into shared memory, with __syncthreads() between the scalar and the
// lane phases. Compared with the TPU kernel:
//   * a slot read is a direct load of index g (the TPU's masked-sum
//     _extract exists only because Mosaic has no gather; equal exactly);
//   * column g of the frozen grid is read as the contiguous row g of the
//     comp-swapped plane, as the TPU kernel does (symmetric Sigma, PARITY
//     D13), with no DMA block alignment to handle;
//   * atan2f / sinf / cosf replace the degree-9 polynomial atan2 (PARITY
//     D14); build without --use_fast_math so they stay accurate.
// Unknown association (known == 0) adds one lane pass per measurement
// before the slot choice: every thread scores its seen lanes with the
// Mahalanobis distance (psi = H5 S5 H5^T + R from mm2, rm6 and the carried
// diag4, the w-chain of the JAX _associate_comp), keeps its first lane
// under new_gate, and a warp-shuffle then shared-memory min-reduction
// finds the first such lane of the map, carrying its distance. Thread 0
// takes the match / skip / new / overflow decision from it; an overflow
// sets the sticky `stopped`, after which the tick's measurements are
// inert. The known branch's phases then run unchanged.
// Strips and op buffers live in global memory (L2-resident); the kernel
// first copies each input strip lane to its output and then works on the
// outputs in place. A later multi-CTA design is needed for N >= 8192.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxMeas = 64;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kNoHit = 0x7fffffff;

struct Params {
  const float* mean_r;    // (3,)
  const float* cov_rr;    // (3, 3)
  const int* n_seen;      // ()
  const float* mm2;       // (2, N)
  const float* rm6;       // (6, N)
  const float* diag4;     // (4, N)
  const uint8_t* seen;    // (N,) bool
  const float* mm0p;      // (4, N, N) frozen post-predict grid planes
  const float* zs;        // (M, 2)
  const uint8_t* valid;   // (M,) bool
  const int* ids;         // (M,) known association only (else unused)
  const float* R;         // (2, 2)
  float* mean_r_o;
  float* cov_rr_o;
  int* n_seen_o;
  float* mm2_o;
  float* rm6_o;
  float* diag4_o;
  uint8_t* seen_o;
  float* Kb;              // (M, 4, N)
  float* HSb;             // (M, 4, N)
  float* CRb;             // (M, 4, N)
  int* gb;                // (M,)
  int* kindb;             // (M,)
  int n;
  int m;
  int wrap_innovation;
  int symmetrize;
  int known;
  float match_gate;
  float new_gate;
};

// Scalars shared by the whole CTA. kind: 0 none / 1 update / 2 init.
struct Shared {
  float th, x, y;
  float crr[3][3];
  float R[2][2];
  int n_seen;
  int kinds[kMaxMeas];
  int gs[kMaxMeas];
  float hsg[kMaxMeas][4];   // HSb[i, :, g] for the current slot g
  float crg[kMaxMeas][4];   // CRb[i, :, g]
  int kind;
  int g;
  float h5[2][5];
  float dz0, dz1;
  float sht_r[3][2];
  float s4g[4];             // Sigma H^T comps at lane g
  float inv[2][2];
  float kr[3][2];
  float gx[2][3];
  float bown[4];
  float mnew[2];
  float cross_r[6];
  int stopped;              // unknown association: overflow stops the tick
  int red_idx[kWarps];      // per-warp first lane under new_gate
  float red_dist[kWarps];   // and its distance
};

__device__ __forceinline__ float norm_angle(float a) {
  return atan2f(sinf(a), cosf(a));
}

// Copy the input strips to the outputs (lanes of this thread); thread 0
// loads the robot state.
__device__ void load_phase(const Params& p, Shared& s, int tid, int nt) {
  const int N = p.n;
  for (int n = tid; n < N; n += nt) {
    for (int c = 0; c < 2; ++c) p.mm2_o[c * N + n] = p.mm2[c * N + n];
    for (int c = 0; c < 6; ++c) p.rm6_o[c * N + n] = p.rm6[c * N + n];
    for (int c = 0; c < 4; ++c) p.diag4_o[c * N + n] = p.diag4[c * N + n];
    p.seen_o[n] = p.seen[n];
  }
  if (tid == 0) {
    s.th = p.mean_r[0];
    s.x = p.mean_r[1];
    s.y = p.mean_r[2];
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) s.crr[i][k] = p.cov_rr[i * 3 + k];
    for (int i = 0; i < 2; ++i)
      for (int k = 0; k < 2; ++k) s.R[i][k] = p.R[i * 2 + k];
    s.n_seen = p.n_seen[0];
    s.stopped = 0;
  }
}

// Mahalanobis distance of measurement (z0, z1) to seen lane n (the
// componentwise psi of _associate_comp; no determinant floor, as there).
__device__ float lane_distance(const Params& p, const Shared& s, int n,
                               float z0, float z1) {
  const int N = p.n;
  const float dx = p.mm2_o[n] - s.x;
  const float dy = p.mm2_o[N + n] - s.y;
  const float d = fmaxf(dx * dx + dy * dy, 1e-12f);
  const float sq = sqrtf(d);
  const float a = dx / sq, b = dy / sq, c = dy / d, e = -dx / d;
  const float w[2][5] = {{0.0f, -a, -b, a, b}, {-1.0f, c, e, -c, -e}};
  float rm[6], dg[4];
  for (int k = 0; k < 6; ++k) rm[k] = p.rm6_o[k * N + n];
  for (int k = 0; k < 4; ++k) dg[k] = p.diag4_o[k * N + n];
  float psi[2][2];
  for (int l = 0; l < 2; ++l) {
    const float* wl = w[l];
    float u[5];
    for (int k = 0; k < 3; ++k)
      u[k] = s.crr[k][0] * wl[0] + s.crr[k][1] * wl[1] + s.crr[k][2] * wl[2] +
             rm[k * 2 + 0] * wl[3] + rm[k * 2 + 1] * wl[4];
    for (int q = 0; q < 2; ++q)
      u[3 + q] = rm[0 + q] * wl[0] + rm[2 + q] * wl[1] + rm[4 + q] * wl[2] +
                 dg[q * 2 + 0] * wl[3] + dg[q * 2 + 1] * wl[4];
    for (int q = 0; q < 2; ++q) {
      const float* wp = w[q];
      psi[q][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2] +
                   wp[3] * u[3] + wp[4] * u[4]) + s.R[q][l];
    }
  }
  const float det = psi[0][0] * psi[1][1] - psi[0][1] * psi[1][0];
  const float dz0 = z0 - sq;
  float dz1 = z1 - norm_angle(atan2f(dy, dx) - s.th);
  if (p.wrap_innovation) dz1 = norm_angle(dz1);
  return (dz0 * (psi[1][1] * dz0 - psi[0][1] * dz1) +
          dz1 * (-psi[1][0] * dz0 + psi[0][0] * dz1)) / det;
}

// All threads (unknown association, active measurement): each thread's
// first seen lane with distance < new_gate, then the warp's first, into
// shared memory (red_idx = kNoHit where none).
__device__ void assoc_lane_phase(const Params& p, Shared& s, int j, int tid,
                                 int nt) {
  const float z0 = p.zs[j * 2 + 0], z1 = p.zs[j * 2 + 1];
  int best = kNoHit;
  float best_d = 0.0f;
  for (int n = tid; n < p.n; n += nt) {
    if (!p.seen_o[n]) continue;
    const float dist = lane_distance(p, s, n, z0, z1);
    if (dist < p.new_gate) {   // lanes rise, so the first hit is the least
      best = n;
      best_d = dist;
      break;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int oi = __shfl_down_sync(0xffffffffu, best, off);
    const float od = __shfl_down_sync(0xffffffffu, best_d, off);
    if (oi < best) {
      best = oi;
      best_d = od;
    }
  }
  if ((tid & 31) == 0) {
    s.red_idx[tid >> 5] = best;
    s.red_dist[tid >> 5] = best_d;
  }
}

// Thread 0: the unknown-association decision (blocked_ekf.py:756-772) from
// the warps' first hits. Sets s.g and s.kind; overflow sets s.stopped.
__device__ void assoc_decide(const Params& p, Shared& s, bool act, int nw) {
  const int N = p.n;
  int first = kNoHit;
  float d_first = 0.0f;
  if (act)
    for (int w = 0; w < nw; ++w)
      if (s.red_idx[w] < first) {
        first = s.red_idx[w];
        d_first = s.red_dist[w];
      }
  const bool any_hit = first < kNoHit;
  const bool no_seen = s.n_seen == 0;
  const bool cap_full = s.n_seen >= N;
  const bool is_match = act && !no_seen && any_hit && d_first < p.match_gate;
  const bool want_new = act && (no_seen || !any_hit);
  const int new_slot = s.n_seen < N - 1 ? s.n_seen : N - 1;
  s.g = is_match ? first : new_slot;
  s.kind = is_match ? 1 : (want_new && !cap_full ? 2 : 0);
  if (want_new && cap_full) s.stopped = 1;
}

// Thread 0: slot choice (known ids here; unknown association decided by
// assoc_decide before), geometry, and the scalars of whichever branch this
// measurement takes.
__device__ void scalar_phase_a(const Params& p, Shared& s, int j) {
  const int N = p.n;
  if (p.known) {
    const int id = p.ids[j];
    // out-of-range id -> full no-op (no phantom n_seen bump), the rule of
    // the XLA scan and the TPU kernel
    const bool in_range = id >= 0 && id < N;
    const bool v = p.valid[j] != 0 && in_range;
    const int g = id < 0 ? 0 : (id >= N ? N - 1 : id);
    s.g = g;
    s.kind = !v ? 0 : (p.seen_o[g] != 0 ? 1 : 2);
  }
  if (s.kind == 0) return;
  const int g = s.g;

  const float th = s.th, x = s.x, y = s.y;
  const float z0 = p.zs[j * 2 + 0], z1 = p.zs[j * 2 + 1];
  if (s.kind == 1) {
    // measurement geometry off the sequential means (_h5_coeffs)
    const float dx = p.mm2_o[g] - x;
    const float dy = p.mm2_o[N + g] - y;
    const float d = fmaxf(dx * dx + dy * dy, 1e-12f);
    const float sq = sqrtf(d);
    const float h[2][5] = {{0.0f, -dx / sq, -dy / sq, dx / sq, dy / sq},
                           {-1.0f, dy / d, -dx / d, -dy / d, dx / d}};
    for (int q = 0; q < 2; ++q)
      for (int k = 0; k < 5; ++k) s.h5[q][k] = h[q][k];
    const float zhat1 = norm_angle(atan2f(dy, dx) - th);
    s.dz0 = z0 - sq;
    float dz1 = z1 - zhat1;
    if (p.wrap_innovation) dz1 = norm_angle(dz1);
    s.dz1 = dz1;
    // Sigma H^T robot rows: [cov_rr | cov_rm[:, g]] H5^T
    for (int i = 0; i < 3; ++i) {
      const float r0 = p.rm6_o[(i * 2 + 0) * N + g];
      const float r1 = p.rm6_o[(i * 2 + 1) * N + g];
      for (int q = 0; q < 2; ++q)
        s.sht_r[i][q] = s.crr[i][0] * h[q][0] + s.crr[i][1] * h[q][1] +
                        s.crr[i][2] * h[q][2] + r0 * h[q][3] + r1 * h[q][4];
    }
    // column-g packets of the tick's earlier ops, for the replay
    for (int i = 0; i < j; ++i)
      for (int c = 0; c < 4; ++c) {
        s.hsg[i][c] = p.HSb[((size_t)i * 4 + c) * N + g];
        s.crg[i][c] = p.CRb[((size_t)i * 4 + c) * N + g];
      }
  } else {
    // analytic first-observation init of slot g
    const float a = z1 + th;
    const float r = z0;
    const float sa = sinf(a), ca = cosf(a);
    s.mnew[0] = x + r * ca;
    s.mnew[1] = y + r * sa;
    const float gx[2][3] = {{-r * sa, 1.0f, 0.0f}, {r * ca, 0.0f, 1.0f}};
    const float gz[2][2] = {{ca, -r * sa}, {sa, r * ca}};
    float gs[2][3];   // Gx cov_rr
    float gr[2][2];   // Gz R
    for (int q = 0; q < 2; ++q) {
      for (int k = 0; k < 3; ++k) {
        s.gx[q][k] = gx[q][k];
        gs[q][k] = gx[q][0] * s.crr[0][k] + gx[q][1] * s.crr[1][k] +
                   gx[q][2] * s.crr[2][k];
      }
      for (int k = 0; k < 2; ++k)
        gr[q][k] = gz[q][0] * s.R[0][k] + gz[q][1] * s.R[1][k];
    }
    // B_own = Gx Srr Gx^T + Gz R Gz^T
    for (int q = 0; q < 2; ++q)
      for (int t = 0; t < 2; ++t)
        s.bown[q * 2 + t] =
            (gs[q][0] * gx[t][0] + gs[q][1] * gx[t][1] + gs[q][2] * gx[t][2]) +
            (gr[q][0] * gz[t][0] + gr[q][1] * gz[t][1]);
    // cross_r = (Gx Srr)^T, stored as rm6 comps [i*2+p]
    for (int i = 0; i < 3; ++i)
      for (int q = 0; q < 2; ++q) s.cross_r[i * 2 + q] = gs[q][i];
  }
}

// All threads (update only): grid column g after the tick's earlier ops,
// then the Sigma H^T strip s4, written to HSb[j] and, at lane g, to shared.
__device__ void lane_phase_b1(const Params& p, Shared& s, int j, int tid,
                              int nt) {
  const int N = p.n;
  const int g = s.g;
  const int swap[4] = {0, 2, 1, 3};   // comp (p, q) <- plane (q, p)
  for (int n = tid; n < N; n += nt) {
    float col[4];
    for (int c = 0; c < 4; ++c)
      col[c] = p.mm0p[((size_t)swap[c] * N + g) * N + n];
    for (int i = 0; i < j; ++i) {
      const int k = s.kinds[i];
      if (k == 1) {
        const float k0 = p.Kb[((size_t)i * 4 + 0) * N + n];
        const float k1 = p.Kb[((size_t)i * 4 + 1) * N + n];
        const float k2 = p.Kb[((size_t)i * 4 + 2) * N + n];
        const float k3 = p.Kb[((size_t)i * 4 + 3) * N + n];
        const float* h = s.hsg[i];
        col[0] = col[0] - (k0 * h[0] + k1 * h[1]);
        col[1] = col[1] - (k0 * h[2] + k1 * h[3]);
        col[2] = col[2] - (k2 * h[0] + k3 * h[1]);
        col[3] = col[3] - (k2 * h[2] + k3 * h[3]);
      } else if (k == 2) {
        const int si = s.gs[i];
        if (si == g) {
          // whole column <- the init's cross strip, comps swapped
          for (int c = 0; c < 4; ++c)
            col[c] = p.CRb[((size_t)i * 4 + swap[c]) * N + n];
        } else if (n == si) {
          for (int c = 0; c < 4; ++c) col[c] = s.crg[i][c];
        }
      }
    }
    for (int pp = 0; pp < 2; ++pp)
      for (int q = 0; q < 2; ++q) {
        const float* h = s.h5[q];
        const float v = p.rm6_o[(0 + pp) * N + n] * h[0] +
                        p.rm6_o[(2 + pp) * N + n] * h[1] +
                        p.rm6_o[(4 + pp) * N + n] * h[2] +
                        col[pp * 2 + 0] * h[3] + col[pp * 2 + 1] * h[4];
        p.HSb[((size_t)j * 4 + pp * 2 + q) * N + n] = v;
        if (n == g) s.s4g[pp * 2 + q] = v;
      }
  }
}

// Thread 0: innovation covariance, gain rows of the robot block, the
// robot mean / covariance update, the op record.
__device__ void scalar_phase_a2(const Params& p, Shared& s, int j) {
  const int kind = s.kind;
  s.kinds[j] = kind;
  s.gs[j] = s.g;
  p.kindb[j] = kind;
  p.gb[j] = kind > 0 ? s.g : -1;
  if (kind == 2) {
    s.n_seen += 1;
    return;
  }
  if (kind != 1) return;
  float psi[2][2];
  for (int q = 0; q < 2; ++q)
    for (int r = 0; r < 2; ++r)
      psi[q][r] = s.h5[q][0] * s.sht_r[0][r] + s.h5[q][1] * s.sht_r[1][r] +
                  s.h5[q][2] * s.sht_r[2][r] + s.h5[q][3] * s.s4g[0 * 2 + r] +
                  s.h5[q][4] * s.s4g[1 * 2 + r] + s.R[q][r];
  float det = psi[0][0] * psi[1][1] - psi[0][1] * psi[1][0];
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  s.inv[0][0] = psi[1][1] / det;
  s.inv[0][1] = -psi[0][1] / det;
  s.inv[1][0] = -psi[1][0] / det;
  s.inv[1][1] = psi[0][0] / det;
  for (int i = 0; i < 3; ++i)
    for (int r = 0; r < 2; ++r)
      s.kr[i][r] = s.sht_r[i][0] * s.inv[0][r] + s.sht_r[i][1] * s.inv[1][r];
  const float dz0 = s.dz0, dz1 = s.dz1;
  s.th = norm_angle(s.th + (s.kr[0][0] * dz0 + s.kr[0][1] * dz1));
  s.x = s.x + (s.kr[1][0] * dz0 + s.kr[1][1] * dz1);
  s.y = s.y + (s.kr[2][0] * dz0 + s.kr[2][1] * dz1);
  float c[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      c[i][k] = s.crr[i][k] -
                (s.kr[i][0] * s.sht_r[k][0] + s.kr[i][1] * s.sht_r[k][1]);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      s.crr[i][k] = p.symmetrize ? 0.5f * (c[i][k] + c[k][i]) : c[i][k];
}

// All threads: the strip updates of this measurement's branch and its
// op-buffer rows (zeros where the branch does not record).
__device__ void lane_phase_b2(const Params& p, Shared& s, int j, int tid,
                              int nt) {
  const int N = p.n;
  const int kind = s.kind;
  const int g = s.g;
  float* kb = p.Kb + (size_t)j * 4 * N;
  float* hb = p.HSb + (size_t)j * 4 * N;
  float* cb = p.CRb + (size_t)j * 4 * N;
  for (int n = tid; n < N; n += nt) {
    if (kind == 1) {
      float s4[4], k4[4];
      for (int c = 0; c < 4; ++c) s4[c] = hb[c * N + n];
      for (int pp = 0; pp < 2; ++pp)
        for (int r = 0; r < 2; ++r)
          k4[pp * 2 + r] =
              s4[pp * 2 + 0] * s.inv[0][r] + s4[pp * 2 + 1] * s.inv[1][r];
      p.mm2_o[n] = p.mm2_o[n] + (k4[0] * s.dz0 + k4[1] * s.dz1);
      p.mm2_o[N + n] = p.mm2_o[N + n] + (k4[2] * s.dz0 + k4[3] * s.dz1);
      for (int i = 0; i < 3; ++i)
        for (int pp = 0; pp < 2; ++pp) {
          float* rm = p.rm6_o + (i * 2 + pp) * N + n;
          *rm = *rm - (s.kr[i][0] * s4[pp * 2 + 0] +
                       s.kr[i][1] * s4[pp * 2 + 1]);
        }
      for (int pp = 0; pp < 2; ++pp)
        for (int r = 0; r < 2; ++r) {
          float* dg = p.diag4_o + (pp * 2 + r) * N + n;
          *dg = *dg - (k4[pp * 2 + 0] * s4[r * 2 + 0] +
                       k4[pp * 2 + 1] * s4[r * 2 + 1]);
        }
      for (int c = 0; c < 4; ++c) {
        kb[c * N + n] = k4[c];
        cb[c * N + n] = 0.0f;
      }
    } else if (kind == 2) {
      // local column of the init cross strip Gx Sigma_{r, m_n}, own
      // column pre-patched with B_own
      float cross[4];
      for (int pp = 0; pp < 2; ++pp)
        for (int q = 0; q < 2; ++q)
          cross[pp * 2 + q] = s.gx[pp][0] * p.rm6_o[(0 + q) * N + n] +
                              s.gx[pp][1] * p.rm6_o[(2 + q) * N + n] +
                              s.gx[pp][2] * p.rm6_o[(4 + q) * N + n];
      if (n == g) {
        for (int c = 0; c < 4; ++c) {
          cross[c] = s.bown[c];
          p.diag4_o[c * N + n] = s.bown[c];
        }
        p.mm2_o[n] = s.mnew[0];
        p.mm2_o[N + n] = s.mnew[1];
        for (int c = 0; c < 6; ++c) p.rm6_o[c * N + n] = s.cross_r[c];
        p.seen_o[n] = 1;
      }
      for (int c = 0; c < 4; ++c) {
        kb[c * N + n] = 0.0f;
        hb[c * N + n] = 0.0f;
        cb[c * N + n] = cross[c];
      }
    } else {
      for (int c = 0; c < 4; ++c) {
        kb[c * N + n] = 0.0f;
        hb[c * N + n] = 0.0f;
        cb[c * N + n] = 0.0f;
      }
    }
  }
}

__device__ void store_phase(const Params& p, const Shared& s) {
  p.mean_r_o[0] = s.th;
  p.mean_r_o[1] = s.x;
  p.mean_r_o[2] = s.y;
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) p.cov_rr_o[i * 3 + k] = s.crr[i][k];
  p.n_seen_o[0] = s.n_seen;
}

__global__ void __launch_bounds__(kThreads)
seq_scan_kernel(Params p) {
  __shared__ Shared s;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  load_phase(p, s, tid, nt);
  __syncthreads();
  for (int j = 0; j < p.m; ++j) {
    if (!p.known) {
      // uniform across the block: s.stopped changed before the last sync
      const bool act = p.valid[j] != 0 && !s.stopped;
      if (act) assoc_lane_phase(p, s, j, tid, nt);
      __syncthreads();
      if (tid == 0) assoc_decide(p, s, act, nt >> 5);
    }
    if (tid == 0) scalar_phase_a(p, s, j);
    __syncthreads();
    if (s.kind == 1) lane_phase_b1(p, s, j, tid, nt);
    __syncthreads();
    if (tid == 0) scalar_phase_a2(p, s, j);
    __syncthreads();
    lane_phase_b2(p, s, j, tid, nt);
    __syncthreads();
  }
  if (tid == 0) store_phase(p, s);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). `ids` may be
// null when known == 0.
extern "C" int seq_scan(
    const void* mean_r, const void* cov_rr, const void* n_seen,
    const void* mm2, const void* rm6, const void* diag4, const void* seen,
    const void* mm0p, const void* zs, const void* valid, const void* ids,
    const void* R, void* mean_r_o, void* cov_rr_o, void* n_seen_o,
    void* mm2_o, void* rm6_o, void* diag4_o, void* seen_o, void* Kb,
    void* HSb, void* CRb, void* gb, void* kindb, int n, int m,
    int wrap_innovation, int symmetrize, int known, float match_gate,
    float new_gate, void* stream) {
  if (n <= 0 || m <= 0 || m > kMaxMeas || (known && ids == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.mean_r = (const float*)mean_r;
  p.cov_rr = (const float*)cov_rr;
  p.n_seen = (const int*)n_seen;
  p.mm2 = (const float*)mm2;
  p.rm6 = (const float*)rm6;
  p.diag4 = (const float*)diag4;
  p.seen = (const uint8_t*)seen;
  p.mm0p = (const float*)mm0p;
  p.zs = (const float*)zs;
  p.valid = (const uint8_t*)valid;
  p.ids = (const int*)ids;
  p.R = (const float*)R;
  p.mean_r_o = (float*)mean_r_o;
  p.cov_rr_o = (float*)cov_rr_o;
  p.n_seen_o = (int*)n_seen_o;
  p.mm2_o = (float*)mm2_o;
  p.rm6_o = (float*)rm6_o;
  p.diag4_o = (float*)diag4_o;
  p.seen_o = (uint8_t*)seen_o;
  p.Kb = (float*)Kb;
  p.HSb = (float*)HSb;
  p.CRb = (float*)CRb;
  p.gb = (int*)gb;
  p.kindb = (int*)kindb;
  p.n = n;
  p.m = m;
  p.wrap_innovation = wrap_innovation;
  p.symmetrize = symmetrize;
  p.known = known;
  p.match_gate = match_gate;
  p.new_gate = new_gate;
  seq_scan_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
