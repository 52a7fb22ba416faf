// Deferred blocked-EKF measurement scan, known or unknown association,
// for sm_90a.
//
// Replaces the TPU kernel shermbot_navigation_tpu/ops/pallas/seq_scan.py
// (deferred_seq_scan, both branches): the whole M-measurement scan of one
// tick of the deferred blocked step at map=1, for B worlds in one launch.
//
// What bounds it on an H100: latency, not bandwidth or arithmetic. The M
// measurements are a serial chain (each Kalman update reads the state the
// previous one wrote) in each world. A measurement costs its barriers, one
// exchange of slot g's values between the thread that owns lane g and
// everyone else, and a chain of scalar arithmetic (two atan2f, sinf/cosf
// pairs, eight divisions); the bytes (26 N strip words, M rows of 16 N
// bytes, 12 M N words of op history out) would take under a microsecond.
//
// Design. The TPU kernel's point was to keep every strip in fast memory
// for the whole chain; here that memory is the registers and shared memory
// of the CTAs of ONE THREAD-BLOCK CLUSTER.
//   * Lanes are split over the cluster: CTA c owns lanes [c P, (c+1) P),
//     thread t of it the lanes c P + t + k T (k < L). A thread loads its
//     lanes of mm2, rm6, diag4 and seen once, keeps them in registers
//     through all M measurements and stores them once at the end. The
//     robot state (pose, cov_rr, n_seen, stopped) is replicated in every
//     thread's registers.
//   * No lone thread: every thread computes the measurement's scalars
//     (geometry, innovation inverse, robot update) itself, from the same
//     inputs with the same instructions, so every copy has the same bits
//     and no barrier fences a scalar phase.
//   * The op history a thread needs back (its own lanes of Kb, or of CRb
//     for an init) stays in shared memory where it fits (16 M bytes a
//     lane), else it is read back from the thread's own writes to Kb/CRb
//     in global memory (large M x N only; same thread, so no fence).
//   * Slot g's strip values and the column-g packets HSb[i, :, g] of the
//     tick's earlier updates are published by the owner of lane g: its
//     warp pushes them into every CTA's shared memory through distributed
//     shared memory, so after the barrier every thread reads them
//     locally. The packets are the owner's own earlier writes, read back
//     from global memory by its warp, a lane an op, in one round trip to
//     L2 (the one read-back the design keeps: they depend on g, which
//     with unknown association is not known before). CRb[i, :, g] is
//     needed by one lane only (n == slot of init i) and that lane reads
//     it from global memory after the barrier.
//   * Row g of the four frozen planes (column g by symmetry, PARITY D13)
//     arrives through cp.async into a shared-memory ring, each thread
//     copying exactly the words it will consume (4-byte copies, so any N
//     and any alignment take the same path, and only the thread's own
//     wait_group orders them). Known association: the rows of the next
//     `ring` measurements are in flight before this one's arithmetic; an
//     invalid or out-of-range id requests nothing. Unknown: the row is
//     requested at the decision and lands behind the exchange and the
//     geometry.
//   * Barriers a measurement: 2 with known association -- (1) slot g's
//     values pushed, (2) s4 at lane g pushed by its owner -- and 3 with
//     unknown, which first reduces the first lane under new_gate: an
//     integer minimum of (lane << 1 | not-under-match-gate) by warp
//     shuffles, a shared-memory atomicMin a warp, and one atomicMin a
//     CTA into every other CTA (behind a CTA-local __syncthreads()).
//     With a cluster of 1 the barriers are __syncthreads(), else
//     cluster.sync() (about 0.5 us each on an H100, ten times a
//     __syncthreads(): the price of spreading the replicated scalar chain
//     and the lane work over more SMs, which pays from N = 2048 on);
//     none sits under a condition that differs across the cluster.
//   * Every output is the same for every cluster size, bit for bit: all
//     arithmetic is lane-local or replicated and the one reduction is an
//     integer minimum.
//   * B worlds: the launch grid is (cluster, B) with clusters of
//     (cluster, 1, 1), so cluster y of the grid is world y and blockIdx.y
//     picks its slab of every operand and output (R is shared). Clusters
//     never talk to each other, so a world's outputs do not depend on B
//     (the JAX package runs its XLA scan under vmap there: the same
//     function). Where B clusters of the default size cannot be resident
//     at once, launch_plan may take a smaller cluster.
// Kept from the first port: a slot read is a direct read of index g;
// atan2f / sinf / cosf (build without --use_fast_math); an out-of-range id
// is a full no-op; the clamped new slot; the sticky `stopped`.
// The launch plan (cluster size, threads, lanes a thread, ring depth,
// where the history lives) is computed by ops/kernels/seq_scan.py.
// Beside the kernel: a clocked instance of it (template flag CLOCK, for
// the plans of 1 and 2 lanes a thread) that records where a measurement's
// cycles go, and a probe kernel that times the chain's pieces apart from
// it (the barrier, a dependent read, an update's scalar arithmetic).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxMeas = 64;
constexpr int kNoHit = 0x7fffffff;

struct Params {
  const float* __restrict__ mean_r;    // (3,)
  const float* __restrict__ cov_rr;    // (3, 3)
  const int* __restrict__ n_seen;      // ()
  const float* __restrict__ mm2;       // (2, N)
  const float* __restrict__ rm6;       // (6, N)
  const float* __restrict__ diag4;     // (4, N)
  const uint8_t* __restrict__ seen;    // (N,) bool
  const float* __restrict__ mm0p;      // (4, N, N) frozen grid planes
  const float* __restrict__ zs;        // (M, 2)
  const uint8_t* __restrict__ valid;   // (M,) bool
  const int* __restrict__ ids;         // (M,) known association only
  const float* __restrict__ R;         // (2, 2)
  float* __restrict__ mean_r_o;
  float* __restrict__ cov_rr_o;
  int* __restrict__ n_seen_o;
  float* __restrict__ mm2_o;
  float* __restrict__ rm6_o;
  float* __restrict__ diag4_o;
  uint8_t* __restrict__ seen_o;
  float* Kb;                           // (M, 4, N)  written, and read back
  float* HSb;                          // (M, 4, N)  by the writer only
  float* CRb;                          // (M, 4, N)
  int* __restrict__ gb;                // (M,)
  int* __restrict__ kindb;             // (M,)
  int n;
  int m;
  int wrap_innovation;
  int symmetrize;
  int known;
  float match_gate;
  float new_gate;
  int cluster;     // CTAs in the cluster
  int per_cta;     // P: lanes a CTA owns
  int ring;        // row ring depth (1, 2 or 4)
  int hist_smem;   // op history in shared memory (else read back)
  long long* stamps;   // (M, 8) clock64() at the phase ends, or null
};

// Per-CTA shared state. kind: 0 none / 1 update / 2 init.
struct Shared {
  float4 pkt[3 + kMaxMeas];   // slot g's strips, then HSb[i, :, g]
  float4 s4g;                 // Sigma H^T comps at lane g
  float zs[kMaxMeas][2];
  int slot[kMaxMeas];         // known: clamped id
  int ok[kMaxMeas];           // valid (known: and id in range)
  int gs[kMaxMeas];          // slot of op i
  int first[kMaxMeas];        // first-hit key of measurement j
};

__device__ __forceinline__ float norm_angle(float a) {
  return atan2f(sinf(a), cosf(a));
}

__device__ __forceinline__ void cp_async4(const float* smem_dst,
                                          const float* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// Robot state, replicated in every thread.
struct Robot {
  float th, x, y;
  float crr[3][3];
  float R[2][2];
  int n_seen;
  int stopped;
};

// Mahalanobis distance of measurement (z0, z1) to a seen lane with means
// mm, robot cross covariance rm and own block dg (the componentwise psi of
// _associate_comp; no determinant floor, as there).
__device__ __forceinline__ float lane_distance(const Robot& rb,
                                               const float* mm,
                                               const float* rm,
                                               const float* dg, float z0,
                                               float z1, int wrap) {
  const float dx = mm[0] - rb.x;
  const float dy = mm[1] - rb.y;
  const float d = fmaxf(dx * dx + dy * dy, 1e-12f);
  const float sq = sqrtf(d);
  const float a = dx / sq, b = dy / sq, c = dy / d, e = -dx / d;
  const float w[2][5] = {{0.0f, -a, -b, a, b}, {-1.0f, c, e, -c, -e}};
  float psi[2][2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const float* wl = w[l];
    float u[5];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      u[k] = rb.crr[k][0] * wl[0] + rb.crr[k][1] * wl[1] +
             rb.crr[k][2] * wl[2] + rm[k * 2 + 0] * wl[3] +
             rm[k * 2 + 1] * wl[4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      u[3 + q] = rm[0 + q] * wl[0] + rm[2 + q] * wl[1] + rm[4 + q] * wl[2] +
                 dg[q * 2 + 0] * wl[3] + dg[q * 2 + 1] * wl[4];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* wp = w[q];
      psi[q][l] = (wp[0] * u[0] + wp[1] * u[1] + wp[2] * u[2] +
                   wp[3] * u[3] + wp[4] * u[4]) + rb.R[q][l];
    }
  }
  const float det = psi[0][0] * psi[1][1] - psi[0][1] * psi[1][0];
  const float dz0 = z0 - sq;
  float dz1 = z1 - norm_angle(atan2f(dy, dx) - rb.th);
  if (wrap) dz1 = norm_angle(dz1);
  return (dz0 * (psi[1][1] * dz0 - psi[0][1] * dz1) +
          dz1 * (-psi[1][0] * dz0 + psi[0][0] * dz1)) / det;
}

// An update's scalars off the sequential means (_h5_coeffs): the measurement
// Jacobian's coefficients, the innovation, and the robot rows of Sigma H^T,
// [cov_rr | cov_rm[:, g]] H5^T.
struct Geometry {
  float h5[2][5];
  float dz0, dz1;
  float sht_r[3][2];
};

// a0 = (mean of slot g, seen, -), a1 and a2 = its six rm6 words: the
// packet the owner of lane g published.
__device__ __forceinline__ void measurement_geometry(
    const Robot& rb, const float4 a0, const float4 a1, const float4 a2,
    float z0, float z1, int wrap, Geometry& ge) {
  const float rmg[6] = {a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
  const float dx = a0.x - rb.x;
  const float dy = a0.y - rb.y;
  const float d = fmaxf(dx * dx + dy * dy, 1e-12f);
  const float sq = sqrtf(d);
  const float h[2][5] = {{0.0f, -dx / sq, -dy / sq, dx / sq, dy / sq},
                         {-1.0f, dy / d, -dx / d, -dy / d, dx / d}};
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int k = 0; k < 5; ++k) ge.h5[q][k] = h[q][k];
  const float zhat1 = norm_angle(atan2f(dy, dx) - rb.th);
  ge.dz0 = z0 - sq;
  ge.dz1 = z1 - zhat1;
  if (wrap) ge.dz1 = norm_angle(ge.dz1);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      ge.sht_r[i][q] = rb.crr[i][0] * h[q][0] + rb.crr[i][1] * h[q][1] +
                       rb.crr[i][2] * h[q][2] + rmg[i * 2 + 0] * h[q][3] +
                       rmg[i * 2 + 1] * h[q][4];
}

// The innovation covariance from Sigma H^T at lane g (sg), its inverse
// `inv`, the gain rows `kr` of the robot block, and the robot's mean and
// covariance update.
__device__ __forceinline__ void robot_update(Robot& rb, const Geometry& ge,
                                             const float4 sg, int symmetrize,
                                             float inv[2][2],
                                             float kr[3][2]) {
  const float s4g[4] = {sg.x, sg.y, sg.z, sg.w};
  float psi[2][2];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      psi[q][r] = ge.h5[q][0] * ge.sht_r[0][r] + ge.h5[q][1] * ge.sht_r[1][r] +
                  ge.h5[q][2] * ge.sht_r[2][r] + ge.h5[q][3] * s4g[0 * 2 + r] +
                  ge.h5[q][4] * s4g[1 * 2 + r] + rb.R[q][r];
  float det = psi[0][0] * psi[1][1] - psi[0][1] * psi[1][0];
  if (fabsf(det) < 1e-30f) det = 1e-30f;
  inv[0][0] = psi[1][1] / det;
  inv[0][1] = -psi[0][1] / det;
  inv[1][0] = -psi[1][0] / det;
  inv[1][1] = psi[0][0] / det;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      kr[i][r] = ge.sht_r[i][0] * inv[0][r] + ge.sht_r[i][1] * inv[1][r];
  rb.th = norm_angle(rb.th + (kr[0][0] * ge.dz0 + kr[0][1] * ge.dz1));
  rb.x = rb.x + (kr[1][0] * ge.dz0 + kr[1][1] * ge.dz1);
  rb.y = rb.y + (kr[2][0] * ge.dz0 + kr[2][1] * ge.dz1);
  float cc[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      cc[i][k] = rb.crr[i][k] -
                 (kr[i][0] * ge.sht_r[k][0] + kr[i][1] * ge.sht_r[k][1]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rb.crr[i][k] = symmetrize ? 0.5f * (cc[i][k] + cc[k][i]) : cc[i][k];
}

// CLOCK: the instance that also records the SM clock at the phase ends of
// every measurement (Params.stamps); the serving path runs the other.
template <int L, int TMAX, bool CLOCK>
__global__ void __launch_bounds__(TMAX) seq_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster;
  const int rank = C == 1 ? 0 : (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int PL = T * L;            // lane slots of this CTA
  const int N = p.n;
  const int M = p.m;
  const int P = p.per_cta;
  const int D = p.ring;
  const bool known = p.known != 0;
  const bool hist_smem = p.hist_smem != 0;
  // this cluster's world: the slabs of the operands read or written
  // inside the measurement loop (the others are offset where used)
  const size_t world = blockIdx.y;
  const float* const mm0p = p.mm0p + world * 4 * (size_t)N * N;
  float* const Kb = p.Kb + world * 4 * (size_t)M * N;
  float* const HSb = p.HSb + world * 4 * (size_t)M * N;
  float* const CRb = p.CRb + world * 4 * (size_t)M * N;
  float* const ring = dyn;                       // [D][4][PL]
  float* const hist = dyn + (size_t)D * 4 * PL;  // [M][4][PL]
  const int swap[4] = {0, 2, 1, 3};   // comp (p, q) <- plane (q, p)

  // ---- the tick's inputs, the robot, this thread's lanes ----
  for (int j = tid; j < M; j += T) {
    s.zs[j][0] = p.zs[(world * M + j) * 2 + 0];
    s.zs[j][1] = p.zs[(world * M + j) * 2 + 1];
    int ok = p.valid[world * M + j] != 0;
    int g = 0;
    if (known) {
      // out-of-range id -> full no-op (no phantom n_seen bump), the rule
      // of the XLA scan and the TPU kernel
      const int id = p.ids[world * M + j];
      ok = ok && id >= 0 && id < N;
      g = id < 0 ? 0 : (id >= N ? N - 1 : id);
    }
    s.slot[j] = g;
    s.ok[j] = ok;
    s.first[j] = kNoHit;
  }
  Robot rb;
  rb.th = p.mean_r[world * 3 + 0];
  rb.x = p.mean_r[world * 3 + 1];
  rb.y = p.mean_r[world * 3 + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rb.crr[i][k] = p.cov_rr[world * 9 + i * 3 + k];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k) rb.R[i][k] = p.R[i * 2 + k];
  rb.n_seen = p.n_seen[world];
  rb.stopped = 0;
  // kinds of the tick's ops so far, replicated like the robot
  uint64_t upd = 0, ini = 0;

  int ln[L];          // global lane, or -1 for an empty slot
  float mm[L][2], rm[L][6], dg[L][4];
  bool sn[L];
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const int local = k * T + tid;
    const int n = rank * P + local;
    ln[k] = (local < P && n < N) ? n : -1;
    sn[k] = false;
    if (ln[k] >= 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c) mm[k][c] = p.mm2[(world * 2 + c) * N + n];
#pragma unroll
      for (int c = 0; c < 6; ++c) rm[k][c] = p.rm6[(world * 6 + c) * N + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) dg[k][c] = p.diag4[(world * 4 + c) * N + n];
      sn[k] = p.seen[world * N + n] != 0;
    } else {
#pragma unroll
      for (int c = 0; c < 2; ++c) mm[k][c] = 0.0f;
#pragma unroll
      for (int c = 0; c < 6; ++c) rm[k][c] = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) dg[k][c] = 0.0f;
    }
  }

  // request row g of the four planes into ring slot `slot`: this thread's
  // own lanes only
  auto request_row = [&](int g, int slot) {
#pragma unroll
    for (int k = 0; k < L; ++k)
      if (ln[k] >= 0) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cp_async4(ring + ((size_t)slot * 4 + c) * PL + k * T + tid,
                    mm0p + ((size_t)c * N + g) * N + ln[k]);
      }
  };
  auto sync_all = [&]() {
    if (C == 1)
      __syncthreads();
    else
      cluster.sync();
  };

  // thread 0 of CTA 0 records where measurement j's time goes: stamp 0 its
  // start, 1 association done, 2 slot g pushed, 3 barrier 1 passed,
  // 4 geometry done, 5 first lane pass done, 6 barrier 2 passed, 7 its end
  auto stamp = [&](int j, int k) {
    if constexpr (CLOCK) {
      if (tid == 0 && rank == 0) p.stamps[j * 8 + k] = clock64();
    }
  };

  sync_all();   // inputs staged; every CTA's shared memory initialized
  if (known) {
    for (int jj = 0; jj < D; ++jj) {
      if (jj < M && s.ok[jj]) request_row(s.slot[jj], jj);
      cp_async_commit();
    }
  }

  for (int j = 0; j < M; ++j) {
    const float z0 = s.zs[j][0], z1 = s.zs[j][1];
    int g, kind;
    stamp(j, 0);
    if (!known) {
      // ---- first lane under new_gate, over the whole map ----
      const bool act = s.ok[j] && !rb.stopped;
      if (act) {
        int key = kNoHit;
#pragma unroll
        for (int k = L - 1; k >= 0; --k)
          if (ln[k] >= 0 && sn[k]) {
            const float dist = lane_distance(rb, mm[k], rm[k], dg[k], z0, z1,
                                             p.wrap_innovation);
            if (dist < p.new_gate)   // descending k: the least lane stays
              key = ln[k] * 2 + (dist < p.match_gate ? 0 : 1);
          }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
        if ((tid & 31) == 0 && key != kNoHit) atomicMin(&s.first[j], key);
        if (C > 1) {
          // this CTA's minimum, pushed into every other CTA's cell
          __syncthreads();
          const int mine = s.first[j];
          if (tid < C && tid != rank && mine != kNoHit)
            atomicMin(cluster.map_shared_rank(&s.first[j], tid), mine);
        }
      }
      sync_all();   // barrier U: the minimum is complete in every CTA
      const int key = act ? s.first[j] : kNoHit;
      // the decision (blocked_ekf.py:756-772 of the JAX package)
      const bool any_hit = key != kNoHit;
      const bool no_seen = rb.n_seen == 0;
      const bool cap_full = rb.n_seen >= N;
      const bool is_match = act && !no_seen && any_hit && (key & 1) == 0;
      const bool want_new = act && (no_seen || !any_hit);
      const int new_slot = rb.n_seen < N - 1 ? rb.n_seen : N - 1;
      g = is_match ? (key >> 1) : new_slot;
      kind = is_match ? 1 : (want_new && !cap_full ? 2 : 0);
      if (want_new && cap_full) rb.stopped = 1;
      if (kind == 1) request_row(g, 0);
      cp_async_commit();
    } else {
      g = s.slot[j];
      kind = s.ok[j] ? 1 : 0;   // 1 or 2: decided by seen[g] below
    }

    stamp(j, 1);
    // ---- the owner of lane g publishes slot g, and its warp pushes the
    // packet into every CTA's shared memory ----
    const int owner = g / P;
    const int otid = (g - owner * P) % T;
    if (kind != 0 && rank == owner && (tid >> 5) == (otid >> 5)) {
      if (tid == otid) {
#pragma unroll
        for (int k = 0; k < L; ++k)
          if (ln[k] == g) {
            s.pkt[0] = make_float4(mm[k][0], mm[k][1], sn[k] ? 1.0f : 0.0f,
                                   0.0f);
            s.pkt[1] = make_float4(rm[k][0], rm[k][1], rm[k][2], rm[k][3]);
            s.pkt[2] = make_float4(rm[k][4], rm[k][5], 0.0f, 0.0f);
          }
      }
      // column-g packets of the tick's earlier updates, HSb[i, :, g]: the
      // owner's writes, read back by its warp, a lane an op, so that the
      // reads are one round trip to L2 (they were written before barrier
      // 2 of op i, which ordered them for the whole cluster)
      for (int i = tid & 31; i < j; i += 32)
        if ((upd >> i) & 1) {
          const float* h = HSb + (size_t)i * 4 * N + g;
          s.pkt[3 + i] = make_float4(h[0], h[N], h[2 * (size_t)N],
                                     h[3 * (size_t)N]);
        }
      if (C > 1) {
        __syncwarp();
        for (int idx = tid & 31; idx < C * (3 + j); idx += 32) {
          const int c = idx % C, i = idx / C;
          if (c != rank && (i < 3 || ((upd >> (i - 3)) & 1)))
            cluster.map_shared_rank(s.pkt, c)[i] = s.pkt[i];
        }
      }
    }
    stamp(j, 2);
    sync_all();   // barrier 1: slot g's values are in every CTA
    stamp(j, 3);

    const float4* pk = s.pkt;
    if (known && kind != 0) kind = pk[0].z != 0.0f ? 1 : 2;

    Geometry ge;
    float s4[L][4];
    if (kind == 1) {
      measurement_geometry(rb, pk[0], pk[1], pk[2], z0, z1,
                           p.wrap_innovation, ge);

      // ---- grid column g after the tick's earlier ops, then the
      // Sigma H^T strip s4: to HSb[j] and, at lane g, to shared ----
      stamp(j, 4);
      cp_async_wait(known ? D - 1 : 0);
      const int rslot = known ? j % D : 0;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (ln[k] < 0) continue;
        const int n = ln[k];
        const int local = k * T + tid;
        float col[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          col[c] = ring[((size_t)rslot * 4 + swap[c]) * PL + local];
        const float* hrow = hist + local;          // op i's 4 comps, PL apart
        uint64_t u = upd, w = ini;
#pragma unroll 4
        for (int i = 0; i < j; ++i, hrow += 4 * PL, u >>= 1, w >>= 1) {
          if (u & 1) {
            float kk[4];
            if (hist_smem) {
#pragma unroll
              for (int c = 0; c < 4; ++c) kk[c] = hrow[c * PL];
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                kk[c] = Kb[((size_t)i * 4 + c) * N + n];
            }
            const float4 hv = pk[3 + i];
            col[0] = col[0] - (kk[0] * hv.x + kk[1] * hv.y);
            col[1] = col[1] - (kk[0] * hv.z + kk[1] * hv.w);
            col[2] = col[2] - (kk[2] * hv.x + kk[3] * hv.y);
            col[3] = col[3] - (kk[2] * hv.z + kk[3] * hv.w);
          } else if (w & 1) {
            const int si = s.gs[i];
            if (si == g) {
              // whole column <- the init's cross strip, comps swapped
              if (hist_smem) {
#pragma unroll
                for (int c = 0; c < 4; ++c) col[c] = hrow[swap[c] * PL];
              } else {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                  col[c] = CRb[((size_t)i * 4 + swap[c]) * N + n];
              }
            } else if (n == si) {
              // one lane of the map: the init's strip at lane g, written
              // by g's owner before the last barrier
#pragma unroll
              for (int c = 0; c < 4; ++c)
                col[c] = __ldcg(CRb + ((size_t)i * 4 + c) * N + g);
            }
          }
        }
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float v = rm[k][0 + pp] * ge.h5[q][0] +
                            rm[k][2 + pp] * ge.h5[q][1] +
                            rm[k][4 + pp] * ge.h5[q][2] +
                            col[pp * 2 + 0] * ge.h5[q][3] +
                            col[pp * 2 + 1] * ge.h5[q][4];
            s4[k][pp * 2 + q] = v;
            HSb[((size_t)j * 4 + pp * 2 + q) * N + n] = v;
          }
        if (n == g) {
          const float4 v = make_float4(s4[k][0], s4[k][1], s4[k][2], s4[k][3]);
          s.s4g = v;
          for (int c = 0; c < C; ++c)
            if (c != rank) *cluster.map_shared_rank(&s.s4g, c) = v;
        }
      }
    }
    if (known) {
      // the ring slot this measurement used is free: next row in flight
      const int jj = j + D;
      if (jj < M && s.ok[jj]) request_row(s.slot[jj], j % D);
      cp_async_commit();
    }
    stamp(j, 5);
    sync_all();   // barrier 2: s4 at lane g is in every CTA
    stamp(j, 6);

    // ---- the op record ----
    if (kind == 1) upd |= 1ull << j;
    if (kind == 2) ini |= 1ull << j;
    if (tid == 0) {
      s.gs[j] = g;
      if (rank == 0) {
        p.kindb[world * M + j] = kind;
        p.gb[world * M + j] = kind > 0 ? g : -1;
      }
    }
    float* kb = Kb + (size_t)j * 4 * N;
    float* hb = HSb + (size_t)j * 4 * N;
    float* cb = CRb + (size_t)j * 4 * N;
    if (kind == 1) {
      // innovation covariance, gain rows of the robot block, the robot
      // mean / covariance update
      float inv[2][2], kr[3][2];
      robot_update(rb, ge, s.s4g, p.symmetrize, inv, kr);
      const float dz0 = ge.dz0, dz1 = ge.dz1;

      // the strip updates and the op-buffer rows
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (ln[k] < 0) continue;
        const int n = ln[k];
        float k4[4];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            k4[pp * 2 + r] = s4[k][pp * 2 + 0] * inv[0][r] +
                             s4[k][pp * 2 + 1] * inv[1][r];
        mm[k][0] = mm[k][0] + (k4[0] * dz0 + k4[1] * dz1);
        mm[k][1] = mm[k][1] + (k4[2] * dz0 + k4[3] * dz1);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
            rm[k][i * 2 + pp] =
                rm[k][i * 2 + pp] - (kr[i][0] * s4[k][pp * 2 + 0] +
                                     kr[i][1] * s4[k][pp * 2 + 1]);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            dg[k][pp * 2 + r] =
                dg[k][pp * 2 + r] - (k4[pp * 2 + 0] * s4[k][r * 2 + 0] +
                                     k4[pp * 2 + 1] * s4[k][r * 2 + 1]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kb[c * N + n] = k4[c];
          cb[c * N + n] = 0.0f;
          if (hist_smem) hist[((size_t)j * 4 + c) * PL + k * T + tid] = k4[c];
        }
      }
    } else if (kind == 2) {
      // analytic first-observation init of slot g
      const float a = z1 + rb.th;
      const float r = z0;
      const float sa = sinf(a), ca = cosf(a);
      const float mnew[2] = {rb.x + r * ca, rb.y + r * sa};
      const float gx[2][3] = {{-r * sa, 1.0f, 0.0f}, {r * ca, 0.0f, 1.0f}};
      const float gz[2][2] = {{ca, -r * sa}, {sa, r * ca}};
      float gsr[2][3];   // Gx cov_rr
      float gr[2][2];    // Gz R
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int k = 0; k < 3; ++k)
          gsr[q][k] = gx[q][0] * rb.crr[0][k] + gx[q][1] * rb.crr[1][k] +
                      gx[q][2] * rb.crr[2][k];
#pragma unroll
        for (int k = 0; k < 2; ++k)
          gr[q][k] = gz[q][0] * rb.R[0][k] + gz[q][1] * rb.R[1][k];
      }
      // B_own = Gx Srr Gx^T + Gz R Gz^T
      float bown[4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int t = 0; t < 2; ++t)
          bown[q * 2 + t] = (gsr[q][0] * gx[t][0] + gsr[q][1] * gx[t][1] +
                             gsr[q][2] * gx[t][2]) +
                            (gr[q][0] * gz[t][0] + gr[q][1] * gz[t][1]);
      rb.n_seen += 1;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (ln[k] < 0) continue;
        const int n = ln[k];
        // local column of the init cross strip Gx Sigma_{r, m_n}, own
        // column pre-patched with B_own
        float cross[4];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            cross[pp * 2 + q] = gx[pp][0] * rm[k][0 + q] +
                                gx[pp][1] * rm[k][2 + q] +
                                gx[pp][2] * rm[k][4 + q];
        if (n == g) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            cross[c] = bown[c];
            dg[k][c] = bown[c];
          }
          mm[k][0] = mnew[0];
          mm[k][1] = mnew[1];
          // cross_r = (Gx Srr)^T, stored as rm6 comps [i*2+p]
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q) rm[k][i * 2 + q] = gsr[q][i];
          sn[k] = true;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kb[c * N + n] = 0.0f;
          hb[c * N + n] = 0.0f;
          cb[c * N + n] = cross[c];
          if (hist_smem)
            hist[((size_t)j * 4 + c) * PL + k * T + tid] = cross[c];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < L; ++k) {
        if (ln[k] < 0) continue;
        const int n = ln[k];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kb[c * N + n] = 0.0f;
          hb[c * N + n] = 0.0f;
          cb[c * N + n] = 0.0f;
        }
      }
    }
    stamp(j, 7);
  }
  cp_async_wait(0);

  // ---- the carried state, stored once ----
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (ln[k] < 0) continue;
    const int n = ln[k];
#pragma unroll
    for (int c = 0; c < 2; ++c) p.mm2_o[(world * 2 + c) * N + n] = mm[k][c];
#pragma unroll
    for (int c = 0; c < 6; ++c) p.rm6_o[(world * 6 + c) * N + n] = rm[k][c];
#pragma unroll
    for (int c = 0; c < 4; ++c) p.diag4_o[(world * 4 + c) * N + n] = dg[k][c];
    p.seen_o[world * N + n] = sn[k] ? 1 : 0;
  }
  if (rank == 0 && tid == 0) {
    p.mean_r_o[world * 3 + 0] = rb.th;
    p.mean_r_o[world * 3 + 1] = rb.x;
    p.mean_r_o[world * 3 + 2] = rb.y;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        p.cov_rr_o[world * 9 + i * 3 + k] = rb.crr[i][k];
    p.n_seen_o[world] = rb.n_seen;
  }
  // no CTA leaves while another may still read its shared memory
  if (C > 1) cluster.sync();
}

// The kernel instance's attributes for a launch of `cluster`-CTA clusters
// with `smem` bytes of dynamic shared memory, set once each.
template <int L, int TMAX, bool CLOCK>
cudaError_t prepare(int cluster, size_t smem) {
  auto kernel = seq_scan_kernel<L, TMAX, CLOCK>;
  static size_t smem_set = 0;
  static bool nonportable = false;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (cluster > 8 && !nonportable) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    nonportable = true;
  }
  return cudaSuccess;
}

// How many clusters of the instance the card holds at once (negative: the
// error code of the query).
template <int L, int TMAX>
int max_clusters(int cluster, int threads, size_t smem) {
  cudaError_t e = prepare<L, TMAX, false>(cluster, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, seq_scan_kernel<L, TMAX, false>,
                                     &cfg);
  return e == cudaSuccess ? n : -(int)e;
}

template <int L, int TMAX, bool CLOCK = false>
cudaError_t launch(const Params& p, int batch, int threads, size_t smem,
                   cudaStream_t stream) {
  auto kernel = seq_scan_kernel<L, TMAX, CLOCK>;
  cudaError_t e0 = prepare<L, TMAX, CLOCK>(p.cluster, smem);
  if (e0 != cudaSuccess) return e0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}


// Times the pieces of the serial chain the scan cannot avoid, for the
// latency floor chip_smoke.py writes beside the kernel's time: `iters`
// rounds of (mode 0) the barrier alone, (1) a dependent read of device
// memory through L2 by every thread (a pointer chase over `buf`, which
// holds the index of the next word), (2) an update's replicated scalar
// chain alone -- measurement_geometry and robot_update, the kernel's own
// functions, each round on the robot the last one left, in every thread as
// in the kernel, with no lane work, no barrier and no memory traffic. One
// cluster of `cluster` CTAs; the rounds are timed from outside with CUDA
// events.
__global__ void seq_scan_probe_kernel(int mode, int cluster_size, int iters,
                                      int* buf, int words) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = cluster_size;
  const int rank = C == 1 ? 0 : (int)cluster.block_rank();
  const int gid = rank * blockDim.x + threadIdx.x;
  int acc = gid % words;
  if (mode == 2) {
    // a robot near the origin with cov_rr = R = 1e-3 I revisits a landmark
    // 5 m away whose own block is 1e-3 I: small innovations, so the libm
    // calls take the paths they take in a run
    Robot rb = {0.1f, 0.0f, 0.0f,
                {{1e-3f, 0.0f, 0.0f}, {0.0f, 1e-3f, 0.0f}, {0.0f, 0.0f, 1e-3f}},
                {{1e-3f, 0.0f}, {0.0f, 1e-3f}}, 0, 0};
    for (int it = 0; it < iters; ++it) {
      const float e = 1e-6f * (float)(it & 3);
      Geometry ge;
      measurement_geometry(rb, make_float4(3.0f + e, 4.0f, 1.0f, 0.0f),
                           make_float4(e, -e, e, e), make_float4(-e, e, 0, 0),
                           5.0f, 0.8273f, 0, ge);
      float inv[2][2], kr[3][2];
      robot_update(rb, ge,
                   make_float4(1e-3f * ge.h5[0][3], 1e-3f * ge.h5[1][3],
                               1e-3f * ge.h5[0][4], 1e-3f * ge.h5[1][4]),
                   1, inv, kr);
    }
    if (rb.th == -12345.0f) acc = -12345;
  } else {
    for (int it = 0; it < iters; ++it) {
      if (mode == 1)
        acc = __ldcg(buf + acc);
      else if (C == 1)
        __syncthreads();
      else
        cluster.sync();
    }
  }
  if (acc == -12345) buf[0] = acc;   // keeps the chase and the chain alive
}

}  // namespace

// Returns the launch's error code (0 = launched). Every operand but R
// holds `batch` worlds, each a slab of the one-world shapes; one cluster a
// world. `ids` may be null when known == 0. The plan (cluster CTAs of
// `threads` threads, `lanes` lanes a thread, `ring` row slots, history in
// shared memory or not) comes from ops/kernels/seq_scan.py launch_plan;
// cluster * threads * lanes >= n. `stamps`, if not null, is (m, 8) int64:
// the launch then runs the clocked instance, which exists for 1 and 2
// lanes a thread (the measured plans), on one world.
extern "C" int seq_scan(
    const void* mean_r, const void* cov_rr, const void* n_seen,
    const void* mm2, const void* rm6, const void* diag4, const void* seen,
    const void* mm0p, const void* zs, const void* valid, const void* ids,
    const void* R, void* mean_r_o, void* cov_rr_o, void* n_seen_o,
    void* mm2_o, void* rm6_o, void* diag4_o, void* seen_o, void* Kb,
    void* HSb, void* CRb, void* gb, void* kindb, int n, int m, int batch,
    int wrap_innovation, int symmetrize, int known, float match_gate,
    float new_gate, int cluster, int threads, int lanes, int ring,
    int hist_smem, void* stamps, void* stream) {
  if (n <= 0 || m <= 0 || m > kMaxMeas || (known && ids == nullptr) ||
      batch <= 0 || batch > 65535 || (stamps != nullptr && batch != 1))
    return (int)cudaErrorInvalidValue;
  const bool pow2 = cluster >= 1 && cluster <= 16 &&
                    (cluster & (cluster - 1)) == 0;
  if (!pow2 || threads < 32 || threads > 1024 || threads % 32 != 0 ||
      (ring != 1 && ring != 2 && ring != 4) ||
      (lanes != 1 && lanes != 2 && lanes != 4 && lanes != 8))
    return (int)cudaErrorInvalidValue;
  const int per_cta = (n + cluster - 1) / cluster;
  if (per_cta > threads * lanes) return (int)cudaErrorInvalidValue;
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
  p.cluster = cluster;
  p.per_cta = per_cta;
  p.ring = known ? ring : 1;
  p.hist_smem = hist_smem;
  p.stamps = (long long*)stamps;
  const size_t slots = (size_t)threads * lanes;
  const size_t smem =
      4 * slots * 4 * ((size_t)p.ring + (hist_smem ? (size_t)m : 0));
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  // instances: 1, 2, 4 or 8 lanes a thread under 128 registers (up to 512
  // threads); 8 lanes at 1024 threads for the largest maps
  if (stamps != nullptr) {
    if (threads > 512 || lanes > 2) return (int)cudaErrorInvalidValue;
    e = lanes == 1 ? launch<1, 512, true>(p, batch, threads, smem, st)
                   : launch<2, 512, true>(p, batch, threads, smem, st);
  } else if (threads > 512) {
    if (lanes != 8) return (int)cudaErrorInvalidValue;
    e = launch<8, 1024>(p, batch, threads, smem, st);
  } else if (lanes == 1) {
    e = launch<1, 512>(p, batch, threads, smem, st);
  } else if (lanes == 2) {
    e = launch<2, 512>(p, batch, threads, smem, st);
  } else if (lanes == 4) {
    e = launch<4, 512>(p, batch, threads, smem, st);
  } else {
    e = launch<8, 512>(p, batch, threads, smem, st);
  }
  return (int)e;
}

// How many clusters of `cluster` CTAs of the instance that launches with
// `threads` threads of `lanes` lanes, `ring` row slots and the history in
// shared memory or not fit on the card at once (negative: an error code).
extern "C" int seq_scan_max_clusters(int cluster, int threads, int lanes,
                                     int ring, int hist_smem, int m) {
  const size_t smem = 4 * (size_t)threads * lanes * 4 *
                      ((size_t)ring + (hist_smem ? (size_t)m : 0));
  if (threads > 512) return max_clusters<8, 1024>(cluster, threads, smem);
  switch (lanes) {
    case 1: return max_clusters<1, 512>(cluster, threads, smem);
    case 2: return max_clusters<2, 512>(cluster, threads, smem);
    case 4: return max_clusters<4, 512>(cluster, threads, smem);
    default: return max_clusters<8, 512>(cluster, threads, smem);
  }
}

// Launches the probe above (see there). `buf` holds 2 * words ints, the
// first `words` a permutation to chase; cluster * threads <= words.
extern "C" int seq_scan_probe(int mode, int cluster, int threads, int iters,
                              void* buf, int words, void* stream) {
  if (mode < 0 || mode > 2 || cluster < 1 || cluster > 16 ||
      (cluster & (cluster - 1)) != 0 || threads < 32 || threads > 1024 ||
      iters < 1 || words < cluster * threads)
    return (int)cudaErrorInvalidValue;
  static bool nonportable = false;
  if (cluster > 8 && !nonportable) {
    cudaError_t e = cudaFuncSetAttribute(
        seq_scan_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (e != cudaSuccess) return (int)e;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, seq_scan_probe_kernel, mode,
                                     cluster, iters, (int*)buf, words);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
