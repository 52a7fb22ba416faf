// The simulator's whole tick, one launch for all B worlds, for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves sim/tube_world to XLA,
// which the port ran op for op as eager PyTorch: five step_dynamics
// substeps (~93 launches each), observe (~37) and the odometry (~60), so
// ~560 launches a tick of config 3. observe's scan broadcast (B, 360, K)
// ray-tube tensors: 1.89 GB each at B=65536, K=20, ~10 of them a tick and
// a z-buffer reduction over tubes.
//
// One tick of one world, as pipeline/driver.sense_tick runs it: S
// step_dynamics substeps (twist noise, the collision nudge summed over
// tubes, wheel velocities, the slip-perturbed true update in the
// reference or the multiplicative slip mode), observe (the fake sensor's
// markers and the forward-ray scan with its z-buffer over tubes, noise and
// dropout, or the reference_lidar_quirks branch), then the odometry from
// the commanded joint states (wheels_to_twist and diff_drive.step).
//
// What bounds it on an H100: per world, the scan normals and keep
// uniforms read (2 x 1,440 B), the scan written (1,440 B), the poses and
// draws: ~0.30 GB at B=65536, ~0.09 ms at 3.35 TB/s. The ray-tube tests,
// ~10 operations each over 360 x 20 pairs a world (~5 GFLOP at
// B=65536), cost about as much at the f32 rate.
//
// Design (a warp a world, kWorlds worlds a block). The tube table is
// copied once into shared memory. Every lane runs the world's substeps
// redundantly in registers, so each holds the same bits with no shuffle
// and no barrier; the collision loop reads the table by broadcast and
// takes a tube's square root only where the squared distance lies within
// the reach's square and the root's rounding (elsewhere the plain test
// fails whatever the root rounds to). For
// the scan, lane k writes tube k's ray-independent terms (the robot's
// offset from it, the quadratic's constant, the quirk branch's cone
// centre) into the world's shared row, then lane l takes rays l, l + 32,
// ...: for each it loops over the K tubes with a running minimum and
// applies the noise and the dropout. Draws are read and ranges written
// coalesced by ray. The square root is taken only where the ray meets
// the tube's circle (disc >= 0; the quirk branch: disc >= eps): elsewhere
// the plain version's t is replaced by the sentinel or by |b|.
//
// Every floating-point operation is the plain chain's own, in its order,
// with its rounding: products and sums through __fmul_rn / __fadd_rn (no
// contraction into FMAs), the CUDA math library's sin, cos, atan2 and IEEE
// sqrt / division, which PyTorch's elementwise kernels on the card use too;
// a division by a host scalar (2 pi bin / n, dth^2 / 6) is a product by
// its reciprocal, as PyTorch computes it on the card; the minimum over
// tubes is exact in any order. The collision nudge adds the touching
// tubes' terms in tube order: where at most two touch at once that is
// the plain sum's bits in any order (the other terms are zeros); where
// three or more touch, torch.sum's own order may round the last bit
// otherwise. So on the card each world's tick is the plain chain's bits,
// in float32 and float64.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWorlds = 4;     // worlds a block, a warp each
constexpr int kMaxTubes = 64;  // tubes a world (the shared table's rows)

// launch flags
constexpr int kQuirks = 1, kMultiplicative = 2, kScan = 4, kFake = 8,
              kOdom = 16;

// operands, in the order of ops/kernels/sim_tick.py IN and OUT
enum In {
  kPose, kWheels, kCmdWheels, kOdomPose, kOdomWheels, kCmd, kTubeLocs,
  kTubeRad, kRobotRad, kMaxRange, kTubeVar, kTwistNoise, kSlipMin,
  kSlipMax, kScanMax, kScanNoise, kSensorDropout, kScanDropout,
  kWheelBase, kWheelRad, kNTwist, kNSlip, kNScan, kNMarkerKeep,
  kNScanKeep, kIns
};
enum Out {
  kPoseO, kWheelsO, kCmdWheelsO, kScanO, kFakeSensorO, kFakeSensorValidO,
  kOdomPoseO, kTwistO, kOuts
};

// One rounding at a time, in either precision.
template <typename T> struct Op;
template <> struct Op<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float sqrt(float a) {
    return __fsqrt_rn(a);
  }
  static __device__ __forceinline__ float sin(float a) { return sinf(a); }
  static __device__ __forceinline__ float cos(float a) { return cosf(a); }
  static __device__ __forceinline__ float atan2(float y, float x) {
    return atan2f(y, x);
  }
  static __device__ __forceinline__ float fmod(float a, float b) {
    return fmodf(a, b);
  }
};
template <> struct Op<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double sqrt(double a) {
    return __dsqrt_rn(a);
  }
  static __device__ __forceinline__ double sin(double a) { return ::sin(a); }
  static __device__ __forceinline__ double cos(double a) { return ::cos(a); }
  static __device__ __forceinline__ double atan2(double y, double x) {
    return ::atan2(y, x);
  }
  static __device__ __forceinline__ double fmod(double a, double b) {
    return ::fmod(a, b);
  }
};

template <typename T>
struct Args {
  const void* in[kIns];
  void* out[kOuts];
  int B, K, n, S, substeps, cmd_stride, flags;
  double dt, nudge;
};

// The world-independent numbers, each computed as the plain chain computes
// its 0-dim tensor.
template <typename T>
struct Consts {
  T tube_rad, max_range, tube_var, twist_noise, scan_max, scan_noise,
      sensor_dropout, scan_dropout;
  T reach;        // tube_rad + robot_rad
  T reach2_hi;    // reach^2 with room for the square root's rounding
  T r2;           // tube_rad ** 2
  T d_over_r;     // (wheel_base / 2) / wheel_rad
  T wheel_rad;
  T r_over_base;  // wheel_rad / wheel_base
  T r_half;       // wheel_rad / 2
  T slip_mean, slip_var, sentinel;  // sentinel: scan_max + 1
  T eps;          // the quirk branch's 1e-5 / scan_max^2
  T dt, nudge, inv_n, inv6;
};

template <typename T>
__device__ Consts<T> consts(const Args<T>& a) {
  using O = Op<T>;
  auto v = [&](int i) { return *static_cast<const T*>(a.in[i]); };
  Consts<T> c;
  c.tube_rad = v(kTubeRad);
  c.max_range = v(kMaxRange);
  c.tube_var = v(kTubeVar);
  c.twist_noise = v(kTwistNoise);
  c.scan_max = v(kScanMax);
  c.scan_noise = v(kScanNoise);
  c.sensor_dropout = v(kSensorDropout);
  c.scan_dropout = v(kScanDropout);
  c.reach = O::add(c.tube_rad, v(kRobotRad));
  c.reach2_hi = c.reach * c.reach * T(1.0 + 1.0 / 4096);
  c.r2 = O::mul(c.tube_rad, c.tube_rad);
  c.wheel_rad = v(kWheelRad);
  // wheel_base / 2.0: a product by the host scalar's reciprocal, exact
  c.d_over_r = O::div(O::mul(v(kWheelBase), T(0.5)), c.wheel_rad);
  c.r_over_base = O::div(c.wheel_rad, v(kWheelBase));
  c.r_half = O::mul(c.wheel_rad, T(0.5));
  const T lo = v(kSlipMin), hi = v(kSlipMax);
  c.slip_mean = O::mul(O::add(lo, hi), T(0.5));
  c.slip_var = O::sub(hi, c.slip_mean);
  c.sentinel = O::add(c.scan_max, T(1));
  // 1e-5 / x is x.reciprocal() * 1e-5 (Tensor.__rtruediv__)
  c.eps = O::mul(O::div(T(1), O::mul(c.scan_max, c.scan_max)), T(1e-5));
  c.dt = T(a.dt);
  c.nudge = T(a.nudge);
  c.inv_n = O::div(T(1), T(a.n));
  c.inv6 = O::div(T(1), T(6));
  return c;
}

// torch.remainder on the card: fmod, moved to the divisor's sign
template <typename T>
__device__ __forceinline__ T rem(T a, T b) {
  T m = Op<T>::fmod(a, b);
  if (m != T(0) && ((b < T(0)) != (m < T(0)))) m = Op<T>::add(m, b);
  return m;
}

// diff_drive.step with integrate_twist's branchless sinc pair (dy = 0) and
// the adjoint of a pure rotation by the heading, term for term.
template <typename T>
__device__ __forceinline__ void drive_step(const Consts<T>& c, T& th, T& x,
                                           T& y, T& wl, T& wr, T nwl,
                                           T nwr) {
  using O = Op<T>;
  const T dl = O::sub(nwl, wl), dr = O::sub(nwr, wr);
  const T dth = O::mul(c.r_over_base, O::sub(dr, dl));
  const T dx = O::mul(c.r_half, O::add(dl, dr));
  T s1, s2;
  if (fabs(dth) < T(1e-7)) {
    s1 = O::sub(T(1), O::mul(O::mul(dth, dth), c.inv6));
    s2 = O::mul(dth, T(0.5));
  } else {
    s1 = O::div(O::sin(dth), dth);
    s2 = O::div(O::sub(T(1), O::cos(dth)), dth);
  }
  const T zero = T(0);
  const T bx = O::sub(O::mul(dx, s1), O::mul(zero, s2));
  const T by = O::add(O::mul(dx, s2), O::mul(zero, s1));
  const T ct = O::cos(th), st = O::sin(th);
  const T q1 = O::sub(O::add(O::mul(zero, dth), O::mul(ct, bx)),
                      O::mul(st, by));
  const T q2 = O::add(O::add(O::mul(-zero, dth), O::mul(st, bx)),
                      O::mul(ct, by));
  th = O::add(th, dth);
  x = O::add(x, q1);
  y = O::add(y, q2);
  wl = nwl;
  wr = nwr;
}

// A tube's ray-independent terms for the scan: the robot's offset from
// it, the quadratic's constant and (quirk branch) the cone's centre.
template <typename T>
struct Row {
  T px, py, c, deg;
};

template <typename T>
__global__ void __launch_bounds__(32 * kWorlds)
sim_tick_kernel(const Args<T> a) {
  using O = Op<T>;
  __shared__ T s_tubes[2 * kMaxTubes];
  __shared__ Row<T> s_rows[kWorlds][kMaxTubes];

  const int K = a.K, n = a.n;
  for (int i = threadIdx.x; i < 2 * K; i += blockDim.x)
    s_tubes[i] = static_cast<const T*>(a.in[kTubeLocs])[i];
  __syncthreads();
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const size_t w = (size_t)blockIdx.x * kWorlds + wib;
  if (w >= (size_t)a.B) return;  // whole warps: no barrier follows

  const Consts<T> c = consts(a);
  auto in = [&](int i) { return static_cast<const T*>(a.in[i]); };
  auto out = [&](int i) { return static_cast<T*>(a.out[i]); };

  T th = in(kPose)[3 * w], x = in(kPose)[3 * w + 1], y = in(kPose)[3 * w + 2];
  T wl = in(kWheels)[2 * w], wr = in(kWheels)[2 * w + 1];
  T cl = in(kCmdWheels)[2 * w], cr = in(kCmdWheels)[2 * w + 1];
  const T* cmd = in(kCmd) + a.cmd_stride * w;
  const T c0 = cmd[0], c1 = cmd[1];

  // ---- the substeps (tube_world.step_dynamics)
  for (int k = 0; k < a.substeps; ++k) {
    const size_t g = (w * a.S + k) * 2;
    const T tw0 = O::add(c0, O::mul(c.twist_noise, in(kNTwist)[g]));
    const T tw1 = O::add(c1, O::mul(c.twist_noise, in(kNTwist)[g + 1]));
    // collision nudge against the pre-update pose, in tube order
    T nx = T(0), ny = T(0);
    for (int j = 0; j < K; ++j) {
      const T dx = O::sub(s_tubes[2 * j], x);
      const T dy = O::sub(s_tubes[2 * j + 1], y);
      const T d2 = O::add(O::mul(dx, dx), O::mul(dy, dy));
      // the root is monotone and rounds by less than the margin: beyond
      // reach2_hi the plain test fails, so it is taken only nearer
      if (d2 > c.reach2_hi) continue;
      T dist = O::sqrt(d2);
      dist = dist < T(1e-9) ? T(1e-9) : dist;
      if (dist <= c.reach) {
        nx = O::add(nx, O::mul(O::div(dy, dist), c.nudge));
        ny = O::add(ny, O::mul(O::div(-dx, dist), c.nudge));
      }
    }
    th = O::add(th, T(0));
    x = O::add(x, nx);
    y = O::add(y, ny);
    // twist -> wheel velocities, commanded wheel angles
    const T vr = O::div(tw1, c.wheel_rad);
    const T ul = O::add(O::mul(-c.d_over_r, tw0), vr);
    const T ur = O::add(O::mul(c.d_over_r, tw0), vr);
    const T ul_dt = O::mul(ul, c.dt), ur_dt = O::mul(ur, c.dt);
    cl = O::add(cl, ul_dt);
    cr = O::add(cr, ur_dt);
    // the true update from slip-perturbed wheel angles
    const T e0 = O::add(c.slip_mean, O::mul(c.slip_var, in(kNSlip)[g]));
    const T e1 = O::add(c.slip_mean, O::mul(c.slip_var, in(kNSlip)[g + 1]));
    T nwl, nwr;
    if (a.flags & kMultiplicative) {
      nwl = O::add(wl, O::mul(ul_dt, e0));
      nwr = O::add(wr, O::mul(ur_dt, e1));
    } else {
      nwl = O::add(cl, O::mul(ul, e0));
      nwr = O::add(cr, O::mul(ur, e1));
    }
    drive_step(c, th, x, y, wl, wr, nwl, nwr);
  }

  // ---- the odometry from the commanded joint states
  if (a.flags & kOdom) {
    T oth = in(kOdomPose)[3 * w], ox = in(kOdomPose)[3 * w + 1],
      oy = in(kOdomPose)[3 * w + 2];
    T owl = in(kOdomWheels)[2 * w], owr = in(kOdomWheels)[2 * w + 1];
    const T dl = O::sub(cl, owl), dr = O::sub(cr, owr);
    const T tdth = O::mul(c.r_over_base, O::sub(dr, dl));
    const T tdx = O::mul(c.r_half, O::add(dl, dr));
    drive_step(c, oth, ox, oy, owl, owr, cl, cr);
    if (lane == 0) {
      T* op = out(kOdomPoseO) + 3 * w;
      op[0] = oth;
      op[1] = ox;
      op[2] = oy;
      T* tw = out(kTwistO) + 3 * w;
      tw[0] = tdth;
      tw[1] = tdx;
      tw[2] = T(0);
    }
  }
  if (lane == 0) {
    T* p = out(kPoseO) + 3 * w;
    p[0] = th;
    p[1] = x;
    p[2] = y;
    out(kWheelsO)[2 * w] = wl;
    out(kWheelsO)[2 * w + 1] = wr;
    out(kCmdWheelsO)[2 * w] = cl;
    out(kCmdWheelsO)[2 * w + 1] = cr;
  }

  // ---- the fake sensor's markers (tube_world._fake_sensor), a tube a lane
  T* fake = out(kFakeSensorO) + 2 * K * w;
  uint8_t* fake_ok =
      static_cast<uint8_t*>(a.out[kFakeSensorValidO]) + K * w;
  if (a.flags & kFake) {
    const T ct = O::cos(th), st = O::sin(th), nst = -st;
    const T X = O::sub(O::mul(-x, ct), O::mul(y, st));
    const T Y = O::sub(O::mul(x, st), O::mul(y, ct));
    for (int j = lane; j < K; j += 32) {
      const T tx = s_tubes[2 * j], ty = s_tubes[2 * j + 1];
      const T rx = O::add(O::sub(O::mul(tx, ct), O::mul(ty, nst)), X);
      const T ry = O::add(O::add(O::mul(tx, nst), O::mul(ty, ct)), Y);
      fake[2 * j] = O::add(rx, c.tube_var);
      fake[2 * j + 1] = O::add(ry, c.tube_var);
      const T dx = O::sub(tx, x), dy = O::sub(ty, y);
      const T dist = O::sqrt(O::add(O::mul(dx, dx), O::mul(dy, dy)));
      fake_ok[j] = dist <= c.max_range &&
                   in(kNMarkerKeep)[K * w + j] >= c.sensor_dropout;
    }
  } else {
    for (int j = lane; j < K; j += 32) {
      fake[2 * j] = T(0);
      fake[2 * j + 1] = T(0);
      fake_ok[j] = 0;
    }
  }

  // ---- the scan (tube_world._lidar), rays l, l + 32, ... on lane l
  T* scan = out(kScanO) + (size_t)n * w;
  if (!(a.flags & kScan)) {
    for (int r = lane; r < n; r += 32) scan[r] = T(0);
    return;
  }
  const bool quirks = a.flags & kQuirks;
  const T r2d = T(180.0 / 3.14159265358979323846);
  const T d2r = T(3.14159265358979323846 / 180.0);
  Row<T>* rows = s_rows[wib];
  for (int j = lane; j < K; j += 32) {
    const T tx = s_tubes[2 * j], ty = s_tubes[2 * j + 1];
    Row<T> q;
    q.px = O::sub(x, tx);
    q.py = O::sub(y, ty);
    q.c = O::sub(O::add(O::mul(q.px, q.px), O::mul(q.py, q.py)), c.r2);
    q.deg = T(0);
    if (quirks) {
      const T ang = O::atan2(O::sub(O::mul(T(2), ty), y),
                             O::sub(O::mul(T(2), tx), x));
      const T deg = O::mul(r2d, ang);
      const T sgn = T((T(0) < deg) - (deg < T(0)));
      q.deg = O::mul(sgn, floor(O::add(fabs(deg), T(0.5))));
    }
    rows[j] = q;
  }
  __syncwarp();

  const T two_pi = T(2.0 * 3.14159265358979323846);
  const T deg0 = trunc(O::mul(r2d, th));
  const T* nscan = in(kNScan) + (size_t)n * w;
  const T* nkeep = in(kNScanKeep) + (size_t)n * w;
  for (int r = lane; r < n; r += 32) {
    T ray_deg = T(0), ang;
    if (quirks) {
      ray_deg = O::add(T(r), deg0);
      ang = O::mul(d2r, ray_deg);
    } else {
      ang = O::add(th, O::mul(O::mul(two_pi, T(r)), c.inv_n));
    }
    const T ux = O::cos(ang), uy = O::sin(ang);
    T range = T(INFINITY);
    for (int j = 0; j < K; ++j) {
      const Row<T> q = rows[j];
      const T b = O::add(O::mul(q.px, ux), O::mul(q.py, uy));
      const T disc = O::sub(O::mul(b, b), q.c);
      T t = c.sentinel;
      if (!quirks) {
        // the nearest forward hit
        if (disc >= T(0)) {
          const T s = O::sqrt(disc), nb = -b;
          const T t1 = O::sub(nb, s), t2 = O::add(nb, s);
          const T tf = t1 > T(0) ? t1 : t2;
          if (tf > T(0)) t = tf;
        }
      } else {
        // the infinite line, the tangent band, the cone and the NaN ray
        const bool tangent = fabs(disc) < c.eps;
        const T ddeg = O::sub(
            rem(O::add(O::sub(ray_deg, q.deg), T(180)), T(360)), T(180));
        const bool in_cone = ddeg >= T(-27) && ddeg <= T(26);
        const bool nan_ray = rem(ray_deg, T(360)) == T(0);
        const bool miss = disc <= -c.eps || !in_cone || (nan_ray && !tangent);
        if (!miss) {
          if (tangent) {
            t = fabs(b);
          } else {
            const T s = O::sqrt(disc), nb = -b;
            t = fmin(fabs(O::sub(nb, s)), fabs(O::add(nb, s)));
          }
        }
      }
      range = t < range ? t : range;
    }
    const T noisy = O::add(range, O::mul(c.scan_noise, nscan[r]));
    T v = range > c.scan_max ? range : noisy;
    scan[r] = nkeep[r] >= c.scan_dropout ? v : c.sentinel;
  }
}

template <typename T>
int launch(const void* const* in, void* const* out, int B, int K, int n,
           int S, int substeps, int cmd_stride, int flags, double dt,
           double nudge, cudaStream_t stream) {
  Args<T> a;
  for (int i = 0; i < kIns; ++i) a.in[i] = in[i];
  for (int i = 0; i < kOuts; ++i) a.out[i] = out[i];
  a.B = B;
  a.K = K;
  a.n = n;
  a.S = S;
  a.substeps = substeps;
  a.cmd_stride = cmd_stride;
  a.flags = flags;
  a.dt = dt;
  a.nudge = nudge;
  const int blocks = (B + kWorlds - 1) / kWorlds;
  sim_tick_kernel<T><<<blocks, 32 * kWorlds, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One tick of B worlds. in / out: host arrays of device pointers in the
// order of the enums above (odometry entries null without kOdom); f64
// selects the float64 instance; dt and nudge are the host scalars.
extern "C" int sim_tick(const void* const* in, void* const* out, int B,
                        int K, int n, int S, int substeps, int cmd_stride,
                        int flags, int f64, double dt, double nudge,
                        void* stream) {
  if (B < 1 || K < 1 || K > kMaxTubes || n < 1 || substeps < 0 ||
      S < substeps || (cmd_stride != 0 && cmd_stride != 3))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return f64 ? launch<double>(in, out, B, K, n, S, substeps, cmd_stride,
                              flags, dt, nudge, s)
             : launch<float>(in, out, B, K, n, S, substeps, cmd_stride,
                             flags, dt, nudge, s);
}
