// The segmented perception path's front end, one launch for B scans, for
// sm_90a: each scan's n ranges -> its C cluster slots' fit inputs (the ten
// distinct moments, centroid, zbar, count, valid, is_circle).
//
// Replaces no TPU kernel: the JAX package leaves this stage
// (ops/landmark_detection._segment_fit_inputs and
// ops/clustering._scan_membership) to XLA. Run eagerly it built (B, C, n)
// one-hot tensors (1.51 GB each at B = 65536, C = 16, n = 360), their
// masked copies, a one-hot cumsum and (B, n, 11) stacks, and summed them
// through batched matrix products, to reduce a 94-MB scan.
//
// Semantics: the plain version's (ops/clustering._segment_fit_inputs), for
// finite scans. A ray is in range where
// lo <= r <= hi; an in-range ray closes its cluster where |r[i] - r[i+1]|
// >= the split threshold (i+1 wraps); cluster ids are the splits before a
// ray; the trailing open cluster is dropped, except that ray n-1, in range
// and not splitting, joins cluster 0 (the wrap move); a ray's row in its
// cluster is the members before it in that cluster; rows past P are
// dropped, and a full cluster 0 loses its last stored row to the wrap
// move. Slot c < C holds cluster c: its first and last stored rows are the
// endpoints p2 and p3, its interior rows give the inscribed angles, whose
// population deviation (< the std threshold) makes it a circle; its
// moments are those of the stored rows about the centroid, which divides
// by the full count.
//
// What bounds it on an H100: the scan read once (B n 4 bytes) and 58 bytes
// a slot written once; ~0.05 ms at B = 65536 by bytes and about as much by
// operations (~120 a ray, cos, sin and atan2 counted as 20 each).
//
// Design: a warp owns one world, 4 worlds a block. The warp copies its
// world's ranges into shared memory with coalesced loads; each lane then
// holds a contiguous run of K rays in registers (K >= n / 32, a template
// instance; 12 at n = 360). Membership is scans over the warp: the splits'
// exclusive prefix gives each ray its cluster id, the members' prefix less
// the prefix at the cluster's first ray its row (clusters are runs of
// rays, so no one-hot is needed); the ray that closes cluster c writes
// that prefix for cluster c + 1 and its own index as the cluster's end,
// one writer a slot. The lane that owns a stored row computes its point,
// writes the endpoints (one writer a slot), then the interior rows'
// inscribed angles, and leaves each ray's point, angle and slot in shared
// memory. Then lane c sums slot c: its stored rows one after another in
// ray order, the wrap-moved ray n-1 last, pass 1 (x, y, the interior
// angles and count: the centroid and mean angle) and pass 2 (the
// deviation squared and the ten moment products). That is the plain
// version's order when its one-hot matrix products add a slot's rays one
// after another, and then the kernel gives its bits. cuBLAS on the card
// mostly adds them in that order, but not always: on config 3's scans at
// B = 1024, 0.42% of the slots' moments differ from it, by up to 2e-6,
// within float32's bound for a sum in another order. No atomics, and two
// launches give the same bits. The order matters beyond the last bit: a
// noise-free tube's fit sits on its rank-deficiency switch, and sums in
// another order (a tree of shuffles over the lanes' runs) moved such fits
// by centimetres. At B = 65536 this takes 0.40 ms; that tree took 0.58,
// and a 128-thread block a world with it 0.91.
//
// Per ray, every operation is the plain version's own, with its rounding:
// products and sums through __fmul_rn / __fadd_rn / __fsub_rn (never
// contracted into an FMA), IEEE division and square root, and the CUDA
// math library's cosf, sinf and atan2f, which PyTorch's elementwise
// kernels call on the card too; gates are selects, never products.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxRays = 1024;     // rays a scan
constexpr int kMaxSlots = 32;      // cluster slots a scan (C): a lane each
constexpr int kMoments = 10;
constexpr int kSlotBytes = 1040;   // sizeof(Slots)
constexpr int kRayWords = 5;       // words a ray: range, x, y, angle, slot
constexpr int kWorlds = 4;         // worlds (warps) a block
constexpr int kSmemLimit = 232448; // dynamic shared memory a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr double kPi = 3.14159265358979323846;
constexpr int kInterior = 1 << 8;  // in a ray's slot word: an interior row

// A world's shared memory beside its rays.
struct Slots {
  float p2x[kMaxSlots], p2y[kMaxSlots], p3x[kMaxSlots], p3y[kMaxSlots];
  int base[kMaxSlots + 1];      // members before cluster c's first ray
  int count[kMaxSlots];         // the full count (count_final)
  int first[kMaxSlots];         // the ray of slot c's first stored row
  int end[kMaxSlots];           // the ray that closes cluster c
  int pad[3];
};
static_assert(sizeof(Slots) == kSlotBytes, "kSlotBytes");

struct Args {
  const float* ranges;         // (B, n)
  const float* lo_p;           // 0-d bounds on the card, or null
  const float* hi_p;
  float lo, hi;                // the bounds where the pointers are null
  float step;                  // (float)(360 / n): degrees a ray
  float split_threshold;
  float std_threshold;
  float* moments;              // (B, C, 10)
  float* cx;                   // (B, C)
  float* cy;
  float* zbar;
  int* count;
  uint8_t* valid;
  uint8_t* circle;
  float* margins;              // (B, 2): split, std; or null
  int n, C, P, B;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// The warp that owns one world: a scan and a reduction over its lanes.
struct Warp {
  int lane;

  // Exclusive sum over the lanes; `total` gets the sum of all.
  __device__ int excl_sum(int v, int& total) const {
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += u;
    }
    total = __shfl_sync(kFull, inc, 31);
    return inc - v;
  }

  // The least v over the lanes, in every lane.
  __device__ float all_min(float v) const {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, d));
    return v;
  }
};

template <int K>
__global__ void __launch_bounds__(32 * kWorlds)
    segment_fit_inputs_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, C = a.C, P = a.P;
  const int w = threadIdx.x / 32;
  const int b = blockIdx.x * kWorlds + w;
  if (b >= a.B) return;  // the whole warp
  Warp wp;
  wp.lane = threadIdx.x % 32;
  const int t = wp.lane;
  Slots* sl = reinterpret_cast<Slots*>(smem) + w;
  const int n4 = (n + 3) / 4 * 4;
  float* R = reinterpret_cast<float*>(smem + kWorlds * kSlotBytes) +
             w * kRayWords * n4;
  float* X = R + n4;  // a stored row's point, its angle (interior rows;
  float* Y = X + n4;  // else 0) and its slot (| kInterior), else -1
  float* A = Y + n4;
  int* F = reinterpret_cast<int*>(A + n4);

  const float* src = a.ranges + (size_t)b * n;
  for (int i = t; i < n; i += 32) R[i] = src[i];
  const float lo = a.lo_p != nullptr ? *a.lo_p : a.lo;
  const float hi = a.hi_p != nullptr ? *a.hi_p : a.hi;
  const float thr = a.split_threshold;
  __syncwarp();

  // ---- membership: in range, splits, cluster ids (ref :148-174)
  const int i0 = t * K;
  unsigned in_bits = 0, split_bits = 0;
  int nsplit = 0;
  float split_margin = INFINITY;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = i0 + k;
    if (i < n) {
      const float r = R[i];
      const float jump = fabsf(sub(r, R[i + 1 == n ? 0 : i + 1]));
      if (r >= lo && r <= hi) {
        in_bits |= 1u << k;
        if (jump >= thr) {
          split_bits |= 1u << k;
          ++nsplit;
        }
        split_margin = fminf(split_margin, fabsf(sub(jump, thr)));
      }
    }
  }
  int num_closed;
  const int split_base = wp.excl_sum(nsplit, num_closed);
  // ray n-1 joins cluster 0 where it is in range and does not split
  bool wrap;
  {
    const float r = R[n - 1];
    const bool in = r >= lo && r <= hi;
    wrap = in && !(fabsf(sub(r, R[0])) >= thr) && num_closed > 0;
  }
  int cid[K];
  unsigned mem_bits = 0;
  int nmem = 0;
  {
    int c = split_base;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k;
      cid[k] = c;
      if (i < n) {
        if (((in_bits >> k) & 1u) && c < num_closed &&
            !(i == n - 1 && wrap)) {
          mem_bits |= 1u << k;
          ++nmem;
        }
        c += (split_bits >> k) & 1u;
      }
    }
  }
  int nmembers;
  const int mem_base = wp.excl_sum(nmem, nmembers);
  // the members before each cluster's first ray, and the cluster's last
  // ray: written by the ray that closes it (a split ray is a member)
  if (t == 0) sl->base[0] = 0;
  {
    int m = mem_base;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      m += (mem_bits >> k) & 1u;
      if (((split_bits >> k) & 1u) && cid[k] < C) {
        sl->base[cid[k] + 1] = m;
        sl->end[cid[k]] = i0 + k;
      }
    }
  }
  __syncwarp();
  // full counts: the wrap move adds ray n-1 to cluster 0
  const int counts0 = num_closed > 0 ? sl->base[1] : 0;
  for (int c = t; c < C; c += 32)
    sl->count[c] = (c < num_closed ? sl->base[c + 1] - sl->base[c] : 0) +
                   (wrap && c == 0 ? 1 : 0);
  __syncwarp();

  // ---- stored rows, points, endpoints
  const float deg2rad = (float)(kPi / 180.0);
  const float rad2deg = (float)(180.0 / kPi);
  int key[K];            // slot of a stored row, else -1
  unsigned interior_bits = 0;
  float x[K], y[K];
  {
    int m = mem_base;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + k;
      key[k] = -1;
      x[k] = y[k] = 0.0f;
      const bool mem = (mem_bits >> k) & 1u;
      int slot = cid[k], row = 0;
      bool stored = false;
      if (i < n && wrap && i == n - 1) {
        slot = 0;
        row = min(counts0, P - 1);
        stored = true;
      } else if (mem && cid[k] < C) {
        row = m - sl->base[cid[k]];
        // a full cluster 0 gives its last stored row to the wrap move
        const bool overwritten =
            wrap && counts0 >= P && cid[k] == 0 && row == P - 1;
        stored = row < P && !overwritten;
      }
      m += mem;
      if (stored) {
        key[k] = slot;
        const float th = mul(deg2rad, mul((float)i, a.step));
        x[k] = mul(R[i], cosf(th));
        y[k] = mul(R[i], sinf(th));
        const int cf = sl->count[slot];
        if (row == 0) {
          sl->p2x[slot] = x[k];
          sl->p2y[slot] = y[k];
          sl->first[slot] = i;
        }
        if (row == min(max(cf - 1, 0), P - 1)) {
          sl->p3x[slot] = x[k];
          sl->p3y[slot] = y[k];
        }
        if (row >= 1 && row <= cf - 2) interior_bits |= 1u << k;
      }
    }
  }
  __syncwarp();

  // inscribed angles of the interior rows (ref :221-224); every ray's
  // point, angle and slot to shared memory
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = i0 + k;
    if (i >= n) continue;
    const bool in = (interior_bits >> k) & 1u;
    float ang = 0.0f;
    if (in) {
      const int c = key[k];
      const float p2x = sl->p2x[c], p2y = sl->p2y[c];
      const float p3x = sl->p3x[c], p3y = sl->p3y[c];
      const float num =
          add(add(mul(p2y, sub(x[k], p3x)), mul(y[k], sub(p3x, p2x))),
              mul(p3y, sub(p2x, x[k])));
      const float den = add(mul(sub(p2x, x[k]), sub(x[k], p3x)),
                            mul(sub(p2y, y[k]), sub(y[k], p3y)));
      ang = mul(rad2deg, atan2f(num, den));
    }
    X[i] = x[k];
    Y[i] = y[k];
    A[i] = ang;
    F[i] = key[k] < 0 ? -1 : key[k] | (in ? kInterior : 0);
  }
  __syncwarp();

  // ---- lane c sums slot c: its stored rows in ray order, ray n-1 last
  float std_margin = INFINITY;
  if (t < C) {
    const int c = t, cf = sl->count[c];
    const int lo_i = c < num_closed ? sl->first[c] : 1;
    const int hi_i = c < num_closed ? sl->end[c] : 0;
    const bool moved = c == 0 && wrap;
    // pass 1: x, y, the interior angles, the interior count
    float sx = 0.0f, sy = 0.0f, sa = 0.0f, sn = 0.0f;
    auto pass1 = [&](int i) {
      const int f = F[i];
      if (f < 0) return;
      sx = add(sx, X[i]);
      sy = add(sy, Y[i]);
      sa = add(sa, A[i]);
      sn = add(sn, (f & kInterior) ? 1.0f : 0.0f);
    };
    for (int i = lo_i; i <= hi_i; ++i) pass1(i);
    if (moved) pass1(n - 1);
    const float cnt = (float)max(cf, 1);
    const float cx = __fdiv_rn(sx, cnt), cy = __fdiv_rn(sy, cnt);
    const float cnt_i = fmaxf(sn, 1.0f);
    const float mean = __fdiv_rn(sa, cnt_i);
    // pass 2: the deviation squared and the moments about the centroid
    float s[1 + kMoments];
#pragma unroll
    for (int q = 0; q <= kMoments; ++q) s[q] = 0.0f;
    auto pass2 = [&](int i) {
      const int f = F[i];
      if (f < 0) return;
      const float xc = sub(X[i], cx), yc = sub(Y[i], cy);
      const float z = add(mul(xc, xc), mul(yc, yc));
      const float d = sub(A[i], mean);
      const float v[1 + kMoments] = {
          (f & kInterior) ? mul(d, d) : 0.0f, mul(z, z), mul(z, xc),
          mul(z, yc), z, mul(xc, xc), mul(xc, yc), xc, mul(yc, yc), yc,
          1.0f};
#pragma unroll
      for (int q = 0; q <= kMoments; ++q) s[q] = add(s[q], v[q]);
    };
    for (int i = lo_i; i <= hi_i; ++i) pass2(i);
    if (moved) pass2(n - 1);

    // the slot's outputs, written once
    const size_t o = (size_t)b * C + c;
    const float sd = __fsqrt_rn(__fdiv_rn(s[0], cnt_i));
    const bool valid = c < num_closed && cf >= 3;
    float* mom = a.moments + o * kMoments;
#pragma unroll
    for (int q = 0; q < kMoments; ++q) mom[q] = s[1 + q];
    a.cx[o] = cx;
    a.cy[o] = cy;
    a.zbar[o] = __fdiv_rn(s[4], cnt);
    a.count[o] = cf;
    a.valid[o] = valid;
    a.circle[o] = valid && sd < a.std_threshold;
    if (valid) std_margin = fabsf(sub(sd, a.std_threshold));
  }
  if (a.margins != nullptr) {
    split_margin = wp.all_min(split_margin);
    std_margin = wp.all_min(std_margin);
    if (t == 0) {
      a.margins[2 * (size_t)b] = split_margin;
      a.margins[2 * (size_t)b + 1] = std_margin;
    }
  }
}

template <int K>
int launch(const Args& a, int smem, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_fit_inputs_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const unsigned blocks = (unsigned)((a.B + kWorlds - 1) / kWorlds);
  segment_fit_inputs_kernel<K><<<blocks, 32 * kWorlds, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// B scans `ranges` (B, n) float32 -> for each scan's C slots: moments
// (B, C, 10) (zz, zx, zy, z, xx, xy, x, yy, y, n), cx, cy, zbar (B, C)
// float32, count (B, C) int32, valid and circle (B, C) bool; margins (B, 2)
// float32 or null. The range bounds are read from lo_p / hi_p (float32 on
// the card) where given, else lo / hi. rays and smem come from the launch
// plan (ops/kernels/perception.launch_plan): the instance of `rays` rays a
// lane must exist and hold n rays. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int segment_fit_inputs(
    const void* ranges, const void* lo_p, const void* hi_p, float lo, float hi,
    float split_threshold, float std_threshold, void* moments, void* cx,
    void* cy, void* zbar, void* count, void* valid, void* circle,
    void* margins, int n, int C, int P, int B, int rays, int smem,
    void* stream) {
  const int n4 = (n + 3) / 4 * 4;
  if (n < 1 || n > kMaxRays || C < 1 || C > kMaxSlots || P < 1 || B < 1 ||
      32 * rays < n || smem > kSmemLimit ||
      smem < kWorlds * (kSlotBytes + 4 * kRayWords * n4))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.ranges = (const float*)ranges;
  a.lo_p = (const float*)lo_p;
  a.hi_p = (const float*)hi_p;
  a.lo = lo;
  a.hi = hi;
  a.step = (float)(360.0 / (double)n);
  a.split_threshold = split_threshold;
  a.std_threshold = std_threshold;
  a.moments = (float*)moments;
  a.cx = (float*)cx;
  a.cy = (float*)cy;
  a.zbar = (float*)zbar;
  a.count = (int*)count;
  a.valid = (uint8_t*)valid;
  a.circle = (uint8_t*)circle;
  a.margins = (float*)margins;
  a.n = n;
  a.C = C;
  a.P = P;
  a.B = B;
  const cudaStream_t s = (cudaStream_t)stream;
#define CASE(K) \
  if (rays == K) return launch<K>(a, smem, s);
  CASE(1) CASE(2) CASE(4) CASE(8) CASE(12) CASE(16) CASE(24) CASE(32)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
