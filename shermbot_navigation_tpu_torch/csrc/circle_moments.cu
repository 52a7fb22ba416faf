// Circle-fit front end: masked centroid + 4x4 moment matrix per cluster,
// for sm_90a.
//
// Replaces the TPU kernel
// shermbot_navigation_tpu/ops/pallas/circle_moments.py (circle_moments_raw).
// Per cluster c of P padded points with `count` valid ones:
//
//   w_i = [i < count],  n = max(count, 1)
//   cx = sum x_i w_i / n,  cy = sum y_i w_i / n
//   xc_i = (x_i - cx) w_i,  yc_i = (y_i - cy) w_i,  z_i = xc_i^2 + yc_i^2
//   M = Z^T Z with Z rows [z_i, xc_i, yc_i, w_i]   (16 entries, row-major)
//   zbar = sum z_i / n
//
// `count` may exceed P (the clustering drops overflow rows from the buffer
// but keeps the full count): the mask then covers all P rows while the
// divisions use the full count, as the TPU kernel does. Rows at and past
// `count` may hold anything; only the mask decides.
//
// What bounds it on an H100: device-memory bandwidth, nominally. Per launch
// it reads the (C, P, 2) f32 points once (8.4 MB at C=16384, P=64) and the
// counts, and writes 19 floats a cluster (1.25 MB): ~2.9 us at 3.35 TB/s,
// about the cost of the launch itself. The arithmetic is ~30 FMAs a point.
//
// Design: one warp per cluster, kWarps clusters a block. The (C, P, 2)
// layout makes a point one float2, so a lane's load is one coalesced
// 8-byte read; lane l takes points l, l+32, ... (two a lane at P=64). For
// P <= 32 * kHold the points stay in registers between the centroid pass
// and the moment pass; a longer cluster reads them a second time (from
// L1/L2). Both reductions are xor-shuffle trees, so every lane ends with
// the same sums; lane 0 writes the 19 outputs. f32 FMA throughout, no
// tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // clusters (warps) per block
constexpr int kHold = 4;     // points a lane keeps in registers

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One lane's partial sums of the ten distinct entries of M.
struct Sums {
  float zz = 0.0f, zx = 0.0f, zy = 0.0f, z = 0.0f, xx = 0.0f;
  float xy = 0.0f, x = 0.0f, yy = 0.0f, y = 0.0f, n = 0.0f;
  __device__ __forceinline__ void add(float2 p, float cx, float cy) {
    const float xc = p.x - cx, yc = p.y - cy;
    const float r = xc * xc + yc * yc;
    zz += r * r;
    zx += r * xc;
    zy += r * yc;
    z += r;
    xx += xc * xc;
    xy += xc * yc;
    x += xc;
    yy += yc * yc;
    y += yc;
    n += 1.0f;
  }
};

__global__ void __launch_bounds__(kWarps * 32)
circle_moments_kernel(const float2* __restrict__ points,
                      const int32_t* __restrict__ counts,
                      float* __restrict__ m16, float* __restrict__ cent,
                      float* __restrict__ zbar, int C, int P) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (c >= C) return;                     // whole warp leaves together
  const int count = counts[c];
  const float n = fmaxf((float)count, 1.0f);
  const float2* src = points + (size_t)c * P;
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
        sx += keep[k].x;
        sy += keep[k].y;
      }
    }
  } else {
    for (int i = lane; i < P && i < count; i += 32) {
      const float2 p = src[i];
      sx += p.x;
      sy += p.y;
    }
  }
  const float cx = warp_sum(sx) / n;
  const float cy = warp_sum(sy) / n;

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

  if (lane == 0) {
    float4* out = reinterpret_cast<float4*>(m16 + (size_t)c * 16);
    out[0] = make_float4(szz, szx, szy, sz);
    out[1] = make_float4(szx, sxx, sxy, sxc);
    out[2] = make_float4(szy, sxy, syy, syc);
    out[3] = make_float4(sz, sxc, syc, sn);
    cent[2 * (size_t)c] = cx;
    cent[2 * (size_t)c + 1] = cy;
    zbar[c] = sz / n;
  }
}

}  // namespace

// points (C, P, 2) f32 contiguous, 8-byte aligned; counts (C,) int32;
// m16 (C, 16) 16-byte aligned, cent (C, 2), zbar (C,). Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int circle_moments(const void* points, const void* counts,
                              void* m16, void* cent, void* zbar, int C,
                              int P, void* stream) {
  if (C <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (C + kWarps - 1) / kWarps;
  circle_moments_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float2*)points, (const int32_t*)counts, (float*)m16,
      (float*)cent, (float*)zbar, C, P);
  return (int)cudaGetLastError();
}
