// Dense EKF fused Kalman update, for sm_90a.
//
// Replaces the TPU kernel shermbot_navigation_tpu/ops/pallas/cov_update.py
// (fused_kalman_update):
//
//   K     = SHt psi_inv           (D, 2)
//   mean' = mean + K dz           (D,)
//   cov'  = cov - K SHt^T         (D, D)
//
// What bounds it on an H100: device-memory bandwidth. Per update it reads
// and writes the (D, D) f32 covariance once, 2 x 4 D^2 bytes (143 MB at
// D=4224, ~43 us at the 3.35 TB/s peak); the arithmetic is 2 FMAs a word.
//
// Design: one block of 256 threads walks kRows consecutive rows. A row's
// gain K[i, :] = SHt[i, :] psi_inv is two FMAs per row, computed by every
// thread from two broadcast loads; no K is stored. Each thread streams
// float4s of the row (D % 128 == 0, so every row is 16-byte aligned) and
// the matching eight SHt words (two float4 loads of the row-major (D, 2)
// SHt, 33 KB at D=4224, which stays in L1/L2 across the block's rows).
// Output is out of place. The update flag `apply` (device bool, or null =
// always) is read by every thread: when it is false the block copies its
// rows and mean entries unchanged, which is the exact select
// where(apply, updated, old) of the EKF tick, with no extra pass.
// No cuBLAS: the product is the body of the TPU kernel.
//
// B worlds in one launch (the dense engine under torch.func.vmap, where
// JAX batches its pallas_call): grid axis y is the world, every operand
// and the flag are strided by it, and each world's blocks do exactly the
// one-world arithmetic, so a world gets the bits of its own launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void __launch_bounds__(kThreads)
cov_update_kernel(const float* __restrict__ cov,
                  const float* __restrict__ sht,
                  const float* __restrict__ psi_inv,
                  const float* __restrict__ dz,
                  const float* __restrict__ mean,
                  const uint8_t* __restrict__ apply,
                  float* __restrict__ cov_o,
                  float* __restrict__ mean_o, int d) {
  const size_t w = blockIdx.y;
  cov += w * d * d;
  cov_o += w * d * d;
  sht += w * 2 * d;
  psi_inv += w * 4;
  dz += w * 2;
  mean += w * d;
  mean_o += w * d;
  const bool on = apply == nullptr || apply[w] != 0;
  const int n4 = d / 4;
  const float4* sh4 = reinterpret_cast<const float4*>(sht);
  const float i00 = psi_inv[0], i01 = psi_inv[1];
  const float i10 = psi_inv[2], i11 = psi_inv[3];
  const float dz0 = dz[0], dz1 = dz[1];
  const int row0 = blockIdx.x * kRows;
  for (int r = 0; r < kRows; ++r) {
    const int row = row0 + r;
    if (row >= d) return;
    const float4* src = reinterpret_cast<const float4*>(cov + (size_t)row * d);
    float4* dst = reinterpret_cast<float4*>(cov_o + (size_t)row * d);
    if (!on) {
      for (int c = threadIdx.x; c < n4; c += kThreads) dst[c] = src[c];
      if (threadIdx.x == 0) mean_o[row] = mean[row];
      continue;
    }
    const float s0 = sht[2 * row], s1 = sht[2 * row + 1];
    const float k0 = s0 * i00 + s1 * i10;
    const float k1 = s0 * i01 + s1 * i11;
    if (threadIdx.x == 0) mean_o[row] = mean[row] + (k0 * dz0 + k1 * dz1);
    for (int c = threadIdx.x; c < n4; c += kThreads) {
      // columns 4c .. 4c+3 of SHt: (sht[4c, 0], sht[4c, 1], sht[4c+1, 0],
      // sht[4c+1, 1]) and the same for 4c+2, 4c+3
      const float4 a = __ldg(sh4 + 2 * c);
      const float4 b = __ldg(sh4 + 2 * c + 1);
      float4 v = src[c];
      v.x = v.x - (k0 * a.x + k1 * a.y);
      v.y = v.y - (k0 * a.z + k1 * a.w);
      v.z = v.z - (k0 * b.x + k1 * b.y);
      v.w = v.w - (k0 * b.z + k1 * b.w);
      dst[c] = v;
    }
  }
}

}  // namespace

// `batch` worlds of contiguous (batch, d, d) covariances, (batch, d, 2)
// SHt, (batch, 2, 2) psi_inv, (batch, 2) dz, (batch, d) means and
// (batch,) flags. Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int cov_update(const void* cov, const void* sht,
                          const void* psi_inv, const void* dz,
                          const void* mean, const void* apply, void* cov_o,
                          void* mean_o, int d, int batch, void* stream) {
  if (d <= 0 || d % 128 != 0 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((d + kRows - 1) / kRows, batch);
  cov_update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)cov, (const float*)sht, (const float*)psi_inv,
      (const float*)dz, (const float*)mean, (const uint8_t*)apply,
      (float*)cov_o, (float*)mean_o, d);
  return (int)cudaGetLastError();
}
