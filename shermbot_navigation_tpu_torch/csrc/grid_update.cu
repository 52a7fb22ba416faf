// Deferred rank-2M landmark-grid pass, for sm_90a.
//
// Replaces the TPU kernel shermbot_navigation_tpu/ops/pallas/grid_update.py
// (fused_grid_update). Per comp plane (p, r) of the grid cov (2, 2, Nl, N):
//
//   out[p,r,n,m] = overwrite(p, r, n, m) - sum_{k<2M} A[p,n,k] B[r,k,m]
//
// where the overwrite replays the tick's landmark-init row and column
// writes in closed form: the TPU kernel loops i = 0..M-1 applying the
// column overwrite (colt == i) and then the row overwrite (rowt == i), so
// the last op wins and at equal op index the row wins. With rt = rowt[n]
// and ct = colt[m] that is
//   rt >= ct and rt >= 0  ->  crow[p, r, rt, m]
//   else ct >= 0          ->  ccol[p, r, n, ct]
//   else                  ->  cov[p, r, n, m].
//
// What bounds it on an H100: device-memory bandwidth. K = 2M = 16 is far too
// small for the products to matter (4 x 2M FLOP per 8 bytes moved), so the
// pass is one read and one write of the grid, 2 x 16 N^2 bytes per tick:
// 134 MB at N = 2048, more than the 50 MB L2. The sum is plain f32 FMA on
// the CUDA cores (no TF32, no tensor cores).
//
// Design: a simple tiled kernel. A block owns a 16 x 256 tile of one plane;
// the tile's 16 rows of A and 256 columns of B are staged in shared memory
// in K-chunks of 16. Each thread owns 4 rows x 4 consecutive columns, so the
// grid, crow and B are read and written with 16-byte accesses by
// neighbouring threads on neighbouring addresses.
//
// In place: the kernel writes into cov's own storage. That is safe because
// each element is read and then written by the same thread only. (The JAX
// version donates the input buffer to the output instead.)

#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 16;
constexpr int kTileCols = 256;
constexpr int kChunk = 16;
constexpr int kThreadsX = kTileCols / 4;           // 64: 4 columns each
constexpr int kThreadsY = 4;                       // 4 rows each
constexpr int kRowsPerThread = kTileRows / kThreadsY;

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
grid_update_kernel(float* __restrict__ cov, const float* __restrict__ a,
                   const float* __restrict__ b,
                   const float* __restrict__ crow,
                   const float* __restrict__ ccol,
                   const int* __restrict__ rowt,
                   const int* __restrict__ colt, int nl, int n, int m) {
  __shared__ float as[kTileRows][kChunk];
  __shared__ __align__(16) float bs[kChunk][kTileCols];

  const int plane = blockIdx.z;        // p * 2 + r
  const int pp = plane >> 1;
  const int rr = plane & 1;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileCols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int k2 = 2 * m;
  const bool vec = (n % 4) == 0;

  const float* ap = a + (size_t)pp * nl * k2;      // A[p] (Nl, 2M)
  const float* bp = b + (size_t)rr * k2 * n;       // B[r] (2M, N)

  float acc[kRowsPerThread][4];
  for (int i = 0; i < kRowsPerThread; ++i)
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;

  for (int kc = 0; kc < k2; kc += kChunk) {
    // A chunk: 16 x 16 values, one per thread
    {
      const int rloc = tid / kChunk;
      const int kloc = tid % kChunk;
      const int row = row0 + rloc;
      const int k = kc + kloc;
      as[rloc][kloc] = (row < nl && k < k2) ? ap[(size_t)row * k2 + k] : 0.0f;
    }
    // B chunk: 16 x 256 values, 16 per thread
    for (int idx = tid; idx < kChunk * kTileCols; idx += kThreadsX * kThreadsY) {
      const int kloc = idx / kTileCols;
      const int cloc = idx % kTileCols;
      const int k = kc + kloc;
      const int col = col0 + cloc;
      bs[kloc][cloc] = (k < k2 && col < n) ? bp[(size_t)k * n + col] : 0.0f;
    }
    __syncthreads();
    const int kmax = min(kChunk, k2 - kc);
    for (int k = 0; k < kmax; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float av = as[ty + i * kThreadsY][k];
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  const int c0 = col0 + tx * 4;
  if (c0 >= n) return;
  int ct[4];
  for (int e = 0; e < 4; ++e) ct[e] = (c0 + e < n) ? colt[c0 + e] : -1;
  float* cp = cov + (size_t)plane * nl * n;
  const float* crp = crow + (size_t)plane * m * n;      // crow[p, r] (M, N)
  const float* ccp = ccol + (size_t)plane * nl * m;     // ccol[p, r] (Nl, M)

  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + ty + i * kThreadsY;
    if (row >= nl) break;
    const int rt = rowt[row];
    float* dst = cp + (size_t)row * n + c0;
    float v[4];
    float cr[4];
    if (vec) {
      const float4 x = *reinterpret_cast<const float4*>(dst);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      if (rt >= 0) {
        const float4 y = *reinterpret_cast<const float4*>(
            crp + (size_t)rt * n + c0);
        cr[0] = y.x; cr[1] = y.y; cr[2] = y.z; cr[3] = y.w;
      }
    } else {
      for (int e = 0; e < 4; ++e) {
        v[e] = (c0 + e < n) ? dst[e] : 0.0f;
        if (rt >= 0) cr[e] = (c0 + e < n) ? crp[(size_t)rt * n + c0 + e] : 0.0f;
      }
    }
    for (int e = 0; e < 4; ++e) {
      float base = v[e];
      if (rt >= 0 && rt >= ct[e]) {
        base = cr[e];
      } else if (ct[e] >= 0) {
        base = ccp[(size_t)row * m + ct[e]];
      }
      v[e] = base - acc[i][e];
    }
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4; ++e)
        if (c0 + e < n) dst[e] = v[e];
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int grid_update(void* cov, const void* a, const void* b,
                           const void* crow, const void* ccol,
                           const void* rowt, const void* colt, int nl, int n,
                           int m, void* stream) {
  if (nl <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((n + kTileCols - 1) / kTileCols,
                  (nl + kTileRows - 1) / kTileRows, 4);
  grid_update_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (float*)cov, (const float*)a, (const float*)b, (const float*)crow,
      (const float*)ccol, (const int*)rowt, (const int*)colt, nl, n, m);
  return (int)cudaGetLastError();
}
