// Deferred rank-2M landmark-grid pass, for sm_90a.
//
// Replaces the TPU kernel shermbot_navigation_tpu/ops/pallas/grid_update.py
// (fused_grid_update). Per comp plane (p, r) of the grid cov (2, 2, Nl, N)
// of each of B worlds (one launch; the JAX package vmaps the TPU kernel):
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
// Design: a pipelined walk. A block of 64 x 4 threads owns a strip of 256
// columns of one plane over a run of rows and walks down it in tiles of 16
// rows. Its columns of B[r] (2M x 256) and of colt are loaded once for the
// whole walk. The grid tiles arrive through a ring of two slots in shared
// memory filled by cp.async: the load of the next tile is in flight while
// this tile is multiplied and stored, and the tile's rows of A and of rowt
// ride in the same copy group. (Two slots, not more: the pass wants blocks
// an SM, not depth, and a deeper ring's shared memory costs occupancy.) Every thread copies
// exactly the 16 bytes a row it will consume (4 rows x 4 columns), and a
// warp's four A rows are copied by that warp into its own slot, so the
// steady state needs only the thread's own cp.async.wait_group and a
// __syncwarp(): no block barrier after the one behind B. Stores are 16
// bytes a thread straight from registers. crow and ccol are touched only
// where the tick had an init on that row or column.
// A plane whose rows are not 16-byte aligned (N % 4 != 0, or an odd base
// address) takes plain loads and stores inside the same walk. K-chunks of
// at most 64 keep B within shared memory: a larger 2M runs as further
// launches that subtract their products from the grid the first one wrote.
//
// Worlds: the launch grid's z runs over the 4 B (world, plane) pairs,
// z = 4 world + plane; each operand has its world's slab at a fixed
// stride, so a world's outputs do not depend on B.
//
// In place: the kernel writes into cov's own storage. That is safe because
// each element is read and then written by the same thread only. (The JAX
// version donates the input buffer to the output instead.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 16;
constexpr int kTileCols = 256;
constexpr int kThreadsX = kTileCols / 4;           // 64: 4 columns each
constexpr int kThreadsY = 4;                       // 4 rows each
constexpr int kRowsPerThread = kTileRows / kThreadsY;
constexpr int kMaxChunk = 64;                      // K values a launch
constexpr int kStages = 2;     // ring slots: the tile in use + the next

__device__ __forceinline__ void cp_async16(const void* smem_dst,
                                           const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(const void* smem_dst,
                                          const void* gmem_src) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's copy groups (the next tile's) is
// in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Shared memory (floats): B strip [kc][256], then per stage the tile
// [16][256] and, for each of the two warps that share a row group, its
// copy of the A rows [2][16][kcp] and of rowt [2][16].
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
grid_update_kernel(float* __restrict__ cov, const float* __restrict__ a,
                   const float* __restrict__ b,
                   const float* __restrict__ crow,
                   const float* __restrict__ ccol,
                   const int* __restrict__ rowt,
                   const int* __restrict__ colt, int nl, int n, int m,
                   int k_off, int kc, int replay, int rows_per_block,
                   int vec) {
  extern __shared__ __align__(16) float smem[];
  const int kcp = (kc + 3) & ~3;                   // A row stride, 16 bytes
  float* const bs = smem;                          // [kc][256]
  const int stage_floats =
      kTileRows * kTileCols + 2 * (kTileRows * kcp + kTileRows);
  float* const ring = smem + kc * kTileCols;

  const int plane = blockIdx.z & 3;    // p * 2 + r
  const size_t world = blockIdx.z >> 2;
  const int pp = plane >> 1;
  const int rr = plane & 1;
  const int row_begin = blockIdx.y * rows_per_block;
  const int row_end = min(nl, row_begin + rows_per_block);
  const int col0 = blockIdx.x * kTileCols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kThreadsX + tx;
  const int lane = tid & 31;
  const int half = tx >> 5;            // which of the row group's two warps
  const int k2 = 2 * m;
  const int c0 = col0 + tx * 4;
  const int n_tiles = (row_end - row_begin + kTileRows - 1) / kTileRows;

  const float* ap = a + (world * 2 + pp) * nl * k2 + k_off;   // A[p] (Nl, 2M)
  const float* bp = b + ((world * 2 + rr) * k2 + k_off) * n;  // B[r] (2M, N)
  float* cp = cov + (world * 4 + plane) * nl * n;
  const float* crp = crow + (world * 4 + plane) * m * n;  // crow[p, r] (M, N)
  const float* ccp = ccol + (world * 4 + plane) * nl * m; // ccol[p, r] (Nl, M)
  const int* rtp = rowt + world * nl;
  const int* ctp = colt + world * n;

  // tile t of this block into its ring slot: this thread's 16 bytes of
  // each of its 4 rows; this warp's 4 rows of A and of rowt
  auto request = [&](int t) {
    float* st = ring + (size_t)(t % kStages) * stage_floats;
    float* as = st + kTileRows * kTileCols + half * kTileRows * kcp;
    int* rts = reinterpret_cast<int*>(st + kTileRows * kTileCols +
                                      2 * kTileRows * kcp) + half * kTileRows;
    const int row0 = row_begin + t * kTileRows;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int rl = ty + i * kThreadsY;
      const int row = row0 + rl;
      if (row >= row_end) continue;
      if (vec && c0 < n)
        cp_async16(st + rl * kTileCols + tx * 4, cp + (size_t)row * n + c0);
      for (int k = lane; k < kc; k += 32)
        cp_async4(as + rl * kcp + k, ap + (size_t)row * k2 + k);
      if (lane == 0) cp_async4(rts + rl, rtp + row);
    }
  };

  if (n_tiles > 0) request(0);
  cp_async_commit();

  // B strip and this thread's colt, once for the walk
  for (int idx = tid; idx < kc * kThreadsX; idx += kThreadsX * kThreadsY) {
    const int k = idx / kThreadsX;
    const int c = col0 + (idx % kThreadsX) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (vec && c < n) {
      v = *reinterpret_cast<const float4*>(bp + (size_t)k * n + c);
    } else {
      if (c + 0 < n) v.x = bp[(size_t)k * n + c + 0];
      if (c + 1 < n) v.y = bp[(size_t)k * n + c + 1];
      if (c + 2 < n) v.z = bp[(size_t)k * n + c + 2];
      if (c + 3 < n) v.w = bp[(size_t)k * n + c + 3];
    }
    *reinterpret_cast<float4*>(bs + k * kTileCols + (idx % kThreadsX) * 4) = v;
  }
  int ct[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    ct[e] = (replay && c0 + e < n) ? ctp[c0 + e] : -1;
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    // the slot freed by tile t - 1 takes tile t + 1
    if (t + 1 < n_tiles) request(t + 1);
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncwarp();   // this warp's A rows and rowt, copied by its lanes

    const float* st = ring + (size_t)(t % kStages) * stage_floats;
    const float* as = st + kTileRows * kTileCols + half * kTileRows * kcp;
    const int* rts = reinterpret_cast<const int*>(
        st + kTileRows * kTileCols + 2 * kTileRows * kcp) + half * kTileRows;
    const int row0 = row_begin + t * kTileRows;

    float acc[kRowsPerThread][4];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
    int k = 0;
    for (; k + 4 <= kc; k += 4) {
      float4 av[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            as + (ty + i * kThreadsY) * kcp + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv =
            *reinterpret_cast<const float4*>(bs + (k + q) * kTileCols + tx * 4);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float x = q == 0 ? av[i].x
                                 : (q == 1 ? av[i].y
                                           : (q == 2 ? av[i].z : av[i].w));
          acc[i][0] = fmaf(x, bv.x, acc[i][0]);
          acc[i][1] = fmaf(x, bv.y, acc[i][1]);
          acc[i][2] = fmaf(x, bv.z, acc[i][2]);
          acc[i][3] = fmaf(x, bv.w, acc[i][3]);
        }
      }
    }
    for (; k < kc; ++k) {
      const float4 bv =
          *reinterpret_cast<const float4*>(bs + k * kTileCols + tx * 4);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float x = as[(ty + i * kThreadsY) * kcp + k];
        acc[i][0] = fmaf(x, bv.x, acc[i][0]);
        acc[i][1] = fmaf(x, bv.y, acc[i][1]);
        acc[i][2] = fmaf(x, bv.z, acc[i][2]);
        acc[i][3] = fmaf(x, bv.w, acc[i][3]);
      }
    }

    if (c0 < n) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int rl = ty + i * kThreadsY;
        const int row = row0 + rl;
        if (row >= row_end) continue;
        const int rt = replay ? rts[rl] : -1;
        float* dst = cp + (size_t)row * n + c0;
        float v[4];
        if (vec) {
          const float4 x =
              *reinterpret_cast<const float4*>(st + rl * kTileCols + tx * 4);
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = (c0 + e < n) ? dst[e] : 0.0f;
        }
        if (rt >= 0) {
          // the row's last init: its strip is a candidate for all 4 columns
          float cr[4];
          if (vec) {
            const float4 y = *reinterpret_cast<const float4*>(
                crp + (size_t)rt * n + c0);
            cr[0] = y.x; cr[1] = y.y; cr[2] = y.z; cr[3] = y.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              cr[e] = (c0 + e < n) ? crp[(size_t)rt * n + c0 + e] : 0.0f;
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (rt >= ct[e]) {
              v[e] = cr[e];
            } else if (c0 + e < n) {
              v[e] = ccp[(size_t)row * m + ct[e]];
            }
          }
        } else if (ct[0] >= 0 || ct[1] >= 0 || ct[2] >= 0 || ct[3] >= 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (ct[e] >= 0) v[e] = ccp[(size_t)row * m + ct[e]];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = v[e] - acc[i][e];
        if (vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + e < n) dst[e] = v[e];
        }
      }
    }
    __syncwarp();   // every lane is done with this slot's A rows
  }
}

}  // namespace

// Returns the launch's error code (0 = launched). The operands hold
// `batch` worlds, each a slab of the one-world shapes. `rows_per_block` (a
// multiple of 16) is the walk's length, from ops/kernels/grid_update.py
// launch_plan.
extern "C" int grid_update(void* cov, const void* a, const void* b,
                           const void* crow, const void* ccol,
                           const void* rowt, const void* colt, int nl, int n,
                           int m, int batch, int rows_per_block,
                           void* stream) {
  if (nl <= 0 || n <= 0 || m <= 0 || batch <= 0 || batch > 65535 / 4 ||
      rows_per_block < kTileRows || rows_per_block % kTileRows != 0)
    return (int)cudaErrorInvalidValue;
  const int k2 = 2 * m;
  const int vec = (n % 4 == 0) && ((uintptr_t)cov % 16 == 0) &&
                  ((uintptr_t)b % 16 == 0) && ((uintptr_t)crow % 16 == 0);
  const int kc_max = min(k2, kMaxChunk);
  const int kcp = (kc_max + 3) & ~3;
  const size_t smem = sizeof(float) *
      ((size_t)kc_max * kTileCols +
       (size_t)kStages * (kTileRows * kTileCols +
                         2 * (kTileRows * kcp + kTileRows)));
  static size_t smem_set = 0;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        grid_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((n + kTileCols - 1) / kTileCols,
                  (nl + rows_per_block - 1) / rows_per_block, 4 * batch);
  for (int k_off = 0; k_off < k2; k_off += kMaxChunk) {
    const int kc = min(kMaxChunk, k2 - k_off);
    grid_update_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
        (float*)cov, (const float*)a, (const float*)b, (const float*)crow,
        (const float*)ccol, (const int*)rowt, (const int*)colt, nl, n, m,
        k_off, kc, k_off == 0 ? 1 : 0, rows_per_block, vec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
