// Pearson correlation of the rows of X for Hopper (sm_90a): the SPRINT
// pcor work unit.
//
// Replaces src/repro/kernels/pcor/kernel.py::pcor (Pallas body
// _pcor_kernel).  x is (G, S) float32, row-major.  Output: rows
// [row_start, row_start + row_count) of the (G, G) matrix
// C[i][j] = z_i . z_j, with z = (x - mean) * rsqrt(max(sum (x - mean)^2,
// 1e-30)) over the S samples of each row (the Pallas kernel's floor, on
// the variance).
//
// What bounds it: operations.  C is symmetric, so the function needs
// G (G + 1) S FLOP against G S + G^2 floats moved: at the SPRINT size
// (G 11,000, S 321) 3.88e10 FLOP, 0.58 ms at the H100's 67 TFLOP/s of
// float32 on the CUDA cores, against 0.15 ms for the 484 MB output at
// 3.35 TB/s.  This design computes both halves, 2 G^2 S FLOP.  The Pallas kernel standardised two (128, S) row
// strips in VMEM per output tile and made one MXU product; this design
// keeps that fusion (the standardised matrix never reaches device memory)
// in two launches on one stream:
//   1. row_stats: one warp per row, the masked mean (sum x 1/S) and inv in
//      two passes over the row, each reduced with a fixed shuffle tree;
//   2. corr_tiles: one 256-thread block per 64 x 64 output tile, each
//      thread a 4 x 4 register tile (rows ty + 16 r, columns tx + 16 c).  A
//      loop over S in chunks of 32 standardises x on the load into shared
//      memory (zero past G and S, so nothing is padded) and accumulates
//      with float32 FMA in k order.
// No atomics and one fixed summation order per element: C[i][j] depends
// only on rows i and j, so a strip's bytes are the same in every run and
// equal the full matrix's rows bit for bit (SPRINT's quorum digests rely
// on it).  TF32 or 3xTF32 wgmma is the step for speed.
//
// Plain C interface for ctypes; returns cudaGetLastError() after the two
// launches.  Launches on the caller's stream, allocates nothing: mean and
// inv are (G,) float32 scratch from the caller.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTile = 64;          // output tile edge
constexpr int kChunk = 32;         // samples per shared-memory stage
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each
constexpr int kStatsWarps = 8;     // rows per row_stats block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kStatsWarps * 32)
row_stats(const float* __restrict__ x, float* __restrict__ mean,
          float* __restrict__ inv, int g, int s, float inv_s) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kStatsWarps + (threadIdx.x >> 5);
  if (row >= g) return;
  const float* xr = x + static_cast<size_t>(row) * s;
  float sum = 0.f;
  for (int k = lane; k < s; k += 32) sum += xr[k];
  const float m = warp_sum(sum) * inv_s;
  float ss = 0.f;
  for (int k = lane; k < s; k += 32) {
    const float c = xr[k] - m;
    ss = fmaf(c, c, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) {
    mean[row] = m;
    inv[row] = rsqrtf(fmaxf(ss, 1e-30f));
  }
}

__global__ void __launch_bounds__(kThreads)
corr_tiles(const float* __restrict__ x, const float* __restrict__ mean,
           const float* __restrict__ inv, float* __restrict__ out, int g,
           int s, int row_start, int row_count) {
  // [k][m], one word of padding: the transposed stores hit 32 banks
  __shared__ float za[kChunk][kTile + 1];
  __shared__ float zb[kChunk][kTile + 1];
  __shared__ float stat[4][kTile];        // mean, inv of the A and B rows
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int r0 = blockIdx.y * kTile;      // strip-local row of the tile
  const int c0 = blockIdx.x * kTile;      // column (gene) of the tile
  if (threadIdx.x < kTile) {
    const int m = threadIdx.x;
    const int ra = r0 + m, cb = c0 + m;
    const int ga = row_start + (ra < row_count ? ra : 0);
    const int gb = cb < g ? cb : 0;
    stat[0][m] = mean[ga];
    stat[1][m] = ra < row_count ? inv[ga] : 0.f;
    stat[2][m] = mean[gb];
    stat[3][m] = cb < g ? inv[gb] : 0.f;
  }
  __syncthreads();
  // loader: lane lk takes sample k0 + lk of rows lr, lr + 8, ..., lr + 56
  const int lk = threadIdx.x & 31, lr = threadIdx.x >> 5;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < s; k0 += kChunk) {
    const int k = k0 + lk;
#pragma unroll
    for (int i = 0; i < kTile / 8; ++i) {
      const int m = lr + 8 * i;
      const int ra = r0 + m, cb = c0 + m;
      float va = 0.f, vb = 0.f;
      if (k < s && ra < row_count)
        va = (x[static_cast<size_t>(row_start + ra) * s + k] - stat[0][m]) *
             stat[1][m];
      if (k < s && cb < g)
        vb = (x[static_cast<size_t>(cb) * s + k] - stat[2][m]) * stat[3][m];
      za[lk][m] = va;
      zb[lk][m] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = za[kk][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = zb[kk][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + ty + 16 * r;
    if (row >= row_count) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + tx + 16 * c;
      if (col < g) out[static_cast<size_t>(row) * g + col] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int pcor_rows(const void* x, void* mean, void* inv, void* out,
                         int g, int s, int row_start, int row_count,
                         void* stream) {
  if (g <= 0 || s <= 0 || row_count <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* mf = static_cast<float*>(mean);
  float* vf = static_cast<float*>(inv);
  row_stats<<<(g + kStatsWarps - 1) / kStatsWarps, kStatsWarps * 32, 0,
              st>>>(xf, mf, vf, g, s, 1.0f / static_cast<float>(s));
  const dim3 grid((g + kTile - 1) / kTile,
                  (row_count + kTile - 1) / kTile);
  corr_tiles<<<grid, kThreads, 0, st>>>(xf, mf, vf, static_cast<float*>(out),
                                        g, s, row_start, row_count);
  return static_cast<int>(cudaGetLastError());
}
