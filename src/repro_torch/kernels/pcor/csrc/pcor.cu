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
// (G 11,000, S 321) 3.88e10 FLOP.  On the CUDA cores (67 TFLOP/s of
// float32) that is 0.58 ms; the first port of this kernel ran there, both
// halves of C, at about a third of that peak.  TF32 alone keeps about
// three decimal digits and would miss the 1e-5 limit, so the products run
// as 3xTF32 on the tensor cores: z = hi + lo with hi = tf32(z) and
// lo = tf32(z - hi), and hi.hi + hi.lo + lo.hi accumulated in f32 (lo.lo,
// below 2^-22 of a term, is dropped).  Three TF32 products at 495 TFLOP/s
// give 0.24 ms for the full matrix, above the 0.15 ms of its 484 MB output
// at 3.35 TB/s.  Two launches on one stream:
//   1. split_rows: one warp per row, the mean (sum x 1/S) and inv in two
//      passes over the row, each reduced with a fixed shuffle tree, then
//      z_hi and z_lo into two (G, S_pad) scratch matrices, S padded with
//      zeros to a multiple of 16.  The Pallas kernel kept the standardised
//      rows in VMEM; here they reach device memory once (31 MB at the
//      SPRINT size, against a 484 MB output) so that whole K-major tiles
//      go to shared memory by TMA.
//   2. corr_pairs: one CTA per 128 x 128 tile pair (I, J), I <= J, of one
//      triangle.  A producer warp feeds a ring of 3 stages, each 16
//      samples of A_hi, A_lo, B_hi and B_lo (rows 128 I and 128 J, 64-byte
//      rows in the 64 B swizzle) by TMA, with "full" (transaction bytes)
//      and "empty" mbarriers.  Two consumer warpgroups, 64 rows of A each,
//      issue per 8 samples wgmma m64n128k8 lo.hi, hi.lo, then hi.hi into
//      one f32 accumulator.  97 KB of shared memory and at most 112
//      registers a thread keep two CTAs on each SM, so one CTA's epilogue
//      runs beside the other's products.  On an H100 a persistent grid
//      (one CTA an SM, storer warps writing one tile while the consumers
//      compute the next) was slower (exploration; the variant is not
//      kept).
// The orientation is canonical, and that keeps strips exact: tiles are
// aligned to absolute rows, and C[i][j] is always the value that tile pair
// (tile(min(i, j)), tile(max(i, j))) computes at position (min, max), the
// lower index's rows as A.  A strip computes every pair its rows touch
// (kernel.py::plan lists them in the grid's order) and stores only its own
// rows: a pair's A rows as computed, its B rows transposed, and in a
// diagonal pair the upper triangle and its mirror.  So a strip's element
// comes from the same operands, the same k order and the same tile
// position as the full matrix's, whatever row_start is, and C == C^T bit
// for bit.  The epilogue goes through shared memory (the ring, once every
// product has read it): each orientation is written there from the
// accumulator fragment, then stored as coalesced 16-byte rows.
// No atomics and one fixed summation order per element: a strip's bytes
// are the same in every run and equal the full matrix's rows bit for bit
// (SPRINT's quorum digests rely on it).
//
// Plain C interface for ctypes; returns 0, a CUDA error of the launches,
// or kEncodeError + the CUresult of a failed tensor-map encode.  Launches
// on the caller's stream, allocates nothing: z is (2, G, S_pad) float32
// scratch from the caller.
#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32_wgmma.cuh"

namespace {

constexpr int kTile = 128;                         // output tile edge
constexpr int kDepth = 16;                         // samples per stage
constexpr int kStages = 3;
constexpr int kOperandBytes = kTile * kDepth * 4;  // one 128 x 16 f32 tile
constexpr int kStageBytes = 4 * kOperandBytes;     // A hi, A lo, B hi, B lo
constexpr int kRowBytes = kDepth * 4;              // one swizzle span: 64 B
constexpr int kSwizzle64 = 2;                      // descriptor layout code
constexpr int kConsumers = 256;                    // two warpgroups
constexpr int kThreads = kConsumers + 32;          // and the producer warp
constexpr int kEpiStride = kTile + 4;              // floats per buffer row
constexpr int kSmemBytes = kStages * kStageBytes + 1024;
constexpr int kStatsWarps = 8;                     // rows per split block
constexpr int kEncodeError = 10000;
static_assert(kTile * kEpiStride * 4 <= kStages * kStageBytes,
              "the epilogue buffer reuses the ring");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__global__ void __launch_bounds__(kStatsWarps * 32)
split_rows(const float* __restrict__ x, float* __restrict__ zhi,
           float* __restrict__ zlo, int g, int s, int s_pad, float inv_s) {
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
  const float inv = rsqrtf(fmaxf(warp_sum(ss), 1e-30f));
  float* hr = zhi + static_cast<size_t>(row) * s_pad;
  float* lr = zlo + static_cast<size_t>(row) * s_pad;
  for (int k = lane; k < s_pad; k += 32) {
    const float z = k < s ? (xr[k] - m) * inv : 0.f;
    const float hi = tf32::round_tf32(z);
    hr[k] = hi;
    lr[k] = tf32::round_tf32(z - hi);
  }
}

// Tile pair idx of a strip whose rows lie in tiles [t0, t1], of nt tiles
// (kernel.py::plan lists the same order): first the pairs (I, J) with
// I < t0 <= J <= t1, whose B rows alone lie in the strip, then for each
// I in [t0, t1] the pairs (I, J), J in [I, nt).
__device__ __forceinline__ void pair_of(int idx, int nt, int t0, int t1,
                                        int& I, int& J) {
  const int width = t1 - t0 + 1;
  if (idx < t0 * width) {
    I = idx / width;
    J = t0 + idx % width;
    return;
  }
  idx -= t0 * width;
  I = t0;
  while (idx >= nt - I) {
    idx -= nt - I;
    ++I;
  }
  J = I + idx;
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// rows [lo, hi) of the tile in buf (global rows row0 + r, columns col0 +
// c) to out, whose row 0 is global row row_start; 16-byte streaming
// stores where the row is aligned and whole, else one word at a time
__device__ __forceinline__ void store_rows(const float* buf, float* out,
                                           int row0, int col0, int lo,
                                           int hi, int g, int row_start,
                                           bool vec) {
  const int chunk = threadIdx.x % 32;
  const int col = col0 + 4 * chunk;
  for (int r = threadIdx.x / 32; r < kTile; r += kConsumers / 32) {
    const int row = row0 + r;
    if (row < lo || row >= hi) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(buf + r * kEpiStride + 4 * chunk);
    float* dst = out + static_cast<size_t>(row - row_start) * g + col;
    if (vec && col + 3 < g) {
      __stcs(reinterpret_cast<float4*>(dst), v);
    } else {
      if (col < g) dst[0] = v.x;
      if (col + 1 < g) dst[1] = v.y;
      if (col + 2 < g) dst[2] = v.z;
      if (col + 3 < g) dst[3] = v.w;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
corr_pairs(const __grid_constant__ CUtensorMap thi,
           const __grid_constant__ CUtensorMap tlo, float* __restrict__ out,
           int g, int n_k, int row_start, int row_count, int t0, int t1,
           int nt) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const uint32_t raw = tf32::smem_addr(smem_raw);
  uint8_t* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  int I, J;
  pair_of(blockIdx.x, nt, t0, t1, I, J);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      tf32::mbar_init(&full[s], 1);
      tf32::mbar_init(&empty[s], kConsumers);
    }
    tf32::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every copy, each into a stage once its
    // last readers have left
    if (threadIdx.x != kConsumers) return;
    for (int k = 0; k < n_k; ++k) {
      const int s = k % kStages;
      tf32::mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
      tf32::mbar_expect_tx(&full[s], kStageBytes);
      uint8_t* st = ring + s * kStageBytes;
      const int c = k * kDepth;
      tf32::tma_load_2d(st, &thi, &full[s], c, I * kTile);
      tf32::tma_load_2d(st + kOperandBytes, &tlo, &full[s], c, I * kTile);
      tf32::tma_load_2d(st + 2 * kOperandBytes, &thi, &full[s], c,
                        J * kTile);
      tf32::tma_load_2d(st + 3 * kOperandBytes, &tlo, &full[s], c,
                        J * kTile);
    }
    return;
  }

  // consumer warpgroup wg: A rows [64 wg, 64 wg + 64) of the tile
  const int wg = threadIdx.x / 128;
  const uint32_t ring_addr = tf32::smem_addr(ring);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < n_k; ++k) {
    const int s = k % kStages;
    tf32::mbar_wait(&full[s], (k / kStages) & 1);
    const uint32_t st = ring_addr + s * kStageBytes;
    const uint32_t a_hi = st + wg * 64 * kRowBytes;
    const uint32_t a_lo = a_hi + kOperandBytes;
    const uint32_t b_hi = st + 2 * kOperandBytes;
    const uint32_t b_lo = st + 3 * kOperandBytes;
    tf32::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDepth / 8; ++kk) {
      const uint32_t off = kk * 32;   // 8 f32 of the 64-byte row
      const uint32_t sbo = 8 * kRowBytes;
      const uint64_t dah = tf32::make_desc(a_hi + off, 16, sbo, kSwizzle64);
      const uint64_t dal = tf32::make_desc(a_lo + off, 16, sbo, kSwizzle64);
      const uint64_t dbh = tf32::make_desc(b_hi + off, 16, sbo, kSwizzle64);
      const uint64_t dbl = tf32::make_desc(b_lo + off, 16, sbo, kSwizzle64);
      tf32::wgmma_tf32_128(acc, dal, dbh, 1);
      tf32::wgmma_tf32_128(acc, dah, dbl, 1);
      tf32::wgmma_tf32_128(acc, dah, dbh, 1);
    }
    tf32::wgmma_commit();
    if (k > 0) {                       // stage k - 1's products are done
      tf32::wgmma_wait<1>();
      tf32::mbar_arrive(&empty[(k - 1) % kStages]);
    }
  }
  tf32::wgmma_wait<0>();
  tf32::fence_regs(acc);
  consumer_sync();                     // every product has read the ring

  // Fragment of the 64 x 128 accumulator: index i holds row r_f + 8 *
  // ((i / 2) % 2), column (i / 4) * 8 + c_f + i % 2
  const int lane = threadIdx.x % 32;
  const int r_f = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int c_f = (lane % 4) * 2;
  float* buf = reinterpret_cast<float*>(ring);
  const int row_end = row_start + row_count;
  const int a0 = I * kTile, b0 = J * kTile;
  const bool diag = I == J;
  const bool a_in = a0 < row_end && a0 + kTile > row_start;
  const bool b_in = !diag && b0 < row_end && b0 + kTile > row_start;
  const bool vec = g % 4 == 0;
  if (a_in) {
    // the pair's A rows: C as computed; a diagonal pair's upper triangle
    // and its mirror
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = r_f + 8 * ((i / 2) % 2);
      const int c = (i / 4) * 8 + c_f;
      if (!diag) {
        *reinterpret_cast<float2*>(buf + r * kEpiStride + c) =
            make_float2(acc[i], acc[i + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e >= r) {
            buf[r * kEpiStride + c + e] = acc[i + e];
            buf[(c + e) * kEpiStride + r] = acc[i + e];
          }
        }
      }
    }
    consumer_sync();
    store_rows(buf, out, a0, b0, max(a0, row_start),
               min(a0 + kTile, row_end), g, row_start, vec);
  }
  if (b_in) {
    // the pair's B rows: C transposed
    if (a_in) consumer_sync();         // the stores above have read buf
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = r_f + 8 * ((i / 2) % 2);
      const int c = (i / 4) * 8 + c_f + i % 2;
      buf[c * kEpiStride + r] = acc[i];
    }
    consumer_sync();
    store_rows(buf, out, b0, a0, max(b0, row_start),
               min(b0 + kTile, row_end), g, row_start, vec);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, cols) f32 matrix as a rank-2 map, boxes of kDepth x kTile in
// the 64 B swizzle; rows past the matrix arrive as zeros
int encode(CUtensorMap* map, const float* base, int rows, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {kDepth, kTile};
  const cuuint32_t ones[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                        const_cast<float*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

}  // namespace

// n_pairs: the length of kernel.py::plan(g, row_start, row_count), checked
// here against the same count.  s_pad: a multiple of 16, at least s.
extern "C" int pcor_rows(const void* x, void* z, void* out, int g, int s,
                         int s_pad, int row_start, int row_count,
                         long long n_pairs, void* stream) {
  if (g <= 0 || s <= 0 || row_count <= 0) return 0;
  if (s_pad < s || s_pad % kDepth != 0 || row_start < 0 ||
      row_start + row_count > g)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = (g + kTile - 1) / kTile;
  const int t0 = row_start / kTile;
  const int t1 = (row_start + row_count - 1) / kTile;
  long long count = static_cast<long long>(t0) * (t1 - t0 + 1);
  for (int i = t0; i <= t1; ++i) count += nt - i;
  if (count != n_pairs || count > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* zhi = static_cast<float*>(z);
  float* zlo = zhi + static_cast<size_t>(g) * s_pad;
  split_rows<<<(g + kStatsWarps - 1) / kStatsWarps, kStatsWarps * 32, 0,
               st>>>(static_cast<const float*>(x), zhi, zlo, g, s, s_pad,
                     1.0f / static_cast<float>(s));
  CUtensorMap thi, tlo;
  int err = encode(&thi, zhi, g, s_pad);
  if (err == 0) err = encode(&tlo, zlo, g, s_pad);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      corr_pairs, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  corr_pairs<<<static_cast<unsigned>(count), kThreads, kSmemBytes, st>>>(
      thi, tlo, static_cast<float*>(out), g, s_pad / kDepth, row_start,
      row_count, t0, t1, nt);
  return static_cast<int>(cudaGetLastError());
}
