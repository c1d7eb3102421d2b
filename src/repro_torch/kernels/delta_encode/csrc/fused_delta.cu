// Delta kernels for Hopper (sm_90a) over (nblk, 8, 1024) int32 tiles.
//
// fused_delta_tiles, the fused delta probe: flag, exclusive scan, scatter.
// Replaces src/repro/kernels/delta_encode/kernel.py::fused_delta_tiles
// (Pallas body _fused_kernel).  Inputs are old/new states viewed as
// (nblk, 8, 1024) int32 tiles.  Outputs: bitmap[i] = any(old ^ new) over
// tile i, and the k changed XOR tiles compacted into tiles[0, k) in
// ascending tile order (the host recovers tile indices from the bitmap
// alone, so the order is part of the contract).
//
// What bounds it: bytes.  No arithmetic to speak of; the least the card
// can move is old + new read once plus k tiles written (3N when every tile
// changed, as under AdamW).  The TPU kernel got its order from a grid that
// runs in sequence and an SMEM slot counter.  CUDA blocks run in no order,
// so this design splits the work in three launches on one stream:
//   1. flag:    one block per tile, 16-byte loads of old and new, OR of the
//               XOR words, __syncthreads_or -> bitmap[i];
//   2. scan:    one block computes offs = exclusive_scan(bitmap) in chunks
//               of 1024 with a carried total (nblk is at most ~12k here);
//   3. scatter: one block per changed tile recomputes the XOR and writes
//               it to slot offs[i].
// The flag pass reads 2N; the scatter pass reads the k changed tiles of
// old and new again and writes k tiles.  That is 5N when every tile
// changed, against the 3N minimum; a single-pass decoupled look-back
// would reach 3N.
//
// The one-shot delta API's three kernels, each one pass with 16-byte
// loads, bounded by bytes like the probe (the first two one block per
// tile, for the tile's flag):
//   changed_bitmap  replaces kernel.py::changed_bitmap (_bitmap_kernel):
//                   the flag pass alone, reads 2N;
//   delta_encode    replaces kernel.py::delta_encode (_delta_kernel): the
//                   XOR tile and its flag, reads 2N and writes N;
//   delta_apply     replaces kernel.py::delta_apply (_apply_kernel):
//                   new = old ^ delta, reads 2N and writes N.
// Each reads every input byte once and writes every output byte once,
// the least these functions can move.
//
// delta_apply has no per-tile output, so it need not follow the tiles:
// it streams the flat int4 range, one 128-thread block per 4 KB of each
// operand, each thread issuing both of its 16-byte loads of each operand
// before its stores, the shape of PyTorch's own vectorized elementwise
// kernels.  On the card a grid-stride grid of a few blocks per SM, deeper
// unrolls and streaming cache hints were each slower, not faster
// (chip_smoke.py's delta_ops phase times it beside torch.bitwise_xor).
//
// Plain C interface for ctypes; each entry point returns
// cudaGetLastError() after its launches.  Launches on the caller's
// stream, allocates nothing.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kTileInts = 8 * 1024;
constexpr int kTileVecs = kTileInts / 4;   // int4 per tile: 2048
constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kApplyThreads = 128;
constexpr int kApplyUnroll = 2;
constexpr int kApplyStep = kApplyThreads * kApplyUnroll;   // int4 per block
static_assert(kTileVecs % kApplyStep == 0, "whole tiles, no ragged edge");

__global__ void __launch_bounds__(kThreads)
flag_tiles(const int4* __restrict__ o, const int4* __restrict__ n,
           int* __restrict__ bitmap) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kTileVecs;
  int acc = 0;
#pragma unroll
  for (int j = threadIdx.x; j < kTileVecs; j += kThreads) {
    const int4 a = o[base + j];
    const int4 b = n[base + j];
    acc |= (a.x ^ b.x) | (a.y ^ b.y) | (a.z ^ b.z) | (a.w ^ b.w);
  }
  const int any = __syncthreads_or(acc != 0);
  if (threadIdx.x == 0) bitmap[blockIdx.x] = any ? 1 : 0;
}

__global__ void __launch_bounds__(kScanThreads)
exclusive_scan(const int* __restrict__ bitmap, int* __restrict__ offs,
               long long nblk) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long start = 0; start < nblk; start += kScanThreads) {
    const long long i = start + threadIdx.x;
    const int v = i < nblk ? bitmap[i] : 0;
    int x = v;                                  // inclusive scan in the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {                            // scan of the warp totals
      int w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int excl = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (i < nblk) offs[i] = excl;
    __syncthreads();                            // every read of carry done
    if (threadIdx.x == kScanThreads - 1) carry = excl + v;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_tiles(const int4* __restrict__ o, const int4* __restrict__ n,
              const int* __restrict__ bitmap, const int* __restrict__ offs,
              int4* __restrict__ tiles) {
  if (!bitmap[blockIdx.x]) return;
  const size_t src = static_cast<size_t>(blockIdx.x) * kTileVecs;
  const size_t dst = static_cast<size_t>(offs[blockIdx.x]) * kTileVecs;
#pragma unroll
  for (int j = threadIdx.x; j < kTileVecs; j += kThreads) {
    const int4 a = o[src + j];
    const int4 b = n[src + j];
    tiles[dst + j] = make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
}

__global__ void __launch_bounds__(kThreads)
encode_tiles(const int4* __restrict__ o, const int4* __restrict__ n,
             int4* __restrict__ delta, int* __restrict__ bitmap) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kTileVecs;
  int acc = 0;
#pragma unroll
  for (int j = threadIdx.x; j < kTileVecs; j += kThreads) {
    const int4 a = o[base + j];
    const int4 b = n[base + j];
    const int4 d = make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
    delta[base + j] = d;
    acc |= d.x | d.y | d.z | d.w;
  }
  const int any = __syncthreads_or(acc != 0);
  if (threadIdx.x == 0) bitmap[blockIdx.x] = any ? 1 : 0;
}

// out = o ^ d over gridDim.x * kApplyStep int4
__global__ void __launch_bounds__(kApplyThreads)
xor_flat(const int4* __restrict__ o, const int4* __restrict__ d,
         int4* __restrict__ out) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kApplyStep
                      + threadIdx.x;
  int4 a[kApplyUnroll], b[kApplyUnroll];
#pragma unroll
  for (int u = 0; u < kApplyUnroll; ++u) {
    a[u] = o[base + u * kApplyThreads];
    b[u] = d[base + u * kApplyThreads];
  }
#pragma unroll
  for (int u = 0; u < kApplyUnroll; ++u)
    out[base + u * kApplyThreads] =
        make_int4(a[u].x ^ b[u].x, a[u].y ^ b[u].y, a[u].z ^ b[u].z,
                  a[u].w ^ b[u].w);
}

}  // namespace

extern "C" int fused_delta_tiles(const void* o32, const void* n32,
                                 void* bitmap, void* tiles, void* offs,
                                 long long nblk, void* stream) {
  if (nblk <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* o = static_cast<const int4*>(o32);
  const int4* n = static_cast<const int4*>(n32);
  int* bm = static_cast<int*>(bitmap);
  int* off = static_cast<int*>(offs);
  const unsigned grid = static_cast<unsigned>(nblk);
  flag_tiles<<<grid, kThreads, 0, s>>>(o, n, bm);
  exclusive_scan<<<1, kScanThreads, 0, s>>>(bm, off, nblk);
  scatter_tiles<<<grid, kThreads, 0, s>>>(o, n, bm, off,
                                         static_cast<int4*>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int changed_bitmap(const void* o32, const void* n32, void* bitmap,
                              long long nblk, void* stream) {
  if (nblk <= 0) return 0;
  flag_tiles<<<static_cast<unsigned>(nblk), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(o32), static_cast<const int4*>(n32),
      static_cast<int*>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delta_encode(const void* o32, const void* n32, void* delta,
                            void* bitmap, long long nblk, void* stream) {
  if (nblk <= 0) return 0;
  encode_tiles<<<static_cast<unsigned>(nblk), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(o32), static_cast<const int4*>(n32),
      static_cast<int4*>(delta), static_cast<int*>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int delta_apply(const void* o32, const void* d32, void* out,
                           long long nblk, void* stream) {
  if (nblk <= 0) return 0;
  const long long blocks = nblk * (kTileVecs / kApplyStep);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  xor_flat<<<static_cast<unsigned>(blocks), kApplyThreads, 0,
             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(o32), static_cast<const int4*>(d32),
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
