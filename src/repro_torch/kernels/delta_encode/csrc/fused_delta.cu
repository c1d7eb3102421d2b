// Delta kernels for Hopper (sm_90a) over (nblk, 8, 1024) int32 tiles.
//
// fused_delta_tiles, the fused delta probe: flag, prefix and compacted
// write of each tile in one pass.
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
// runs in sequence and an SMEM slot counter.  CUDA blocks run in no order;
// the first port split the work into a flag pass, a one-block scan and a
// scatter pass that read the changed tiles again (5N when every tile
// changed).  This design is one launch with a decoupled look-back, as
// CUB's single-pass scan does:
//   - blocks take tile indices from an atomic ticket, so that every tile
//     a block waits on belongs to a block that is already running;
//   - a block reads old and new of its tile with 16-byte loads and keeps
//     the XOR in registers (8 int4 a thread), the flag from
//     __syncthreads_or;
//   - it publishes the flag as the tile's aggregate, then warp 0 sums its
//     predecessors' status words 32 at a time, from the nearest back,
//     until it meets an inclusive prefix, and publishes its own inclusive
//     prefix (state and count share one 32-bit word, so one store
//     publishes both);
//   - the block then writes its XOR tile to slot = exclusive prefix, if
//     the tile changed, and its bitmap entry.
// The grid is persistent (3 blocks an SM, two tiles of registers a
// thread): a block takes its next ticket and issues that tile's loads
// before it looks back for the current one, so the look-back's waits on
// L2 overlap the next reads.  On an H100, one block per tile with no such
// overlap was slower, and so were more blocks an SM at fewer registers
// and several tiles a block (exploration; the variants are not kept).
// So it reads 2N and writes k tiles: 3N when every tile changed.  The
// scratch (ticket and one status word per tile) comes from the caller and
// is zeroed by one cudaMemsetAsync on the caller's stream before each
// launch, so no launch reads a previous one's status.
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
// cudaGetLastError() after its launches (fused_delta_tiles: or the error
// of its memset).  Launches on the caller's stream, allocates nothing.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kTileInts = 8 * 1024;
constexpr int kTileVecs = kTileInts / 4;   // int4 per tile: 2048
constexpr int kThreads = 256;
constexpr int kVecsPerThread = kTileVecs / kThreads;      // 8
// a tile's status word: the state in the top two bits, a count below
constexpr unsigned kAggregate = 1u << 30;   // the tile's own flag
constexpr unsigned kPrefix = 2u << 30;      // changed tiles up to and
                                            // including this one
constexpr unsigned kCountMask = kAggregate - 1;
// two tiles of registers a thread (the current and the next) leave room
// for 3 blocks of the probe on an SM
constexpr int kFusedBlocksPerSM = 3;
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

// the XOR of tile v of old and new, kVecsPerThread int4 a thread
__device__ __forceinline__ void load_xor(int4 (&d)[kVecsPerThread],
                                         const int4* __restrict__ o,
                                         const int4* __restrict__ n,
                                         unsigned v) {
  const size_t base = static_cast<size_t>(v) * kTileVecs + threadIdx.x;
  const int4* po = o + base;
  const int4* pn = n + base;
#pragma unroll
  for (int u = 0; u < kVecsPerThread; ++u) {
    const int4 a = po[u * kThreads];
    const int4 b = pn[u * kThreads];
    d[u] = make_int4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
}

// warp 0: the changed tiles before tile v > 0, from the status words of
// its predecessors, 32 at a time from the nearest back, until an
// inclusive prefix is met
__device__ __forceinline__ unsigned look_back(volatile unsigned* status,
                                              unsigned v) {
  const int lane = threadIdx.x;
  unsigned excl = 0;
  for (long long end = v; end > 0; end -= 32) {
    const long long p = end - 32 + lane;   // lane 31 the nearest
    unsigned w = kPrefix;                  // before tile 0: a prefix of 0
    if (p >= 0) {
      do {
        w = status[p];
      } while ((w & ~kCountMask) == 0);
    }
    const unsigned prefixes =
        __ballot_sync(0xffffffffu, (w & ~kCountMask) == kPrefix);
    // sum from the nearest prefix on (all 32 if there is none)
    const int first = prefixes ? 31 - __clz(prefixes) : 0;
    unsigned c = lane >= first ? (w & kCountMask) : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, d);
    excl += c;
    if (prefixes) break;
  }
  return excl;
}

// scratch[0]: the ticket; scratch[1 + v]: the status word of tile v.  A
// persistent grid: each block takes tiles from the ticket one after the
// other, and loads its next tile while it looks back for the current one.
__global__ void __launch_bounds__(kThreads, kFusedBlocksPerSM)
fused_tiles(const int4* __restrict__ o, const int4* __restrict__ n,
            int* __restrict__ bitmap, int4* __restrict__ tiles,
            unsigned* scratch, long long nblk) {
  __shared__ unsigned s_next, s_slot;
  volatile unsigned* status = scratch + 1;
  if (threadIdx.x == 0) s_next = atomicAdd(scratch, 1u);
  __syncthreads();
  unsigned v = s_next;
  if (v >= nblk) return;
  int4 d[kVecsPerThread], e[kVecsPerThread];
  load_xor(d, o, n, v);
  while (true) {
    int acc = 0;
#pragma unroll
    for (int u = 0; u < kVecsPerThread; ++u)
      acc |= d[u].x | d[u].y | d[u].z | d[u].w;
    const unsigned flag = __syncthreads_or(acc != 0) ? 1u : 0u;
    if (threadIdx.x == 0) {
      // publish the aggregate (tile 0: its prefix), then take the next
      // tile: a tile is only ever waited on once its aggregate is out
      status[v] = (v == 0 ? kPrefix : kAggregate) | flag;
      s_next = atomicAdd(scratch, 1u);
    }
    __syncthreads();
    const unsigned vn = s_next;
    if (vn < nblk) load_xor(e, o, n, vn);  // in flight during the look-back
    if (threadIdx.x < 32) {
      const unsigned excl = v == 0 ? 0u : look_back(status, v);
      if (threadIdx.x == 0) {
        if (v > 0) status[v] = kPrefix | (excl + flag);
        s_slot = excl;
      }
    }
    __syncthreads();
    if (flag) {
      int4* dst =
          tiles + static_cast<size_t>(s_slot) * kTileVecs + threadIdx.x;
#pragma unroll
      for (int u = 0; u < kVecsPerThread; ++u) dst[u * kThreads] = d[u];
    }
    if (threadIdx.x == 0) bitmap[v] = static_cast<int>(flag);
    if (vn >= nblk) break;
#pragma unroll
    for (int u = 0; u < kVecsPerThread; ++u) d[u] = e[u];
    v = vn;
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

// scratch: nblk + 1 words (the ticket and the tiles' status words)
extern "C" int fused_delta_tiles(const void* o32, const void* n32,
                                 void* bitmap, void* tiles, void* scratch,
                                 long long nblk, void* stream) {
  if (nblk <= 0) return 0;
  if (nblk > static_cast<long long>(kCountMask))
    return static_cast<int>(cudaErrorInvalidValue);
  static int per_sm = 0;                 // resident blocks an SM holds
  if (per_sm == 0) {
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_tiles, kThreads, 0);
    if (occ != cudaSuccess) return static_cast<int>(occ);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, (nblk + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      std::min(nblk, static_cast<long long>(sms) * std::max(per_sm, 1));
  fused_tiles<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const int4*>(o32), static_cast<const int4*>(n32),
      static_cast<int*>(bitmap), static_cast<int4*>(tiles),
      static_cast<unsigned*>(scratch), nblk);
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
