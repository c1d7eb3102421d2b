// Flash attention forward for Hopper (sm_90a): causal or full GQA attention
// with an online softmax in f32.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (Pallas body _attn_kernel).  q is (B, H, T, hd); k and v are (B, K, S, hd)
// with H % K == 0; o is (B, H, T, hd) in q's dtype (f32 or bf16).  Each of
// the four is read or written through its own batch, head and row strides
// (hd contiguous, base and strides 16-byte aligned), so the model's
// (B, T, H, hd) tensors come in and go out as transposed views, uncopied.
// Query head h reads KV head h / (H / K) in place, for any whole group
// (hymba-1.5b's is 5): no repeated copy of K or V.  Keys at or past s_valid
// are masked; with causal, key j is masked for query i when j > i, both
// counted from 0.  The running max, denominator (floored at 1e-30) and
// accumulator stay in f32.  KV tiles whose keys are all masked for a row
// block are skipped: they would add exactly nothing.
//
// What bounds it: operations, at the serving path's long prompts.  At
// granite-3-2b's prefill shapes (H 32, K 8, hd 64, bf16) the causal half of
// 4*H*T^2*hd operations at 989 TFLOP/s (dense bf16) outweighs the bytes of
// q, k, v and o at 3.35 TB/s once T passes about 740 (0.4 T operations per
// byte against the card's 295): at B 8, T 2048 it is 0.139 ms of
// operations.  Only the tensor cores reach that rate.
//
// bf16 route (attn_fwd_wgmma), the serving path's: one CTA per (head,
// batch, q tile), q tiles of the heaviest causal rows launched first
// across all heads.  Warpgroups 0..NWG-1 compute, 64 q rows each (wgmma's
// M); the last warpgroup gives its registers to them (setmaxnreg: 24 for
// it, 240 each for two consumers, 160 for three) and its first thread is
// the producer:
//   - TMA copies the CTA's q tile once, then K and V tiles of BN keys, each
//     into a ring of two stages of its own with a "full" mbarrier
//     (transaction bytes) and an "empty" one that every consumer thread
//     arrives on once its products have read the stage: a K stage is
//     refilled as soon as its scores are computed.  Copies of the next
//     tiles are in flight while the consumers compute.
//   - The tensor maps (rank 4: hd, rows, heads, batch, with the caller's
//     strides) are encoded on the host per call by cuTensorMapEncodeTiled,
//     looked up with cudaGetDriverEntryPoint so that nothing links
//     libcuda, and reach the kernel as __grid_constant__ parameters.
//     Rows past T or S arrive as zeros; the s_valid and causal masks
//     still apply to the scores.
//   - Tiles are stored in chunks of CW = min(hd, 64) columns, one row of a
//     chunk being one swizzle span (128, 64 or 32 bytes), as TMA's swizzle
//     writes them and wgmma's descriptors read them.
//   - S = Q.K^T: wgmma m64nBNk16, Q and K both K-major from shared memory,
//     hd / 16 steps, f32 accumulators.  The scores are scaled in f32 by
//     log2(e) / sqrt(hd) inside the exponent's FMA (ex2): q is never
//     rounded to bf16 after scaling (1/sqrt(32) is no power of two).
//   - The masks (only on tiles that need them), the row max and the row
//     sum work on the accumulator fragment: a thread holds 2 rows, a row
//     lives in 4 lanes (2 shuffles for the max; the sum stays per thread
//     and is reduced once at the end).
//   - O += P.V: P converted to bf16 from the score fragment, which is
//     wgmma's register A layout, so P never touches shared memory; V is
//     read in its (keys, hd) row-major tile through the B transpose bit
//     (MN-major), m64n{hd}k16 for BN / 16 steps.  This rounds P to bf16
//     where the TPU kernel multiplies f32 P by f32 V: at granite-3-2b's
//     B 8, T 2048 the bf16 output lies 0.0099 from a float32 reference
//     with f32 P (chip_smoke.py's attn_kernel ``p_rounding``, H100 80GB
//     HBM3), inside the 2e-2 of the bf16 tolerance.
//   - Within a warpgroup, tile j's Q.K^T and tile j-1's P.V are in flight
//     together, and tile j's softmax runs while P.V still is; P of tile j
//     is packed once that P.V has read P of tile j-1.
//   - o is written from the accumulator fragment with 4-byte stores.
// Tile sizes, chosen per hd at compile time: BN 128 keys for hd 16 to 128,
// 64 for hd 256 (its O fragment is 128 floats, so one consumer warpgroup
// only); three consumer warpgroups (q tiles of 192 rows) at hd <= 64, two
// (128 rows) at hd 128.  Small grids keep these tiles: on an H100 80GB
// HBM3 (chip_smoke.py's attn_kernel ``split``), at B 1, T 97, H 32 the
// kernel takes 5.1 us in 32 CTAs of 192 rows against 4.1 us in 64 CTAs
// of 64 rows, and at T 512 10.1 us against 10.8, beside 40 to 90 us of
// host time per call.  Shared memory (64 NWG + 4 BN) * hd * 2 bytes + 1 KB of
// alignment, registers at launch (ptxas -v, CUDA 12.9; 0 bytes spilled
// anywhere), by (hd, NWG):
//   (16, 3) 23 KB 128   (32, 3) 45 KB 128   (64, 3) 89 KB 128
//   (128, 2) 161 KB 168   (256, 1) 161 KB 204
// Tried at B 8, T 2048, hd 64 and dropped: a third ring stage (no
// faster) and consumer warpgroups taking turns to issue their products
// through named barriers (ping-pong; slower with three of them).
// Not done yet: a persistent grid (each CTA's q load and first K/V tiles
// are not overlapped with the previous CTA's work), a TMA store of o.
//
// f32 route (attn_fwd_f32), unchanged in design since the first port: both
// products in f32 FMA on the CUDA cores.  TF32 tensor cores would miss the
// f32 tolerance of 2e-5, and no path of the port runs f32 attention.  One
// 256-thread block per (b, h, 64-row q tile); q scaled and staged in
// shared memory as f32, each 64-key K/V tile staged the same way; a thread
// computes a 4x4 block of scores, P goes through shared memory, a thread
// accumulates 4 rows x hd/16 output dims.  Shared memory (64 * 3 * (hd + 4)
// + 64 * 80) * 4 bytes: 35 KB at hd 16, 71 KB at hd 64, 215 KB at hd 256.
//
// Plain C interface for ctypes; returns 0, a CUDA error of the launch, or
// kEncodeError + the CUresult of a failed tensor-map encode.  Launches on
// the caller's stream, allocates nothing.
#include <cuda.h>  // CUtensorMap and its enums only: no libcuda symbol
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kEncodeError = 10000;

// strides in elements, (batch, head, row) of one operand
struct Strides {
  long long b, h, t;
};

// ================================================================ f32 route
constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kRows = kBQ / 16;   // score rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread
constexpr int kPStride = kBK + 16;

template <int HD>
constexpr int f32_smem_bytes() {
  return (kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * kPStride) * 4;
}

// rows [0, valid) of a (rows, HD) tile of row stride `stride` into shared
// memory of row stride HD + 4, times mul; rows [valid, rows) are zero
template <int HD>
__device__ void load_tile(float* dst, const float* __restrict__ src,
                          long long stride, int rows, int valid, float mul) {
  constexpr int kVecs = HD / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      x = *reinterpret_cast<const float4*>(src + r * stride + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) = x;
  }
}

template <int VEC>
__device__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

__device__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             Strides sq, Strides sk, Strides sv, Strides so, int H, int KH,
             int Tq, int S, int s_valid, int causal, float scale) {
  constexpr int QS = HD + 4;                       // q/k/v row stride
  constexpr int VEC = HD >= 64 ? 4 : HD / 16;      // dims per chunk
  constexpr int NCH = HD / (16 * VEC);             // chunks per thread
  constexpr int DPT = NCH * VEC;                   // output dims per thread

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * QS;
  float* Vs = Ks + kBK * QS;
  float* Ps = Vs + kBK * QS;

  const int qt = gridDim.x - 1 - blockIdx.x;       // heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, Tq - q0);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const float* qp = q + b * sq.b + h * sq.h + q0 * sq.t;
  const float* kp = k + b * sk.b + kh * sk.h;
  const float* vp = v + b * sv.b + kh * sv.h;

  load_tile<HD>(Qs, qp, sq.t, kBQ, q_rows, scale);

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  int kv_end = s_valid;
  if (causal) kv_end = min(kv_end, q0 + q_rows);   // last row's key + 1
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();            // the last tile's readers of Ks/Vs/Ps are done
    load_tile<HD>(Ks, kp + k0 * sk.t, sk.t, kBK, min(kBK, S - k0), 1.f);
    load_tile<HD>(Vs, vp + k0 * sv.t, sv.t, kBK, min(kBK, S - k0), 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qa[kRows], kb[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, kb[j].x, a);
          a = fmaf(qa[i].y, kb[j].y, a);
          a = fmaf(qa[i].z, kb[j].z, a);
          a = fmaf(qa[i].w, kb[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = k0 + tx + 16 * j;
        if ((causal && c > r) || c >= s_valid) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) p[i] = Ps[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        float vv[VEC];
        load_vec<VEC>(Vs + c * QS + VEC * (tx + 16 * ch), vv);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i][ch * VEC + e] = fmaf(p[i], vv[e], acc[i][ch * VEC + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + b * so.b + h * so.h + (q0 + r) * so.t;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        orow[VEC * (tx + 16 * ch) + e] = acc[i][ch * VEC + e] / denom;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Strides* st, int B, int H, int KH, int Tq, int S,
               int s_valid, int causal, float scale, cudaStream_t stream) {
  constexpr int bytes = f32_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  attn_fwd_f32<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1],
      st[2], st[3], H, KH, Tq, S, s_valid, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// =============================================================== bf16 route
constexpr int kStages = 2;   // K/V tiles in each ring

template <int HD>
struct Tile {
  static constexpr int CW = HD < 64 ? HD : 64;  // columns per chunk
  static constexpr int NCH = HD / CW;           // chunks per row
  static constexpr int SW = CW * 2;             // bytes per chunk row
  // wgmma descriptor layout of that swizzle span: 128 B, 64 B, 32 B
  static constexpr int LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int BN = HD <= 128 ? 128 : 64;  // keys per KV tile
  static constexpr int STAGES = kStages;
  static constexpr int KV_CHUNK = BN * SW;      // bytes of one chunk
  static constexpr int KV_BYTES = KV_CHUNK * NCH;
};

template <int HD, int NWG>
constexpr int bf16_smem_bytes() {
  return (64 * NWG + 2 * Tile<HD>::STAGES * Tile<HD>::BN) * HD * 2 + 1024;
}

// K and V have rings of their own, so a K stage is refilled as soon as
// its scores are computed, while V of the same tile is still being read
struct Barriers {
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One consumer warpgroup's view of the tiles.  Fragment of a 64 x N
// accumulator: index i holds row r0 + 8 * ((i / 2) % 2), column
// (i / 4) * 8 + c0 + i % 2; the score fragment of 16 keys kk is register
// A operand p[kk] of P.V once packed to bf16.
template <int HD, int NWG>
struct Consumer {
  using T = Tile<HD>;
  static constexpr int BN = T::BN;
  static constexpr int Q_CHUNK = 64 * NWG * T::SW;

  uint32_t q_base;   // shared address of this warpgroup's q rows
  int r0, c0, row_q, s_valid, causal;
  float scale_log2;
  float m[2], l[2];  // running max (raw scores) and this thread's sum

  // S = Q K^T of the KV stage at k_base, issued and committed, not waited
  __device__ __forceinline__ void scores(float (&sc)[BN / 2],
                                         uint32_t k_base) const {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk * 16 / T::CW;                   // which chunk
      const uint32_t off = (kk * 16 % T::CW) * 2;      // bytes into it
      const uint64_t da = hopper::make_desc(q_base + c * Q_CHUNK + off, 16,
                                            8 * T::SW, T::LAYOUT);
      const uint64_t db = hopper::make_desc(k_base + c * T::KV_CHUNK + off,
                                            16, 8 * T::SW, T::LAYOUT);
      hopper::wgmma_ss<BN>(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
  }

  // O += P V of the KV stage at v_base, issued and committed, not waited.
  // V is MN-major: LBO steps to the next chunk of hd columns, SBO to the
  // next 8 keys
  __device__ __forceinline__ void values(float (&acc)[HD / 2],
                                         const uint32_t (&p)[BN / 16][4],
                                         uint32_t v_base) const {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint64_t db = hopper::make_desc(v_base + kk * 16 * T::SW,
                                            T::KV_CHUNK, 8 * T::SW,
                                            T::LAYOUT);
      hopper::wgmma_rs<HD>(acc, p[kk], db, 1);
    }
    hopper::wgmma_commit();
  }

  // masks and the online softmax on the score fragment of keys k0..,
  // exponentials in place; -> the factor by which the accumulator must
  // shrink
  __device__ __forceinline__ void softmax(float (&sc)[BN / 2], int k0,
                                          float (&corr)[2]) {
    if (k0 + BN > s_valid || (causal && k0 + BN - 1 > row_q)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int col = k0 + (i / 4) * 8 + c0 + (i % 2);
        const int row = r0 + 8 * ((i / 2) % 2);
        if (col >= s_valid || (causal && col > row)) sc[i] = kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float neg[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      corr[j] = fast_exp2((m[j] - mx[j]) * scale_log2);
      m[j] = mx[j];
      l[j] *= corr[j];
      neg[j] = -mx[j] * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, neg[(i / 2) % 2]));
      l[(i / 2) % 2] += sc[i];
    }
  }

  // P to bf16 in wgmma's register A layout: 4 registers per 16 keys
  __device__ __forceinline__ static void pack(const float (&sc)[BN / 2],
                                              uint32_t (&p)[BN / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[kk][e] = pack_bf16(sc[kk * 8 + 2 * e], sc[kk * 8 + 2 * e + 1]);
  }
};

template <int HD, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, Strides so, int H, int KH,
               int Tq, int s_valid, int causal, float scale_log2) {
  using T = Tile<HD>;
  using C = Consumer<HD, NWG>;
  constexpr int BM = 64 * NWG;
  constexpr int BN = T::BN;
  constexpr int ST = T::STAGES;
  constexpr int Q_BYTES = C::Q_CHUNK * T::NCH;

  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  const uint32_t raw = hopper::smem_addr(smem_raw);
  uint8_t* sq = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* sk = sq + Q_BYTES;
  uint8_t* sv = sk + ST * T::KV_BYTES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest tiles first
  const int kh = h / (H / KH);
  int kv_end = s_valid;
  if (causal) kv_end = min(kv_end, min(q0 + BM, Tq));
  const int n_tiles = (kv_end + BN - 1) / BN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(&bars.q_full, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&bars.k_full[s], 1);
      hopper::mbar_init(&bars.v_full[s], 1);
      hopper::mbar_init(&bars.k_empty[s], NWG * 128);
      hopper::mbar_init(&bars.v_empty[s], NWG * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {
    // producer: gives its registers to the consumers; one thread issues
    // every copy, each into a stage once its last readers have left
    if constexpr (NWG > 1) hopper::regs_dealloc<24>();
    if (threadIdx.x != NWG * 128) return;
    hopper::mbar_expect_tx(&bars.q_full, Q_BYTES);
#pragma unroll
    for (int c = 0; c < T::NCH; ++c)
      hopper::tma_load_4d(sq + c * C::Q_CHUNK, &tq, &bars.q_full, c * T::CW,
                          q0, h, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % ST;
      const uint32_t parity = ((it / ST) & 1) ^ 1;
      hopper::mbar_wait(&bars.k_empty[s], parity);
      hopper::mbar_expect_tx(&bars.k_full[s], T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        hopper::tma_load_4d(sk + s * T::KV_BYTES + c * T::KV_CHUNK, &tk,
                            &bars.k_full[s], c * T::CW, it * BN, kh, b);
      hopper::mbar_wait(&bars.v_empty[s], parity);
      hopper::mbar_expect_tx(&bars.v_full[s], T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < T::NCH; ++c)
        hopper::tma_load_4d(sv + s * T::KV_BYTES + c * T::KV_CHUNK, &tv,
                            &bars.v_full[s], c * T::CW, it * BN, kh, b);
    }
    return;
  }

  // consumer warpgroup wg: q rows [row_q, row_q + 64)
  if constexpr (NWG > 1) hopper::regs_alloc<NWG == 2 ? 240 : 160>();
  const int lane = threadIdx.x % 32;
  C cs;
  cs.row_q = q0 + wg * 64;
  cs.r0 = cs.row_q + (threadIdx.x % 128) / 32 * 16 + lane / 4;
  cs.c0 = (lane % 4) * 2;
  cs.s_valid = s_valid;
  cs.causal = causal;
  cs.scale_log2 = scale_log2;
  cs.q_base = hopper::smem_addr(sq) + wg * 64 * T::SW;
  cs.m[0] = cs.m[1] = kNegInf;
  cs.l[0] = cs.l[1] = 0.f;
  // tiles [0, n_live) hold a key this warpgroup's rows see; the rest only
  // keep the rings moving
  int wg_end = s_valid;
  if (causal) wg_end = min(wg_end, cs.row_q + 64);
  const int n_live =
      cs.row_q < Tq ? min(n_tiles, (wg_end + BN - 1) / BN) : 0;
  const uint32_t k_base = hopper::smem_addr(sk);
  const uint32_t v_base = hopper::smem_addr(sv);

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2];
  uint32_t p[BN / 16][4];
  float corr[2];
  hopper::mbar_wait(&bars.q_full, 0);

  if (n_live > 0) {
    // tile 0's scores and P
    hopper::mbar_wait(&bars.k_full[0], 0);
    hopper::wgmma_fence();
    cs.scores(sc, k_base);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::mbar_arrive(&bars.k_empty[0]);
    cs.softmax(sc, 0, corr);
    C::pack(sc, p);
    // then tile it's scores run on the tensor cores beside tile it - 1's
    // P.V; the softmax of tile it overlaps that P.V
    for (int it = 1; it < n_live; ++it) {
      const int s = it % ST, sp = (it - 1) % ST;
      hopper::mbar_wait(&bars.k_full[s], (it / ST) & 1);
      hopper::wgmma_fence();
      cs.scores(sc, k_base + s * T::KV_BYTES);
      hopper::mbar_wait(&bars.v_full[sp], ((it - 1) / ST) & 1);
      cs.values(acc, p, v_base + sp * T::KV_BYTES);
      hopper::wgmma_wait<1>();          // the scores are done
      hopper::fence_regs(sc);
      hopper::mbar_arrive(&bars.k_empty[s]);
      cs.softmax(sc, it * BN, corr);
      hopper::wgmma_wait<0>();          // and P.V of tile it - 1
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
      hopper::mbar_arrive(&bars.v_empty[sp]);
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      C::pack(sc, p);
    }
    const int sp = (n_live - 1) % ST;
    hopper::mbar_wait(&bars.v_full[sp], ((n_live - 1) / ST) & 1);
    hopper::wgmma_fence();
    cs.values(acc, p, v_base + sp * T::KV_BYTES);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(p);
    hopper::mbar_arrive(&bars.v_empty[sp]);
  }
  for (int it = n_live; it < n_tiles; ++it) {
    const int s = it % ST;
    const uint32_t parity = (it / ST) & 1;
    hopper::mbar_wait(&bars.k_full[s], parity);
    hopper::mbar_arrive(&bars.k_empty[s]);
    hopper::mbar_wait(&bars.v_full[s], parity);
    hopper::mbar_arrive(&bars.v_empty[s]);
  }

  float* l = cs.l;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  if (n_live == 0) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = cs.r0 + 8 * j;
    if (row >= Tq) continue;
    const float denom = fmaxf(l[j], 1e-30f);
    __nv_bfloat16* orow = o + b * so.b + h * so.h + row * so.t;
#pragma unroll
    for (int g = 0; g < HD / 8; ++g) {
      const int i = g * 4 + 2 * j;
      *reinterpret_cast<__nv_bfloat162*>(orow + g * 8 + cs.c0) =
          __floats2bfloat162_rn(acc[i] / denom, acc[i + 1] / denom);
    }
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

// a (batch, heads, rows, hd) bf16 operand as a rank-4 map (hd innermost),
// boxes of `cols` x `rows` in the swizzle whose span is one box row
int encode(CUtensorMap* map, const void* base, Strides st, int batch,
           int heads, int rows, int hd, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.t) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int HD, int NWG>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 const Strides* st, int B, int H, int KH, int Tq, int S,
                 int s_valid, int causal, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  constexpr int BM = 64 * NWG;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, st[0], B, H, Tq, HD, T::CW, BM);
  if (err == 0) err = encode(&tk, k, st[1], B, KH, S, HD, T::CW, T::BN);
  if (err == 0) err = encode(&tv, v, st[2], B, KH, S, HD, T::CW, T::BN);
  if (err != 0) return err;
  constexpr int bytes = bf16_smem_bytes<HD, NWG>();
  const cudaError_t attr = cudaFuncSetAttribute(
      attn_fwd_wgmma<HD, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H, B, (Tq + BM - 1) / BM);
  attn_fwd_wgmma<HD, NWG><<<grid, 128 * (NWG + 1), bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], H, KH, Tq, s_valid,
      causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// consumer warpgroups (64 q rows each) per CTA: as many as hd's registers
// allow
template <int HD>
constexpr int kConsumers = HD <= 64 ? 3 : HD <= 128 ? 2 : 1;

int dispatch(int dtype, int hd, const void* q, const void* k, const void* v,
             void* o, const Strides* st, int B, int H, int KH, int Tq, int S,
             int s_valid, int causal, float scale, cudaStream_t stream) {
#define FA_CASE(HD)                                                         \
  case HD:                                                                  \
    return dtype == 0 ? launch_f32<HD>(q, k, v, o, st, B, H, KH, Tq, S,     \
                                       s_valid, causal, scale, stream)      \
                      : launch_wgmma<HD, kConsumers<HD>>(                   \
                            q, k, v, o, st, B, H, KH, Tq, S, s_valid,       \
                            causal, scale, stream);
  switch (hd) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, the
// (batch, head, row) strides of q, k, v and o in that order; hd is
// contiguous in each.  The wrapper has checked shapes, head size, dtype
// and 16-byte alignment of every base and stride.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KH, int Tq, int S, int hd,
                                   int s_valid, int causal, float scale,
                                   const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || s_valid <= 0 || s_valid > S ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  return dispatch(dtype, hd, q, k, v, o, st, B, H, KH, Tq, S, s_valid,
                  causal, scale, static_cast<cudaStream_t>(stream));
}
