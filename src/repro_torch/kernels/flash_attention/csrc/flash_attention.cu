// Flash attention forward for Hopper (sm_90a): causal or full GQA attention
// with an online softmax in f32.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (Pallas body _attn_kernel).  q is (B, H, T, hd); k and v are (B, K, S, hd)
// with H % K == 0; o is (B, H, T, hd) in q's dtype (f32 or bf16).  Query
// head h reads KV head h / (H / K) in place: no repeated copy of K or V.
// Scores are (q * 1/sqrt(hd)) . k in f32, as the Pallas kernel scales q
// before its product.  Keys at or past s_valid are masked; with causal, key
// j is masked for query i when j > i, both counted from 0.  The running max,
// denominator (floored at 1e-30) and accumulator stay in f32.
//
// What bounds it: operations, at the serving path's long prompts.  At
// granite-3-2b's prefill shapes (H 32, K 8, hd 64, bf16) the causal half of
// 4*H*T^2*hd operations at 989 TFLOP/s (dense bf16) outweighs the bytes of
// q, k, v and o at 3.35 TB/s once T passes about 740 (0.4 T operations per
// byte against the card's 295): at T = 2048 and B = 1 it is 17.4 us of
// operations against 6.3 us of bytes.  At T = 512 the bytes (1.6 us) still
// outweigh the operations (1.1 us).
//
// This first design is simple and right, not fast: both products run in
// f32 on CUDA cores (67 TFLOP/s at most), not on the tensor cores.  The TPU
// kernel's sequential grid over KV tiles becomes a loop inside one block:
//   one 256-thread block per (b, h, 64-row q tile), heaviest causal tiles
//   scheduled first; the q tile is converted to f32, scaled and kept in
//   shared memory; each 64-row KV tile is staged in shared memory as f32;
//   a thread computes a 4x4 block of scores (rows ty + 16i, columns
//   tx + 16j), the row max and sum are reduced across the 16 threads of a
//   row with warp shuffles, P goes through shared memory, and a thread
//   accumulates 4 rows x hd/16 output dims in registers.
// KV tiles wholly past the q tile's last row (causal) or past s_valid are
// skipped: their scores would all be masked and add exactly nothing.
// Shared memory is (64 * 3 * (hd + 4) + 64 * 80) * 4 bytes: 35 KB at hd 16,
// 71 KB at hd 64 and 215 KB at hd 256, so it is dynamic shared memory,
// allowed per instantiation with cudaFuncSetAttribute.
// wgmma, TMA, double buffering and warp specialisation are later work.
//
// Plain C interface for ctypes; returns the CUDA error of the launch (0 on
// success).  Launches on the caller's stream, allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // keys per KV tile
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr int kRows = kBQ / 16;   // score rows per thread
constexpr int kCols = kBK / 16;   // score columns per thread
constexpr int kPStride = kBK + 16;
constexpr float kNegInf = -1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
  }
};

template <int HD>
constexpr int smem_bytes() {
  return (kBQ * (HD + 4) + 2 * kBK * (HD + 4) + kBQ * kPStride) * 4;
}

// rows [0, valid) of a (rows, HD) tile from global memory into f32 shared
// memory of row stride HD + 4, times mul; rows [valid, rows) are zero
template <typename T, int HD>
__device__ void load_tile(float* dst, const T* __restrict__ src, int rows,
                          int valid, float mul) {
  constexpr int kVecs = HD / 4;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      x = Io<T>::load4(src + static_cast<size_t>(r) * HD + c);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ o, int H, int KH, int Tq,
         int S, int s_valid, int causal, float scale) {
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

  const T* qp = q + (static_cast<size_t>(b * H + h) * Tq + q0) * HD;
  const T* kp = k + static_cast<size_t>(b * KH + kh) * S * HD;
  const T* vp = v + static_cast<size_t>(b * KH + kh) * S * HD;

  load_tile<T, HD>(Qs, qp, kBQ, q_rows, scale);

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
    load_tile<T, HD>(Ks, kp + static_cast<size_t>(k0) * HD, kBK,
                     min(kBK, S - k0), 1.f);
    load_tile<T, HD>(Vs, vp + static_cast<size_t>(k0) * HD, kBK,
                     min(kBK, S - k0), 1.f);
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
    T* orow = o + (static_cast<size_t>(b * H + h) * Tq + q0 + r) * HD;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        Io<T>::store(orow + VEC * (tx + 16 * ch) + e,
                     acc[i][ch * VEC + e] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KH, int Tq, int S, int s_valid, int causal,
           float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  attn_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KH, Tq, S, s_valid,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* o, int B, int H, int KH, int Tq, int S, int s_valid,
                int causal, float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KH, Tq, S, s_valid, causal,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KH, Tq, S, s_valid, causal,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KH, Tq, S, s_valid, causal,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Tq, S, s_valid, causal,
                            scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KH, Tq, S, s_valid, causal,
                            scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  The wrapper has checked shapes, head
// size, dtype, contiguity and 16-byte alignment.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int H, int KH, int Tq, int S, int hd,
                                   int s_valid, int causal, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || Tq <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || s_valid <= 0 || s_valid > S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, H, KH, Tq, S, s_valid,
                              causal, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, H, KH, Tq, S,
                                      s_valid, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
