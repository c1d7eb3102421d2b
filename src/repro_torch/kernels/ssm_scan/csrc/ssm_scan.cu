// Mamba1 selective scan for Hopper (sm_90a): the prefill scan of the SSM
// and hybrid families.
//
// Replaces src/repro/kernels/ssm_scan/kernel.py::ssm_scan (Pallas body
// _ssm_kernel).  x and dt are (B, T, Di) in f32 or bf16; bm and cm are
// (B, T, N) and a is (Di, N), all f32.  From h_0 = 0, in f32:
//   h_t = exp(dt_t * a) * h_{t-1} + (dt_t * x_t) * b_t,   y_t = c_t . h_t
// y is (B, T, Di) in x's dtype, and the final state h_T is written as
// (B, Di, N) f32: prefill keeps it as the layer's SSMCache.h.  The TPU
// kernel returns y only; its wrapper's caller, the prefill, needs h_T too,
// and writing it here is the same function.
//
// What bounds it, on an H100 SXM (NVIDIA's data sheet: 3.35 TB/s, 132
// SMs).  Bytes: x and dt read and y written, 12 bytes per (b, t, d) in
// f32, 0.242 ms at B 8, T 1024, Di 8192, N 16.  But every state update
// (b, t, d, n) needs one exponential, 1.07e9 of them there, and the
// special-function units take 16 a clock per SM: at 1.755 GHz that is
// 0.28 ms, above the bytes.  The rest of an update is
// five FP32 instructions (below) against 128 FP32 lanes a clock per SM.  So
// the design spends as few instructions around each exponential as it
// can, and keeps enough warps on every SM to issue them.
//
// Design.
// - A thread owns one (b, d) channel and R = NP / L of its states, in
//   registers (NP: N rounded up to a power of two, at least 4; states
//   n >= N carry a = 0 and b = c = 0 and stay 0).  L, the lanes per
//   channel, is 1 or 2 (4 <= R <= 16), chosen per launch by the wrapper:
//   one lane means fewer instructions per update, two twice the warps.
// - a * log2(e) is loaded once into registers.  An update is 2e =
//   ex2.approx(dt a' + 1), (dt x) b, h = fma(1/2, 2e h, (dt x) b) and one
//   FFMA for c . h.  The exponential's argument near 1 is where expf, the
//   plain version's exp, evaluates ex2 too, so both round alike; near 0
//   ex2.approx rounds low on average, and a fraction of an ulp per step
//   would compound over a channel's memory, thousands of steps where a is
//   near 0.  Halving is exact, so h gets the plain version's two roundings
//   (e h, then + (dt x) b), not an FFMA's one.
// - dt and x are read once per thread and step, b_t and c_t as float4
//   broadcasts from shared memory.  c . h is summed in four partial sums
//   over the thread's R states, then over the channel's L lanes with
//   log2(L) shuffles, once per channel and step; one lane stores y_t
//   straight to global memory in x's dtype (a warp covers 32 / L adjacent
//   channels, so the stores of a step are contiguous).
// - A block of 128 threads covers 128 / L channels of one batch row.
//   Time tiles of 16 (L = 1) or 32 steps of x, dt (converted to f32), b and
//   c are double-buffered in shared memory: the loads of tile i + 1 are
//   issued into registers before tile i is scanned and stored to the other
//   buffer after it, so they are in flight during the scan, and one
//   __syncthreads per tile orders both buffers.  Registers rather than
//   cp.async, because x's rows start at any element (any Di, bf16 too) and
//   bf16 is converted once, on the way in.  Steps past T are staged as
//   zeros, which leave h as it is (exp(0) * h + 0): nothing is padded.
// - Enough warps at batch 1.  Where B * Di * L leaves the SMs short of
//   warps even at L = 2, the wrapper splits T into K chunks and the call
//   runs two kernels:
//     pass 1 scans chunks 0 .. K-2 from h = 0 and keeps each chunk's end
//       state and product of decays per state (chunk 0, whose true start
//       is h = 0, writes its y here and needs no product);
//     pass 2 scans chunks 1 .. K-1: each block first folds the earlier
//       chunks into its start state,
//         h_in(j + 1) = prod_j * h_in(j) + h_end(j),
//       then rescans its chunk from h_in, writing y and, in the last chunk,
//       the final state.
//   The carry multiplies the decays the sequential scan applies, not
//   exp(a * sum dt), so it carries the plain version's rounded
//   exponentials rather than a more exact product of them.  Chunking costs
//   2 (K - 1) / K times the exponentials and reads x and dt of the middle
//   chunks twice, so the wrapper chunks only launches that would otherwise
//   leave the card idle.  K = 1 is one kernel, pass 2 alone over the whole
//   sequence.
// Like the TPU kernel, it never writes the (T, Di, N) states or their
// discretisation to global memory.  Shared memory: 2 buffers of
// 2 * S * (128 / L + NP) floats, at most 48 KB.
//
// Plain C interface for ctypes; returns the CUDA error of the launches (0
// on success).  Launches on the caller's stream, allocates nothing: the
// chunk scratch (end states, products) comes from the wrapper.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Twice exp(dt a): 2^(dt a' + 1), a' = a log2(e), ex2's argument near 1 as
// in expf (see the header).
__device__ __forceinline__ float exp_x2(float dv, float a2) {
  return ex2(fmaf(dv, a2, 1.f));
}

struct Args {
  const void* x;
  const void* dt;
  const float* bm;
  const float* cm;
  const float* a;
  void* y;
  float* h;       // (B, Di, N): the final state
  float* hend;    // (B, K - 1, Di, N): chunk end states from h = 0
  float* pend;    // (B, K - 1, Di, N): each chunk's product of decays
  int T, Di, N;
  int chunks, chunk_len;
  int pass;       // 1: chunks 0 .. K-2, end states; 2: chunks 1 .. K-1 (0)
};

// Shared memory of a block: two buffers of a staged time tile.
template <int NP, int L>
struct Tiles {
  static constexpr int kCh = kThreads / L;   // channels per block
  // steps per tile: 16 at L = 1 (128 channels a block), else 32; either
  // way the two buffers stay within 48 KB of static shared memory
  static constexpr int kS = L == 1 ? 16 : 32;
  float x[2][kS][kCh];
  float dt[2][kS][kCh];
  float b[2][kS][NP];
  float c[2][kS][NP];
};

// One chunk of one channel, steps [t_begin, t_end), from the state h.
// kY: c . h is summed and y stored; else the decays are multiplied into a
// product per state and stored with the end state, for the chunk carry
// (pass 1 past chunk 0).  Pass 2's last chunk stores the final state.
template <bool kY, typename T, int NP, int L>
__device__ __forceinline__ void scan_chunk(const Args p, Tiles<NP, L>& sm,
                                           const float (&a2)[NP / L],
                                           float (&h)[NP / L], int b, int k,
                                           int d0) {
  constexpr int R = NP / L;
  constexpr int kCh = Tiles<NP, L>::kCh;
  constexpr int kS = Tiles<NP, L>::kS;
  constexpr int kE = kS * kCh / kThreads;   // x (and dt) values staged
  constexpr int kBN = kS * NP;              // b (and c) values per tile
  constexpr int kB = (kBN + kThreads - 1) / kThreads;
  // steps unrolled: one lane's 16 states give each step enough
  // independent work; deeper unrolls there cost more than they hide
  constexpr int kUnroll = L == 1 ? 2 : 4;
  const int Di = p.Di, N = p.N;
  const int dl = threadIdx.x / L;
  const int l = threadIdx.x % L;
  const int d = d0 + dl;
  const bool live = d < Di;
  const int t_begin = k * p.chunk_len;
  const int t_end = min(p.T, t_begin + p.chunk_len);
  const size_t row0 = static_cast<size_t>(b) * p.T;   // row of (b, t = 0)
  const T* x = static_cast<const T*>(p.x);
  const T* dt = static_cast<const T*>(p.dt);
  T* y = static_cast<T*>(p.y);
  float prod[R];
#pragma unroll
  for (int r = 0; r < R; ++r) prod[r] = 1.f;

  // staging: thread i stages column i % kCh of rows i / kCh + j * L of x
  // and dt, and entries i + j * kThreads of the tile's (kS, NP) b and c
  const int sc = threadIdx.x % kCh;
  const int sr = threadIdx.x / kCh;
  const bool col_live = d0 + sc < Di;
  float px[kE], pt[kE], pb[kB], pc[kB];
  auto load = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int t = t0 + sr + j * L;
      px[j] = pt[j] = 0.f;
      if (col_live && t < t_end) {
        const size_t off = (row0 + t) * Di + d0 + sc;
        px[j] = Io<T>::load(x + off);
        pt[j] = Io<T>::load(dt + off);
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = threadIdx.x + j * kThreads;
      const int s = i / NP;
      const int n = i % NP;
      pb[j] = pc[j] = 0.f;
      if (i < kBN && n < N && t0 + s < t_end) {
        const size_t off = (row0 + t0 + s) * N + n;
        pb[j] = __ldg(p.bm + off);
        if (kY) pc[j] = __ldg(p.cm + off);
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      sm.x[buf][sr + j * L][sc] = px[j];
      sm.dt[buf][sr + j * L][sc] = pt[j];
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < kBN) {
        (&sm.b[buf][0][0])[i] = pb[j];
        if (kY) (&sm.c[buf][0][0])[i] = pc[j];
      }
    }
  };

  load(t_begin);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kS, buf ^= 1) {
    const bool more = t0 + kS < t_end;
    if (more) load(t0 + kS);   // in flight while this tile is scanned
    const int ysteps = live && l == 0 ? min(kS, t_end - t0) : 0;
    T* yrow = y + (row0 + t0) * Di + d;
    float(&xs)[kS][kCh] = sm.x[buf];
    float(&ds)[kS][kCh] = sm.dt[buf];
#pragma unroll kUnroll
    for (int s = 0; s < kS; ++s) {
      const float dv = ds[s][dl];
      const float dtx = dv * xs[s][dl];
      // four partial sums of c . h: four short FFMA chains, not one of R
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 bb =
            reinterpret_cast<const float4*>(&sm.b[buf][s][l * R])[q];
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // h = e h + (dt x) b rounded as the plain version rounds it:
          // e h = (2e h) / 2 exactly, so one FFMA adds it to the rounded
          // (dt x) b with the plain version's two roundings
          const float e2 = exp_x2(dv, a2[4 * q + i]);
          h[4 * q + i] = fmaf(0.5f, e2 * h[4 * q + i], dtx * bv[i]);
          if (!kY) prod[4 * q + i] *= 0.5f * e2;
        }
        if (kY) {
          const float4 cc =
              reinterpret_cast<const float4*>(&sm.c[buf][s][l * R])[q];
          p0 = fmaf(cc.x, h[4 * q + 0], p0);
          p1 = fmaf(cc.y, h[4 * q + 1], p1);
          p2 = fmaf(cc.z, h[4 * q + 2], p2);
          p3 = fmaf(cc.w, h[4 * q + 3], p3);
        }
      }
      if (kY) {
        float yv = (p0 + p1) + (p2 + p3);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          yv += __shfl_xor_sync(0xffffffffu, yv, off);
        if (s < ysteps) Io<T>::store(yrow + static_cast<size_t>(s) * Di, yv);
      }
    }
    if (more) store(buf ^ 1);
    __syncthreads();   // buf ^ 1 staged; every read of buf done
  }

  if (!live) return;
  if (p.pass == 1) {   // chunk k's end state (and, past chunk 0, product)
    const size_t ck =
        (static_cast<size_t>(b * (p.chunks - 1) + k) * Di + d) * N + l * R;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (l * R + r < N) {
        p.hend[ck + r] = h[r];
        if (!kY) p.pend[ck + r] = prod[r];
      }
  } else if (k == p.chunks - 1) {
    const size_t hd = (static_cast<size_t>(b) * Di + d) * N + l * R;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (l * R + r < N) p.h[hd + r] = h[r];
  }
}

template <typename T, int NP, int L>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const Args p) {
  constexpr int R = NP / L;   // states per thread
  static_assert(R >= 4 && R % 4 == 0, "float4 reads of b and c");
  __shared__ __align__(16) Tiles<NP, L> sm;
  const int b = blockIdx.z;
  const int k = blockIdx.y + (p.pass == 2 && p.chunks > 1);   // the chunk
  const int d0 = blockIdx.x * Tiles<NP, L>::kCh;
  const int l = threadIdx.x % L;
  const int d = d0 + threadIdx.x / L;
  const bool live = d < p.Di;

  float a2[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = l * R + r;
    a2[r] = live && n < p.N
                ? p.a[static_cast<size_t>(d) * p.N + n] * kLog2e : 0.f;
    h[r] = 0.f;
  }
  if (p.pass == 2 && k > 0 && live) {
    // the start state: h_in(j + 1) = prod_j * h_in(j) + h_end(j) over the
    // chunks j < k, from h_in(0) = 0 (so chunk 0 needs no product)
    for (int j = 0; j < k; ++j) {
      const size_t cj = (static_cast<size_t>(b * (p.chunks - 1) + j) * p.Di
                         + d) * p.N + l * R;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (l * R + r < p.N)
          h[r] = j == 0 ? p.hend[cj + r]
                        : fmaf(p.pend[cj + r], h[r], p.hend[cj + r]);
    }
  }
  if (p.pass == 2 || k == 0)
    scan_chunk<true, T, NP, L>(p, sm, a2, h, b, k, d0);
  else
    scan_chunk<false, T, NP, L>(p, sm, a2, h, b, k, d0);
}

template <typename T, int NP, int L>
int launch(Args p, int B, cudaStream_t stream) {
  constexpr int kCh = kThreads / L;
  const unsigned gx = static_cast<unsigned>((p.Di + kCh - 1) / kCh);
  const unsigned gy = static_cast<unsigned>(p.chunks > 1 ? p.chunks - 1 : 1);
  if (p.chunks > 1) {
    p.pass = 1;
    scan_kernel<T, NP, L><<<dim3(gx, gy, B), kThreads, 0, stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  p.pass = 2;
  scan_kernel<T, NP, L><<<dim3(gx, gy, B), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& p, int B, int lanes, cudaStream_t s) {
  const int np = p.N <= 4 ? 4 : p.N <= 8 ? 8 : p.N <= 16 ? 16 : 32;
  switch (np * 16 + lanes) {
    case 4 * 16 + 1: return launch<T, 4, 1>(p, B, s);
    case 8 * 16 + 1: return launch<T, 8, 1>(p, B, s);
    case 8 * 16 + 2: return launch<T, 8, 2>(p, B, s);
    case 16 * 16 + 1: return launch<T, 16, 1>(p, B, s);
    case 16 * 16 + 2: return launch<T, 16, 2>(p, B, s);
    case 32 * 16 + 2: return launch<T, 32, 2>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype of x, dt and y: 0 = float32, 1 = bfloat16.  lanes: lanes per
// channel, 1 or 2, with 4 <= NP / lanes <= 16; chunks: K >= 1 time chunks of chunk_len steps (the last one shorter),
// each non-empty; for K > 1, hend and pend are (B, K - 1, Di, N) f32
// scratch.  The wrapper has checked shapes, dtypes, devices and
// contiguity.
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* bm,
                            const void* cm, const void* a, void* y, void* h,
                            void* hend, void* pend, int dtype, int B, int Tn,
                            int Di, int N, int lanes, int chunks,
                            int chunk_len, void* stream) {
  if (N < 1 || N > 32 || B < 0 || Tn < 0 || Di < 0 || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunks > 1 && (hend == nullptr || pend == nullptr || chunk_len < 1
                     || static_cast<long long>(chunks - 1) * chunk_len >= Tn))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Di == 0) return 0;
  Args p{x, dt, static_cast<const float*>(bm), static_cast<const float*>(cm),
         static_cast<const float*>(a), y, static_cast<float*>(h),
         static_cast<float*>(hend), static_cast<float*>(pend), Tn, Di, N,
         chunks, chunks > 1 ? chunk_len : Tn, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, B, lanes, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, B, lanes, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
