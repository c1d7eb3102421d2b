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
// What bounds it: bytes.  At falcon-mamba-7b's prefill shapes (Di 8192,
// N 16, f32 x and dt) a call reads x and dt and writes y, 12 bytes per
// (b, t, d), against about 6 f32 operations per (b, t, d, n) state update,
// 96 per (b, t, d): 8 operations per byte against the card's 20 for f32 on
// CUDA cores (67 TFLOP/s over 3.35 TB/s).  At B 8, T 1024 that is 0.24 ms
// of bytes against 0.10 ms of operations.  The 16 exponentials per
// (b, t, d) run on the special-function units, which are not in that count.
//
// Design.  The TPU kernel scans each (block_t, block_di) tile
// associatively because its vector unit wants wide (t, d, n) arrays; here
// there is parallelism enough across (b, d, n) (B * Di * N = 131,072
// threads at B 1), so the scan is plain and sequential in time:
//   one thread per (b, d, n) state element, h in a register; the NP lanes
//   of one (b, d) are adjacent in a warp (NP: N rounded up to a power of
//   two, lanes n >= N carry zeros); a 256-thread block covers 256 / NP
//   channels of one batch row;
//   per tile of 4 * NP time steps, x and dt (steps x channels, converted
//   to f32) and b and c (steps x NP) are staged in shared memory with
//   coalesced loads, the steps run in order, c . h is reduced over the NP
//   lanes with warp shuffles, one lane puts y_t in a shared tile, and the
//   tile is written back coalesced in x's dtype.
// Like the TPU kernel, it never writes the (T, Di, N) states or their
// discretisation to global memory.  Any T and Di are taken: a ragged edge
// is masked, so nothing is padded.  Shared memory is 12 KB for x, dt and
// y plus 32 * NP^2 bytes for b and c: 20 KB at N 16, 44 KB at N 32.
//
// Plain C interface for ctypes; returns the CUDA error of the launch (0 on
// success).  Launches on the caller's stream, allocates nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);   // round to nearest even, as torch's .to()
  }
};

template <typename T, int NP>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ a, T* __restrict__ y,
            float* __restrict__ h_out, int Tn, int Di, int N) {
  constexpr int kCh = kThreads / NP;   // channels per block
  constexpr int kSteps = 4 * NP;       // time steps per staged tile
  __shared__ float xs[kSteps][kCh];
  __shared__ float ds[kSteps][kCh];
  __shared__ float ys[kSteps][kCh];
  __shared__ float bs[kSteps][NP];
  __shared__ float cs[kSteps][NP];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kCh;
  const int dl = threadIdx.x / NP;
  const int n = threadIdx.x % NP;
  const int d = d0 + dl;
  const int cols = min(kCh, Di - d0);
  const bool live = d < Di && n < N;
  const float an = live ? a[static_cast<size_t>(d) * N + n] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * Tn;   // row of (b, t = 0)
  float h = 0.f;

  for (int t0 = 0; t0 < Tn; t0 += kSteps) {
    const int steps = min(kSteps, Tn - t0);
    // stage the tile; entries past T, Di or N are zero, which leaves h = 0
    // on dead lanes (exp(0) * 0 + 0)
    for (int i = threadIdx.x; i < kSteps * kCh; i += kThreads) {
      const int r = i / kCh;
      const int c = i - r * kCh;
      float xv = 0.f, dv = 0.f;
      if (r < steps && c < cols) {
        const size_t off = (row0 + t0 + r) * Di + d0 + c;
        xv = Io<T>::load(x + off);
        dv = Io<T>::load(dt + off);
      }
      xs[r][c] = xv;
      ds[r][c] = dv;
    }
    for (int i = threadIdx.x; i < kSteps * NP; i += kThreads) {
      const int r = i / NP;
      const int c = i - r * NP;
      float bv = 0.f, cv = 0.f;
      if (r < steps && c < N) {
        const size_t off = (row0 + t0 + r) * N + c;
        bv = bm[off];
        cv = cm[off];
      }
      bs[r][c] = bv;
      cs[r][c] = cv;
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < steps; ++r) {
      const float dv = ds[r][dl];
      h = expf(dv * an) * h + (dv * xs[r][dl]) * bs[r][n];
      float p = cs[r][n] * h;
#pragma unroll
      for (int off = NP / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) ys[r][dl] = p;
    }
    __syncthreads();   // ys complete; xs, ds, bs, cs free for the next tile

    for (int i = threadIdx.x; i < steps * kCh; i += kThreads) {
      const int r = i / kCh;
      const int c = i - r * kCh;
      if (c < cols) Io<T>::store(y + (row0 + t0 + r) * Di + d0 + c, ys[r][c]);
    }
  }
  if (live) h_out[(static_cast<size_t>(b) * Di + d) * N + n] = h;
}

template <typename T, int NP>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const void* a, void* y, void* h, int B, int Tn, int Di, int N,
           cudaStream_t stream) {
  constexpr int kCh = kThreads / NP;
  const dim3 grid((Di + kCh - 1) / kCh, B);
  scan_kernel<T, NP><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(a), static_cast<T*>(y),
      static_cast<float*>(h), Tn, Di, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_n(const void* x, const void* dt, const void* bm, const void* cm,
               const void* a, void* y, void* h, int B, int Tn, int Di, int N,
               cudaStream_t s) {
  if (N <= 1) return launch<T, 1>(x, dt, bm, cm, a, y, h, B, Tn, Di, N, s);
  if (N <= 2) return launch<T, 2>(x, dt, bm, cm, a, y, h, B, Tn, Di, N, s);
  if (N <= 4) return launch<T, 4>(x, dt, bm, cm, a, y, h, B, Tn, Di, N, s);
  if (N <= 8) return launch<T, 8>(x, dt, bm, cm, a, y, h, B, Tn, Di, N, s);
  if (N <= 16) return launch<T, 16>(x, dt, bm, cm, a, y, h, B, Tn, Di, N, s);
  return launch<T, 32>(x, dt, bm, cm, a, y, h, B, Tn, Di, N, s);
}

}  // namespace

// dtype of x, dt and y: 0 = float32, 1 = bfloat16.  The wrapper has checked
// shapes, dtypes, devices and contiguity, and 1 <= N <= 32.
extern "C" int ssm_scan_fwd(const void* x, const void* dt, const void* bm,
                            const void* cm, const void* a, void* y, void* h,
                            int dtype, int B, int Tn, int Di, int N,
                            void* stream) {
  if (N < 1 || N > 32 || B < 0 || Tn < 0 || Di < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Di == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(x, dt, bm, cm, a, y, h, B, Tn, Di, N, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(x, dt, bm, cm, a, y, h, B, Tn, Di, N,
                                     s);
  return static_cast<int>(cudaErrorInvalidValue);
}
