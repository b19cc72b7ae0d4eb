// Mamba2 SSD recurrence (the zamba2 backbone's inner loop), forward:
//
//   h[p,n] <- decay_t * h[p,n] + dt_t * x_t[p] * B_t[n]      h: (P, N) f32
//   y_t[p]  = sum_n h[p,n] * C_t[n]
//
// for each (batch, head) over t = 0 .. S-1, from the initial state s0.  B_t
// and C_t are shared by all H heads of a batch row; decay and dt are one
// scalar per (b, t, h).  y and the final state are f32.
//
// Replaces repro/kernels/mamba2_scan.py:mamba2_ssd_pallas (_ssd_kernel).
// The Pallas kernel walks time as a sequential grid axis and carries the
// (P, N) f32 state from one time chunk to the next in VMEM scratch, reading
// B and C through an index map b -> b // H.  CUDA blocks run in no order, so
// here one block owns one (b, h) for the whole sequence and loops over time
// itself; nothing carries between blocks, and the kernel takes any S (no
// chunk-multiple rule, no fallback).
//
// Bound on the H100: operations at prefill, bytes at decode.  Each step does
// about 5 f32 operations per state element (P*N of them: the dt*x*B outer
// product, the decay multiply and add, and the C contraction) against P + 2N
// + 2 inputs read and P outputs written, so at the prefill shape (B 4, H 80,
// S 512, P 64, N 64) the f32 CUDA-core work outlasts the bytes; at decode
// (S 1) reading and writing the state bounds it.  Design: one thread per
// state row p holds h[p, 0:N] in registers, so the state never leaves the
// SM between s0 and sT, and y_t[p] is that thread's own dot product with
// C_t (no cross-thread reduction).  x, B, C, decay and dt of a chunk of
// time steps are staged in shared memory as f32, with one pair of barriers
// per chunk rather than per step; each thread then reads B_t[n] and C_t[n]
// as broadcasts (every thread the same address).  x and y are contiguous
// over p, so the loads of x and the stores of y coalesce.  x, B and C are
// taken through batch and time strides (the model hands in views of one
// (B, S, d_in + 2N) buffer), loaded element by element, so any pointer the
// dtype allows is taken, and the ragged last chunk is masked.  At the
// prefill shape this is 320 blocks of 64 threads, two or three warps per
// SM: the step-to-step dependence is not hidden, and the kernel stays
// several times off its bound.  More threads per row and wgmma for the C
// contraction over a chunk are the next steps.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;   // time steps per staged chunk
constexpr int kMaxP = 128;   // threads per block: one per state row

template <typename T, int N>
__global__ void __launch_bounds__(kMaxP)
mamba2_ssd_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ dc, const float* __restrict__ dt,
                  const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sT,
                  int H, int S, int64_t sxb, int64_t sxt, int64_t sbb, int64_t sbt,
                  int64_t scb, int64_t sct) {
  __shared__ __align__(16) float xs[kChunk][kMaxP];
  __shared__ __align__(16) float bs[kChunk][N];
  __shared__ __align__(16) float cs[kChunk][N];
  __shared__ float dcs[kChunk];
  __shared__ float dts[kChunk];

  const int P = blockDim.x;
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int p = threadIdx.x;  // the state row this thread owns
  const int64_t mat = static_cast<int64_t>(bh) * P * N;  // this (b, h)'s (P, N) state

  float st[N];
#pragma unroll
  for (int n = 0; n < N; ++n) st[n] = s0[mat + static_cast<int64_t>(p) * N + n];

  const T* xb = x + b * sxb + static_cast<int64_t>(h) * P + p;
  const T* bb = bm + b * sbb;
  const T* cb = cm + b * scb;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int nt = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int t = 0; t < nt; ++t) xs[t][p] = repro::to_float(xb[(t0 + t) * sxt]);
    for (int e = p; e < nt * N; e += P) {
      const int t = e / N;
      const int n = e - t * N;
      bs[t][n] = repro::to_float(bb[(t0 + t) * sbt + n]);
      cs[t][n] = repro::to_float(cb[(t0 + t) * sct + n]);
    }
    for (int t = p; t < nt; t += P) {
      const int64_t i = (static_cast<int64_t>(b) * S + t0 + t) * H + h;
      dcs[t] = dc[i];
      dts[t] = dt[i];
    }
    __syncthreads();
    for (int t = 0; t < nt; ++t) {
      const float u = dts[t] * xs[t][p];
      const float a = dcs[t];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int n = 0; n < N; ++n) {
        st[n] = fmaf(u, bs[t][n], a * st[n]);
        acc[n & 3] = fmaf(st[n], cs[t][n], acc[n & 3]);
      }
      y[((static_cast<int64_t>(b) * S + t0 + t) * H + h) * P + p] =
          (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

#pragma unroll
  for (int n = 0; n < N; ++n) sT[mat + static_cast<int64_t>(p) * N + n] = st[n];
}

template <typename T, int N>
cudaError_t launch(const void* x, const void* bm, const void* cm, const void* dc,
                   const void* dt, const void* s0, void* y, void* sT, int B, int H, int S,
                   int P, const int64_t* strides, cudaStream_t stream) {
  mamba2_ssd_kernel<T, N><<<B * H, P, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(dc), static_cast<const float*>(dt),
      static_cast<const float*>(s0), static_cast<float*>(y), static_cast<float*>(sT), H, S,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const void* x, const void* bm, const void* cm, const void* dc,
                       const void* dt, const void* s0, void* y, void* sT, int B, int H, int S,
                       int P, int N, const int64_t* strides, cudaStream_t stream) {
  switch (N) {
    case 8:
      return launch<T, 8>(x, bm, cm, dc, dt, s0, y, sT, B, H, S, P, strides, stream);
    case 16:
      return launch<T, 16>(x, bm, cm, dc, dt, s0, y, sT, B, H, S, P, strides, stream);
    case 32:
      return launch<T, 32>(x, bm, cm, dc, dt, s0, y, sT, B, H, S, P, strides, stream);
    case 64:
      return launch<T, 64>(x, bm, cm, dc, dt, s0, y, sT, B, H, S, P, strides, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B, S, H, P) in dtype with element strides (sxb, sxt, P, 1); bm, cm:
// (B, S, N) in dtype with strides (sbb, sbt, 1) and (scb, sct, 1); dc, dt:
// (B, S, H) f32 contiguous; s0, sT: (B, H, P, N) f32 contiguous; y: (B, S,
// H, P) f32 contiguous.  1 <= P <= 128, N in {8, 16, 32, 64}.  dtype:
// repro::DType.
extern "C" int repro_mamba2_ssd(const void* x, const void* bm, const void* cm, const void* dc,
                                const void* dt, const void* s0, void* y, void* sT, int B,
                                int H, int S, int P, int N, long long sxb, long long sxt,
                                long long sbb, long long sbt, long long scb, long long sct,
                                int dtype, int device, void* stream) {
  if (P < 1 || P > kMaxP) return cudaErrorInvalidValue;
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t strides[6] = {sxb, sxt, sbb, sbt, scb, sct};
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_n<float>(x, bm, cm, dc, dt, s0, y, sT, B, H, S, P, N, strides, s);
    case repro::kBFloat16:
      return dispatch_n<__nv_bfloat16>(x, bm, cm, dc, dt, s0, y, sT, B, H, S, P, N, strides,
                                       s);
    default:
      return cudaErrorInvalidValue;
  }
}
