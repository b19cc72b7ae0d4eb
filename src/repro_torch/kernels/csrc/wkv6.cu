// WKV6 recurrence (the RWKV6 "Finch" time-mix inner loop), forward:
//
//   y_t[j] = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//   S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// for each (batch, head) over t = 0 .. S-1, from the initial state s0;
// y is returned in the input dtype and the final state in f32.
//
// Replaces repro/kernels/rwkv6_scan.py:rwkv6_scan_pallas (_wkv6_kernel).
// The Pallas kernel walks time as a sequential grid axis and carries the
// (hd, hd) f32 state from one time chunk to the next in VMEM scratch.  CUDA
// blocks run in no order, so here one block owns one (b, h) for the whole
// sequence and loops over time itself; nothing carries between blocks, and
// the kernel takes any S (no chunk-multiple rule, no fallback).
//
// Bound on the H100: operations at prefill, bytes at decode.  Each step
// does about 5 f32 operations per state element (hd^2 of them) against
// 4*hd inputs read and hd outputs written, so at the prefill shape (B 4,
// H 64, S 512, hd 64) the f32 CUDA-core work outlasts the bytes; at decode
// (S 1) reading and writing the state bounds it.  The recurrence is
// sequential in t, so the parallelism is across (b, h) and across the hd
// state columns.  Design: one thread per state column j holds S[:, j] in
// registers (hd floats), so the state never leaves the SM between s0 and
// sT.  r, k, w and v of a chunk of time steps are staged in shared memory
// as f32, with one pair of barriers per chunk rather than per step; each
// thread then reads r_t[i], k_t[i], w_t[i] and u[i] as broadcasts (every
// thread the same address) and v_t[j] from its own bank.  y_t[j] is summed
// in four partial sums to shorten the dependent FMA chain.  Loads and
// stores go element by element, so any pointer the dtype allows is taken,
// and the ragged last chunk is masked.  At the prefill shape this is 256
// blocks of 64 threads, about two warps per scheduler: the step-to-step
// dependence is not hidden, and the kernel stays several times off its
// bound.  Splitting each column over several threads (more warps, shorter
// chains) is the next step.
#include "common.cuh"

namespace {

constexpr int kStageFloats = 2048;  // floats per staged array: kChunk * HD

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT,
            int H, int S) {
  constexpr int kChunk = kStageFloats / HD;  // time steps per staged chunk
  __shared__ __align__(16) float rs[kChunk][HD];
  __shared__ __align__(16) float ks[kChunk][HD];
  __shared__ __align__(16) float ws[kChunk][HD];
  __shared__ __align__(16) float vs[kChunk][HD];
  __shared__ __align__(16) float us[HD];

  const int bh = blockIdx.x;  // b * H + h
  const int j = threadIdx.x;  // the state column this thread owns
  const int64_t seq = static_cast<int64_t>(bh) * S * HD;  // this (b, h)'s (S, hd) slice
  const int64_t mat = static_cast<int64_t>(bh) * HD * HD;  // this (b, h)'s (hd, hd) state

  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = s0[mat + i * HD + j];
  us[j] = u[(bh % H) * HD + j];

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is consumed (and us is written)
    const int64_t base = seq + static_cast<int64_t>(t0) * HD;
    for (int e = j; e < n * HD; e += HD) {
      (&rs[0][0])[e] = repro::to_float(r[base + e]);
      (&ks[0][0])[e] = repro::to_float(k[base + e]);
      (&ws[0][0])[e] = repro::to_float(w[base + e]);
      (&vs[0][0])[e] = repro::to_float(v[base + e]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = ks[t][i] * vj;
        acc[i & 3] += rs[t][i] * (st[i] + us[i] * kv);
        st[i] = ws[t][i] * st[i] + kv;
      }
      y[base + static_cast<int64_t>(t) * HD + j] =
          repro::from_float<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

#pragma unroll
  for (int i = 0; i < HD; ++i) sT[mat + i * HD + j] = st[i];
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* sT, int BH, int H, int S,
                   cudaStream_t stream) {
  wkv6_kernel<T, HD><<<BH, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), H, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* sT, int BH, int H,
                        int S, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, y, sT, BH, H, S, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, sT, BH, H, S, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, sT, BH, H, S, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v, w, y: (B, H, S, hd) in dtype; u: (H, hd) f32; s0, sT: (B, H, hd,
// hd) f32; all contiguous, BH = B * H, hd in {16, 32, 64}.  dtype:
// repro::DType.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, const void* w,
                          const void* u, const void* s0, void* y, void* sT, int BH, int H,
                          int S, int hd, int dtype, int device, void* stream) {
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_hd<float>(r, k, v, w, u, s0, y, sT, BH, H, S, hd, s);
    case repro::kBFloat16:
      return dispatch_hd<__nv_bfloat16>(r, k, v, w, u, s0, y, sT, BH, H, S, hd, s);
    default:
      return cudaErrorInvalidValue;
  }
}
