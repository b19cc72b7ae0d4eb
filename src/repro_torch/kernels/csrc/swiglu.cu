// Fused SwiGLU: out = silu(gate) * up, silu and product in f32, output in
// the input dtype.
//
// Replaces repro/kernels/swiglu.py:swiglu_pallas (_swiglu_kernel), the 2-D
// blocked elementwise Pallas kernel.
//
// Bound on the H100: bytes.  Two reads and one write per element against a
// handful of flops and one exp.  Design: a flat grid-stride pass in which
// each thread moves 16 bytes per operand per step (8 bf16 or 4 f32 values,
// one uint4 load each) when all three pointers are 16-byte aligned, so a
// warp moves full 512-byte transactions; the n % 8 (or n % 4) tail, and
// any unaligned call, goes element by element.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T swiglu_one(T g, T u) {
  const float gf = repro::to_float(g);
  return repro::from_float<T>(gf / (1.f + expf(-gf)) * repro::to_float(u));
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
swiglu_kernel(const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ o, int64_t n) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int64_t nvec = kVector ? n / kVec : 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVector) {
    for (int64_t i = tid; i < nvec; i += stride) {
      const uint4 gv = reinterpret_cast<const uint4*>(g)[i];
      const uint4 uv = reinterpret_cast<const uint4*>(u)[i];
      uint4 ov;
      const T* ga = reinterpret_cast<const T*>(&gv);
      const T* ua = reinterpret_cast<const T*>(&uv);
      T* oa = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int j = 0; j < kVec; ++j) oa[j] = swiglu_one(ga[j], ua[j]);
      reinterpret_cast<uint4*>(o)[i] = ov;
    }
  }
  for (int64_t i = nvec * kVec + tid; i < n; i += stride) o[i] = swiglu_one(g[i], u[i]);
}

template <typename T>
cudaError_t launch(const void* g, const void* u, void* o, int64_t n, int aligned,
                   cudaStream_t stream) {
  const int64_t per_thread = aligned ? 16 / static_cast<int64_t>(sizeof(T)) : 1;
  const int64_t work = (n + per_thread - 1) / per_thread;
  const int64_t blocks64 = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(blocks64 < 65536 ? (blocks64 > 0 ? blocks64 : 1) : 65536);
  const T* gp = static_cast<const T*>(g);
  const T* up = static_cast<const T*>(u);
  T* op = static_cast<T*>(o);
  if (aligned) {
    swiglu_kernel<T, true><<<blocks, kThreads, 0, stream>>>(gp, up, op, n);
  } else {
    swiglu_kernel<T, false><<<blocks, kThreads, 0, stream>>>(gp, up, op, n);
  }
  return cudaGetLastError();
}

}  // namespace

// gate, up, out: n contiguous elements.  aligned: all three pointers are
// 16-byte aligned.  dtype: repro::DType.
extern "C" int repro_swiglu(const void* gate, const void* up, void* out, long long n,
                            int aligned, int dtype, int device, void* stream) {
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(gate, up, out, n, aligned, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(gate, up, out, n, aligned, s);
    default:
      return cudaErrorInvalidValue;
  }
}
