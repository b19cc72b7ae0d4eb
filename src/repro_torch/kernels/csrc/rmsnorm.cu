// RMSNorm over the last dimension: y = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces repro/kernels/rmsnorm.py:rmsnorm_pallas (_rmsnorm_kernel), the
// row-blocked Pallas kernel.  It is held to the oracle
// (repro/kernels/ref.py:rmsnorm), not to the Pallas body: the oracle rounds
// x * rms to the input dtype before the scale multiply, and the JAX serving
// path runs the oracle.
//
// Bound on the H100: bytes.  Each row is read once and written once (plus
// the d-wide scale, which stays in L1/L2); the arithmetic is ~3 flops per
// element.  Design: one 256-thread block per row, sum of squares in f32
// with warp shuffles and one shared-memory step across the 8 warps, then a
// second pass over the row (now in L1/L2) that normalises, rounds and
// scales.  Rows are independent, so a block carries nothing to the next.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = repro::to_float(xr[i]);
    ss += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float warp_sums[kThreads / 32];
  __shared__ float inv_rms;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const T normed = repro::from_float<T>(repro::to_float(xr[i]) * r);
    orow[i] = repro::from_float<T>(repro::to_float(normed) * repro::to_float(scale[i]));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d,
                   float eps, cudaStream_t stream) {
  rmsnorm_kernel<T><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous; scale: (d,).  dtype: repro::DType.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out, int rows, int d,
                             float eps, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return launch<float>(x, scale, out, rows, d, eps, s);
    case repro::kBFloat16:
      return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}
