// RMSNorm over the last dimension: y = (x * rsqrt(mean(x^2) + eps)) * scale.
//
// Replaces repro/kernels/rmsnorm.py:rmsnorm_pallas (_rmsnorm_kernel), the
// row-blocked Pallas kernel.  It is held to the oracle
// (repro/kernels/ref.py:rmsnorm), not to the Pallas body: the oracle rounds
// x * rms to the input dtype before the scale multiply, and the JAX serving
// path runs the oracle.
//
// Bound on the H100: bytes.  Each row is read once and written once (plus
// the d-wide scale, which stays in L1/L2); the arithmetic is ~4 flops per
// element.  Design: one pass.  A row is cut into 16-byte chunks (8 bf16 or
// 4 f32); each thread loads at most kChunks of them, all issued before the
// first is used, and keeps them in registers.  The sum of squares is taken
// in f32 with warp shuffles and, where a row spans several warps, one
// shared-memory step; the thread then normalises, rounds and scales its own
// registers and writes 16-byte chunks.  The block is sized by d: a row of
// at most 32 x kChunks chunks (d <= 1024 in bf16, the qk_norm head dims
// among them) takes one warp and a block holds 4 such rows; a longer row
// takes ceil(chunks / (32 kChunks)) warps (2 at d 2048 in bf16, 3 at 2560,
// 4 at 4096).  Where d is not a multiple of the chunk or a pointer is not
// 16-byte aligned (a view such as x[1:]), the same kernel loads and stores
// element by element (kVector false): still one read of the row.
#include "common.cuh"

namespace {

constexpr int kChunks = 4;      // 16-byte chunks of the row per thread
constexpr int kMaxWarps = 32;   // warps per row: rows of up to 4096 chunks
constexpr int kRowsPerWarpBlock = 4;

template <typename T>
struct Chunk {
  static constexpr int kElems = 16 / sizeof(T);
};

// One 16-byte chunk to f32, and back.
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return raw;
}

// Chunk c of a row of d elements into f (zeros past d).
template <typename T, bool kVector>
__device__ __forceinline__ void load_chunk(const T* __restrict__ row, int c, int d,
                                           float (&f)[Chunk<T>::kElems]) {
  constexpr int kE = Chunk<T>::kElems;
  if (kVector) {
    unpack(__ldg(reinterpret_cast<const uint4*>(row + c * kE)), f);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = c * kE + e;
      f[e] = i < d ? repro::to_float(row[i]) : 0.f;
    }
  }
}

template <typename T, bool kVector>
__device__ __forceinline__ void store_chunk(T* __restrict__ row, int c, int d,
                                            const float (&f)[Chunk<T>::kElems]) {
  constexpr int kE = Chunk<T>::kElems;
  if (kVector) {
    *reinterpret_cast<uint4*>(row + c * kE) = pack(f);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int i = c * kE + e;
      if (i < d) row[i] = repro::from_float<T>(f[e]);
    }
  }
}

// blockDim.x = 32 x (warps per row), blockDim.y = rows per block (more than
// one only when a row takes one warp).
template <typename T, bool kVector>
__global__ void __launch_bounds__(1024)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ out,
               int rows, int d, float eps) {
  constexpr int kE = Chunk<T>::kElems;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  // only one-warp rows share a block, and they meet no barrier below
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int nchunks = (d + kE - 1) / kE;

  float v[kChunks][kE];
  float ss = 0.f;
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int c = threadIdx.x + it * blockDim.x;
    if (c < nchunks) {
      load_chunk<T, kVector>(xr, c, d, v[it]);
    } else {
#pragma unroll
      for (int e = 0; e < kE; ++e) v[it][e] = 0.f;
    }
  }
#pragma unroll
  for (int it = 0; it < kChunks; ++it)
#pragma unroll
    for (int e = 0; e < kE; ++e) ss = fmaf(v[it][e], v[it][e], ss);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);

  if (blockDim.x > 32) {  // the row spans several warps: one shared-memory step
    __shared__ float warp_sums[kMaxWarps];
    const int warps = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < warps; ++w) ss += warp_sums[w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int c = threadIdx.x + it * blockDim.x;
    if (c < nchunks) {
      float s[kE];
      load_chunk<T, kVector>(scale, c, d, s);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        // rounded to T before the scale multiply, as the oracle does
        const float normed = repro::to_float(repro::from_float<T>(v[it][e] * r));
        v[it][e] = normed * s[e];
      }
      store_chunk<T, kVector>(orow, c, d, v[it]);
    }
  }
}

template <typename T, bool kVector>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int kE = Chunk<T>::kElems;
  const int nchunks = (d + kE - 1) / kE;
  const int warps = (nchunks + 32 * kChunks - 1) / (32 * kChunks);
  if (warps > kMaxWarps) return cudaErrorInvalidValue;
  const int per_block = warps == 1 ? kRowsPerWarpBlock : 1;
  const dim3 block(32 * warps, per_block);
  const unsigned grid = static_cast<unsigned>((rows + per_block - 1) / per_block);
  rmsnorm_kernel<T, kVector><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(out), rows,
      d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* scale, void* out, int rows, int d,
                     float eps, int vector, cudaStream_t stream) {
  return vector ? launch<T, true>(x, scale, out, rows, d, eps, stream)
                : launch<T, false>(x, scale, out, rows, d, eps, stream);
}

}  // namespace

// x, out: (rows, d) contiguous; scale: (d,).  vector: d is a multiple of
// the 16-byte chunk and x, scale and out are 16-byte aligned.  dtype:
// repro::DType.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out, int rows, int d,
                             float eps, int vector, int dtype, int device, void* stream) {
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kFloat32:
      return dispatch<float>(x, scale, out, rows, d, eps, vector, s);
    case repro::kBFloat16:
      return dispatch<__nv_bfloat16>(x, scale, out, rows, d, eps, vector, s);
    default:
      return cudaErrorInvalidValue;
  }
}
