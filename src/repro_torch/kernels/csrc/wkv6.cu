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
// H 64, S 512, hd 64) the f32 CUDA-core work outlasts the bytes (0.0407
// against 0.0275 ms); at decode (S 1) reading and writing the state bounds
// it (0.0026 ms).  The recurrence is sequential in t, so the parallelism is
// across (b, h) and across the state's elements.  Two kernels sit behind
// the entry, chosen by S:
//
// S > 1 (wkv6_tile_kernel).  What held the first design (below) back at
// prefill was shared memory, not the FMAs: one thread per column j read
// r_t[i], k_t[i], w_t[i] and u[i] as four scalar broadcasts per state
// element, 16 bytes out of shared memory for 5 f32 operations, and the
// SM's shared-memory port (128 bytes a clock) ran behind its FP32 units.
// Here each thread holds a tile of the state in registers, hd/8 rows by 8
// columns at hd 64 (4 columns at hd 16 and 32), and reuses each value it
// reads: the rows' r, k and w as one load of 4 rows each (8 bytes in
// bf16), the columns' v likewise, u in registers; well under a byte of
// shared memory per state element and step.  hd threads own a (b, h) at
// hd 64 (2 warps), 2 hd at hd 16 and 32: eight lanes share each column group, and
// y_t[j] is their partial sums reduced with a transposed butterfly, three
// rounds of shuffles that leave each lane of the group (each of 4, at 4
// columns) with one column's total.  Each state element sees the same f32
// operations in the same order as the plain version (kv = k v, then
// y += r (S + u kv), S = w S + kv); only y_t's sum is regrouped.  A
// thread's rows are 4-row runs 32 apart (rows 4 rg + 32 m + c), so the 8
// lanes of a group read one contiguous run of each input row.  r, k, v and
// w arrive in shared memory in their dtype, a chunk of steps at a time:
// 16-byte cp.async copies, double-buffered (the next chunk's under this
// chunk's math), when the inputs are 16-byte aligned, and element by
// element otherwise.  The state is read and written as float4: a warp's
// loads and stores are whole 32-byte row runs.  Measured, 8 columns beat
// 4 (twice the warps, but more loads and shuffles per element; PERF.md,
// scripts/kernel_variants.py).  What is left is one warp per scheduler
// issuing 4 dependent f32 operations per element and step.
//
// S == 1 (wkv6_column_kernel, the first design).  One thread per state
// column j holds S[:, j] in registers; r, k, w and v are staged in shared
// memory as f32 and read as broadcasts, y_t[j] in four partial sums.  Its
// state loads and stores are one coalesced 128-byte row per warp, and at
// decode it measured faster than the tile kernel (PERF.md,
// scripts/kernel_variants.py), so decode keeps it.  The ragged last chunk
// is masked in both.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kStageFloats = 2048;  // floats per staged array: kChunk * HD

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_column_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
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

// ---------------------------------------------------------------------------
// prefill (S > 1): a register tile of the state per thread
// ---------------------------------------------------------------------------

constexpr int kRowGroups = 8;  // threads that share a column group

template <typename T, int HD>
struct Wkv6 {
  static constexpr int kCols = HD >= 64 ? 8 : 4;             // state columns per thread
  static constexpr int kThreads = (HD / kCols) * kRowGroups;
  static constexpr int kRows = HD / kRowGroups;               // state rows per thread
  static constexpr int kVec = kRows < 4 ? kRows : 4;          // rows per vector load
  static constexpr int kRuns = kRows / kVec;                  // runs of kVec rows
  static constexpr int kChunk = 4096 / (HD * sizeof(T));       // steps per staged chunk
  static constexpr int kElems = kChunk * HD;                  // elements per staged array
  static_assert(kElems * sizeof(T) % 16 == 0, "a staged chunk must be whole 16-byte copies");
};

// V consecutive elements widened to f32 into o[0 .. V): one load of 4 to
// 16 bytes.
template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x, o[1] = v.y;
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  if constexpr (V == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    o[0] = a.x, o[1] = a.y, o[2] = b.x, o[3] = b.y;
  } else {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x, o[1] = a.y;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Wkv6<T, HD>::kThreads)
wkv6_tile_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ w, const float* __restrict__ u,
                 const float* __restrict__ s0, T* __restrict__ y, float* __restrict__ sT,
                 int H, int S) {
  using C = Wkv6<T, HD>;
  // two buffers of r, k, v, w as they arrive, in T
  __shared__ __align__(16) unsigned char raw_bytes[2 * 4 * C::kElems * sizeof(T)];
  auto raw = [&](int buf, int a) {
    return reinterpret_cast<T*>(raw_bytes) + (buf * 4 + a) * C::kElems;
  };

  const int bh = blockIdx.x;  // b * H + h
  const int tid = threadIdx.x;
  const int rg = tid & (kRowGroups - 1);      // row group
  constexpr int kCols = C::kCols;
  const int j0 = (tid / kRowGroups) * kCols;  // first of this thread's columns
  const int64_t seq = static_cast<int64_t>(bh) * S * HD;   // this (b, h)'s (S, hd) slice
  const int64_t mat = static_cast<int64_t>(bh) * HD * HD;  // this (b, h)'s (hd, hd) state
  // the state row of register row m * kVec + c
  auto row = [&](int m, int c) { return rg * C::kVec + m * kRowGroups * C::kVec + c; };

  const bool vec_state =
      ((reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(sT)) & 15) == 0;
  float st[C::kRows][kCols];
  float uu[C::kRows];
#pragma unroll
  for (int m = 0; m < C::kRuns; ++m)
#pragma unroll
    for (int c = 0; c < C::kVec; ++c) {
      const int q = m * C::kVec + c;
      const int64_t e = mat + static_cast<int64_t>(row(m, c)) * HD + j0;
      if (vec_state) {
#pragma unroll
        for (int jj = 0; jj < kCols; jj += 4) load_vec<4>(s0 + e + jj, st[q] + jj);
      } else {
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) st[q][jj] = s0[e + jj];
      }
      uu[q] = u[(bh % H) * HD + row(m, c)];
    }

  const bool vec_in = ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w)) &
                       15) == 0;
  // steps [t0, t0 + kChunk) of r, k, v, w into raw buffer `buf`
  auto load = [&](int t0, int buf) {
    const int n = min(C::kChunk, S - t0) * HD;  // elements per array
    const T* src[4] = {r, k, v, w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T* g = src[a] + seq + static_cast<int64_t>(t0) * HD;
      T* d = raw(buf, a);
      if (vec_in) {
        constexpr int kPer = 16 / static_cast<int>(sizeof(T));
        for (int e = tid * kPer; e < n; e += C::kThreads * kPer)
          repro::cp_async_16(repro::smem_u32(d + e), g + e, 16);
      } else {
        for (int e = tid; e < n; e += C::kThreads) d[e] = g[e];
      }
    }
  };

  load(0, 0);
  repro::cp_async_commit();
  for (int t0 = 0, cur = 0; t0 < S; t0 += C::kChunk, cur ^= 1) {
    const int n = min(C::kChunk, S - t0);
    if (t0 + C::kChunk < S) {  // the next chunk into the other buffer, under this one's math
      load(t0 + C::kChunk, cur ^ 1);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();  // this chunk is in place
    const T* in[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) in[a] = raw(cur, a);
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      float vv[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; jj += 4) load_vec<4>(in[2] + t * HD + j0 + jj, vv + jj);
      float acc[kCols];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[jj] = 0.f;
#pragma unroll
      for (int m = 0; m < C::kRuns; ++m) {
        const int i0 = t * HD + row(m, 0);
        float rr[C::kVec], kk[C::kVec], ww[C::kVec];
        load_vec<C::kVec>(in[0] + i0, rr);
        load_vec<C::kVec>(in[1] + i0, kk);
        load_vec<C::kVec>(in[3] + i0, ww);
#pragma unroll
        for (int c = 0; c < C::kVec; ++c) {
          const int q = m * C::kVec + c;
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj) {
            const float kv = kk[c] * vv[jj];
            acc[jj] += rr[c] * (st[q][jj] + uu[q] * kv);
            st[q][jj] = ww[c] * st[q][jj] + kv;
          }
        }
      }
      // sum over the 8 row groups, a transposed butterfly: each xor step
      // halves the columns a lane keeps (the upper half where its bit of rg
      // is set) and adds its partner's share of them, until each lane holds
      // one column's total (column 2 b0 + b1 of 4, or 4 b0 + 2 b1 + b2 of
      // 8, b_i = bit i of rg); steps past that add the remaining halves
      int col = 0;
#pragma unroll
      for (int off = 1, width = kCols; off < kRowGroups; off <<= 1) {
        const bool up = rg & off;
        if (width > 1) {
          width >>= 1;
#pragma unroll
          for (int i = 0; i < width; ++i) {
            const float keep = up ? acc[width + i] : acc[i];
            const float give = up ? acc[i] : acc[width + i];
            acc[i] = keep + __shfl_xor_sync(0xffffffffu, give, off);
          }
          col += up ? width : 0;
        } else {
          acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], off);
        }
      }
      if (rg < kCols)
        y[seq + static_cast<int64_t>(t0 + t) * HD + j0 + col] = repro::from_float<T>(acc[0]);
    }
    __syncthreads();  // every thread is done with this chunk's buffers
  }

#pragma unroll
  for (int m = 0; m < C::kRuns; ++m)
#pragma unroll
    for (int c = 0; c < C::kVec; ++c) {
      const int q = m * C::kVec + c;
      const int64_t e = mat + static_cast<int64_t>(row(m, c)) * HD + j0;
      if (vec_state) {
#pragma unroll
        for (int jj = 0; jj < kCols; jj += 4)
          *reinterpret_cast<float4*>(sT + e + jj) =
              make_float4(st[q][jj], st[q][jj + 1], st[q][jj + 2], st[q][jj + 3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) sT[e + jj] = st[q][jj];
      }
    }
}

template <typename T, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* sT, int BH, int H, int S,
                   cudaStream_t stream) {
  const auto* rr = static_cast<const T*>(r);
  const auto* kk = static_cast<const T*>(k);
  const auto* vv = static_cast<const T*>(v);
  const auto* ww = static_cast<const T*>(w);
  const auto* uu = static_cast<const float*>(u);
  const auto* s0f = static_cast<const float*>(s0);
  auto* yy = static_cast<T*>(y);
  auto* sTf = static_cast<float*>(sT);
  if (S == 1)
    wkv6_column_kernel<T, HD><<<BH, HD, 0, stream>>>(rr, kk, vv, ww, uu, s0f, yy, sTf, H, S);
  else
    wkv6_tile_kernel<T, HD><<<BH, Wkv6<T, HD>::kThreads, 0, stream>>>(rr, kk, vv, ww, uu, s0f,
                                                                       yy, sTf, H, S);
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
