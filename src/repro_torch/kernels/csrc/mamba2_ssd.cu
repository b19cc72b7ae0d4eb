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
// here a block owns whole (b, h) rows of the state and loops over time
// itself; nothing carries between blocks, and every S is taken.
//
// Three kernels sit behind the one entry, chosen by this rule (route()):
//
//   S == 1                                          decode      (any dtype)
//   S > 1, bf16, P and N multiples of 16            chunked     (tensor cores)
//   otherwise (f32 inputs; P or N off 16)           sequential  (CUDA cores)
//
// Bounds on the H100, at zamba2's widths (B 4, H 80, P 64, N 64):
//
// decode (ssd_decode_kernel): bytes.  One step reads and writes the f32
// state, 10.6 MB in all, 0.0032 ms at 3.35 TB/s; the work is 5 operations
// per state element.  Each thread owns 4 consecutive n of one state row, so
// N/4 neighbouring lanes cover a row and a warp's float4 loads and stores of
// s0 and sT are whole 512-byte runs.  y[p] is a shuffle sum over the row's
// lanes.  No shared memory, no barrier; B*H*P*N/4 threads in blocks of 256
// (1280 blocks at the serving shape).
//
// chunked (ssd_chunked_kernel): bytes (75 MB at S 512, 0.0225 ms; its
// tensor work, 10.7 GFLOP with the splits below, is 0.011 ms).  The SSD
// "chunked" form: per chunk of L steps, with D[t,s] = decay_{s+1} ...
// decay_t (1 on the diagonal) and D0[t] = decay_0 ... decay_t,
//
//   G = C B^T                       (L x L over N)
//   M[t,s] = G[t,s] * (D[t,s] dt_s)                 s <= t, else 0
//   y = D0[t] * (C h^T) + M X
//   h <- D0[L-1] h + (X * w)^T B    w_s = D[L-1,s] dt_s
//
// on warp-level tensor cores (mma.sync m16n8k16, bf16 in, f32 sums).  G's
// operands are bf16 x bf16: exact products, f32 sums.  The products whose
// one operand is f32 (M, h, X * w) take that operand as three bf16 terms,
// each the rounding of what the terms before it leave (split3), against the
// bf16 one: a0 + a1 + a2 keeps about 24 bits, so the kernel stays within
// the f32 tolerance of the sequential plain version (one bf16 term misses
// it by 400x, two by little).  D is a running product down each column s,
// the masked running sum of log decay taken in the product domain: a decay
// of exactly 0 gives 0 and never 0/0 or -inf - -inf, and one of exactly 1
// changes nothing.
//
// A block owns one (b, h) and walks its chunks in order, the state in
// registers as mma accumulators.  P/16 consumer warps (4 at the serving
// shape) each own 16 state rows and the same 16 columns p of y; the
// accumulator layout of h is the B-operand layout of C h^T, so h is split
// into bf16 terms in registers and never touches shared memory.  M is
// shared: its 16 x 16 blocks at or below the diagonal are dealt out to the
// consumer warps in turn, and each stores its three bf16 terms in shared
// memory for M X.  One more warp, the producer, stages the next chunk's x,
// B and C with 16-byte cp.async copies into a second buffer (element by
// element when a view is not 16-byte aligned; the model's are: row stride
// 5248 x 2 B), and forms the next chunk's D dt, D0 and w (the running
// products, L steps long at most, a serial chain per column) while the
// consumers compute on this one; two barriers a chunk.  L is 32, not 64:
// at 32 the block needs 40 KB of shared memory and 125 registers a thread,
// so 3 blocks fit an SM and the 320 blocks of the serving shape run in one
// wave; at 64 (100 KB, 157 registers) 2 fit and a second, partial wave
// follows (PERF.md, scripts/kernel_variants.py).  The ragged last chunk is
// zero-filled, with decay 1 and dt 0, so its rows past S change nothing and
// are not stored.  Blocks of M above the diagonal are skipped.
//
// sequential (ssd_sequential_kernel, the first design): f32 inputs (f32 x, B
// and C have no exact bf16 form) and state shapes the 16-wide tensor-core
// tiles do not fit.  One thread per state row p holds h[p, 0:N] in
// registers; x, B, C, decay and dt of 32 steps are staged in shared memory
// as f32 and read as broadcasts; y_t[p] is the thread's own dot product.
// It is bound by operations at prefill and leaves the step-to-step
// dependence exposed (one or two warps per SM), several times off its
// bound, as it was when it was the only kernel.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;

enum Route : int { kSequential = 0, kDecode = 1, kChunked = 2 };

int route(int S, int P, int N, int dtype) {
  if (S == 1) return kDecode;
  if (S > 1 && dtype == repro::kBFloat16 && P % 16 == 0 && N % 16 == 0) return kChunked;
  return kSequential;
}

// ---------------------------------------------------------------------------
// sequential: one thread per state row
// ---------------------------------------------------------------------------

constexpr int kChunk = 32;   // time steps per staged chunk
constexpr int kMaxP = 128;   // threads per block: one per state row

template <typename T, int N>
__global__ void __launch_bounds__(kMaxP)
ssd_sequential_kernel(const T* __restrict__ x, const T* __restrict__ bm,
                      const T* __restrict__ cm, const float* __restrict__ dc,
                      const float* __restrict__ dt, const float* __restrict__ s0,
                      float* __restrict__ y, float* __restrict__ sT, int H, int S, int64_t sxb,
                      int64_t sxt, int64_t sbb, int64_t sbt, int64_t scb, int64_t sct) {
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

// ---------------------------------------------------------------------------
// decode (S == 1): N/4 lanes per state row, float4 state traffic
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 256;

template <typename T, int N>
__global__ void __launch_bounds__(kDecodeThreads)
ssd_decode_kernel(const T* __restrict__ x, const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ dc, const float* __restrict__ dt,
                  const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ sT,
                  int H, int P, int64_t rows, int64_t sxb, int64_t sbb, int64_t scb) {
  constexpr int kLanes = N / 4;  // threads per state row, 4 n each
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kDecodeThreads + threadIdx.x;
  const int64_t row = i / kLanes;  // (b * H + h) * P + p
  const int n0 = static_cast<int>(i - row * kLanes) * 4;
  // the state is read and written as float4 when both ends allow it
  const bool vec = ((reinterpret_cast<uintptr_t>(s0) | reinterpret_cast<uintptr_t>(sT)) & 15) == 0;
  float part = 0.f;
  if (row < rows) {  // whole rows past the end: their lanes only join the shuffles
    const int64_t bh = row / P;
    const int p = static_cast<int>(row - bh * P);
    const int64_t b = bh / H;
    const int h = static_cast<int>(bh - b * H);
    const float u = dt[bh] * repro::to_float(x[b * sxb + static_cast<int64_t>(h) * P + p]);
    const float a = dc[bh];
    const int64_t e = row * N + n0;  // this thread's first state element
    float st[4];
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(s0 + e);
      st[0] = v.x, st[1] = v.y, st[2] = v.z, st[3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) st[c] = s0[e + c];
    }
    const T* bb = bm + b * sbb + n0;
    const T* cb = cm + b * scb + n0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      st[c] = fmaf(u, repro::to_float(bb[c]), a * st[c]);
      part = fmaf(st[c], repro::to_float(cb[c]), part);
    }
    if (vec) {
      *reinterpret_cast<float4*>(sT + e) = make_float4(st[0], st[1], st[2], st[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) sT[e + c] = st[c];
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (row < rows && n0 == 0) y[row] = part;  // y: (B, 1, H, P), row-major as the state rows
}

// ---------------------------------------------------------------------------
// chunked: the SSD chunk form on tensor cores (bf16 x, B, C)
// ---------------------------------------------------------------------------

constexpr int kL = 32;  // time steps per chunk

// (lo, hi) f32 as three bf16x2 terms, each the bf16 rounding of what the
// terms before it leave: lo = lo0 + lo1 + lo2 to about 24 bits.
__device__ __forceinline__ void split3(float lo, float hi, uint32_t (&t)[3]) {
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(lo, hi);
  const float2 f0 = __bfloat1622float2(p0);
  const float rl = lo - f0.x;
  const float rh = hi - f0.y;
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(rl, rh);
  const float2 f1 = __bfloat1622float2(p1);
  const __nv_bfloat162 p2 = __floats2bfloat162_rn(rl - f1.x, rh - f1.y);
  t[0] = *reinterpret_cast<const uint32_t*>(&p0);
  t[1] = *reinterpret_cast<const uint32_t*>(&p1);
  t[2] = *reinterpret_cast<const uint32_t*>(&p2);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

constexpr int kMSplitBytes = (kL + 8) * 2;     // one bf16 term of an M row, padded
constexpr int kMRowBytes = 3 * kMSplitBytes;    // M's three terms of row t
constexpr int kWStride = kL + 8;                // floats per row of D dt
static_assert(kL % 32 == 0, "the producer forms D dt a warp's width of columns at a time");

// dynamic shared memory of one block: x, B and C (two buffers each), M's
// terms, D dt, and D0 and w (two buffers each)
__host__ __device__ constexpr int chunk_smem_bytes(int P, int N) {
  return (2 * kL * (P + 8) + 4 * kL * (N + 8)) * 2 + kL * kMRowBytes + kL * kWStride * 4 +
         4 * kL * 4;
}

// decay and dt of a chunk at steps lane + 32 r, held by the producer lane
struct Decays {
  float dc[kL / 32];
  float dt[kL / 32];
};

// kWide: P above 64 (up to 288 threads); otherwise at most 160 threads, and
// the registers are held to what 3 blocks an SM leave
template <int N, bool kWide>
__global__ void __launch_bounds__(kWide ? 2 * kMaxP + 32 : 2 * 64 + 32, kWide ? 1 : 3)
ssd_chunked_kernel(const bf16* __restrict__ x, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, const float* __restrict__ dc,
                   const float* __restrict__ dt, const float* __restrict__ s0,
                   float* __restrict__ y, float* __restrict__ sT, int H, int S, int P,
                   int64_t sxb, int64_t sxt, int64_t sbb, int64_t sbt, int64_t scb,
                   int64_t sct, int vec) {
  constexpr int L = kL;
  constexpr int NS = N + 8;   // elements per B / C row in shared memory: +16 B
  constexpr int kNT = N / 8;  // n-tiles of the state
  constexpr int kT = L / 16;  // 16-step tiles per chunk
  static_assert(N % 16 == 0, "the chunked kernel takes N a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  const int XS = P + 8;  // elements per x row in shared memory
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [2][L][XS]
  bf16* bs = xs + 2 * L * XS;                // [2][L][NS]
  bf16* cs = bs + 2 * L * NS;                // [2][L][NS]
  unsigned char* ms = reinterpret_cast<unsigned char*>(cs + 2 * L * NS);  // [L][kMRowBytes]
  float* wm = reinterpret_cast<float*>(ms + L * kMRowBytes);  // D dt: [L][kWStride]
  float* d0s = wm + L * kWStride;  // [2][L]: D0[t] = decay_0 ... decay_t
  float* wsv = d0s + 2 * L;           // [2][L]: w_s = D[L-1, s] dt_s
  auto mrow = [&](int t, int k) {
    return reinterpret_cast<bf16*>(ms + t * kMRowBytes + k * kMSplitBytes);
  };

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = P / 16;  // consumer warps; warp nwarps is the producer
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int nc = (S + L - 1) / L;

  if (warp == nwarps) {
    // ---- producer: stages x, B, C and forms D dt, D0 and w a chunk ahead
    const bf16* xb = x + b * sxb + static_cast<int64_t>(h) * P;  // step t at xb + t * sxt
    const bf16* bb = bm + b * sbb;
    const bf16* cb = cm + b * scb;
    const int64_t vbase = static_cast<int64_t>(b) * S * H + h;  // decay, dt of step t: + t * H
    // x, B and C of chunk c into buffer c & 1: 16-byte cp.async copies (a
    // lane takes one 16-byte column q of every (32 / chunks per row)-th
    // row), or element by element when the views are not 16-byte aligned;
    // rows past S are zero-filled
    auto stage = [&](int c) {
      const int c0 = c * L;
      const int n = min(L, S - c0);
      bf16* xd = xs + (c & 1) * L * XS;
      bf16* bd = bs + (c & 1) * L * NS;
      bf16* cd = cs + (c & 1) * L * NS;
      if (vec) {
        const int xch = P / 8;  // 16-byte chunks per x row (2 .. 16)
        const int xq = lane % xch;
        if (lane < (32 / xch) * xch) {
          for (int t = lane / xch; t < L; t += 32 / xch) {
            const bool in = t < n;
            repro::cp_async_16(repro::smem_u32(xd + t * XS + xq * 8),
                               xb + static_cast<int64_t>(c0 + (in ? t : 0)) * sxt + xq * 8,
                               in ? 16 : 0);
          }
        }
        constexpr int kNch = N / 8;  // 16-byte chunks per B or C row (2, 4 or 8)
        const int nq = lane % kNch;
        for (int t = lane / kNch; t < L; t += 32 / kNch) {
          const bool in = t < n;
          const int64_t tt = c0 + (in ? t : 0);
          repro::cp_async_16(repro::smem_u32(bd + t * NS + nq * 8), bb + tt * sbt + nq * 8,
                             in ? 16 : 0);
          repro::cp_async_16(repro::smem_u32(cd + t * NS + nq * 8), cb + tt * sct + nq * 8,
                             in ? 16 : 0);
        }
      } else {
        const bf16 zero = __float2bfloat16(0.f);
        for (int t = 0; t < L; ++t) {
          const bool in = t < n;
          for (int q = lane; q < P; q += 32)
            xd[t * XS + q] = in ? xb[static_cast<int64_t>(c0 + t) * sxt + q] : zero;
          for (int q = lane; q < N; q += 32) {
            bd[t * NS + q] = in ? bb[static_cast<int64_t>(c0 + t) * sbt + q] : zero;
            cd[t * NS + q] = in ? cb[static_cast<int64_t>(c0 + t) * sct + q] : zero;
          }
        }
      }
      repro::cp_async_commit();
    };
    // decay and dt of chunk c, a chunk before they are used (decay 1 and
    // dt 0 past S)
    auto fetch = [&](int c) {
      Decays f;
#pragma unroll
      for (int r = 0; r < L / 32; ++r) {
        const int64_t tt = static_cast<int64_t>(c) * L + lane + 32 * r;
        const bool in = tt < S;
        f.dc[r] = in ? dc[vbase + tt * H] : 1.f;
        f.dt[r] = in ? dt[vbase + tt * H] : 0.f;
      }
      return f;
    };
    // D dt of chunk c by columns, a running product down each column s
    // (lane s + 32 r), decay_t taken from its lane by a shuffle; D0 and w
    // into buffer c & 1
    auto form = [&](int c, const Decays& f) {
      float d[L / 32];
#pragma unroll
      for (int r = 0; r < L / 32; ++r) d[r] = 1.f;
      float dd = 1.f;
      float* d0b = d0s + (c & 1) * L;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float a = __shfl_sync(0xffffffffu, f.dc[t / 32], t & 31);
        dd *= a;
#pragma unroll
        for (int r = 0; r < L / 32; ++r) {
          const int col = lane + 32 * r;
          if (t > col) d[r] *= a;
          wm[t * kWStride + col] = t >= col ? d[r] * f.dt[r] : 0.f;
        }
        if (lane == 0) d0b[t] = dd;
      }
#pragma unroll
      for (int r = 0; r < L / 32; ++r) wsv[(c & 1) * L + lane + 32 * r] = d[r] * f.dt[r];
    };

    stage(0);
    form(0, fetch(0));
    Decays next = fetch(nc > 1 ? 1 : 0);
    for (int c = 0; c < nc; ++c) {
      repro::cp_async_wait<0>();
      __syncthreads();  // (1) chunk c's x, B, C, D dt, D0 and w are in place
      if (c + 1 < nc) stage(c + 1);  // buffer (c + 1) & 1 was last read in chunk c - 1
      __syncthreads();  // (2) the consumers have formed M: D dt is free
      if (c + 1 < nc) {
        form(c + 1, next);
        if (c + 2 < nc) next = fetch(c + 2);
      }
    }
    return;
  }

  // ---- consumers: warp w owns state rows and y columns p0 .. p0 + 15
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const int p0 = warp * 16;

  // h rows p0 + g (+8), columns 8j + 2tig (+1): mma accumulators
  float hacc[kNT][4];
  {
    const float* s0w = s0 + (static_cast<int64_t>(bh) * P + p0) * N;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = 8 * j + 2 * tig;
      hacc[j][0] = s0w[g * N + n];
      hacc[j][1] = s0w[g * N + n + 1];
      hacc[j][2] = s0w[(g + 8) * N + n];
      hacc[j][3] = s0w[(g + 8) * N + n + 1];
    }
  }

  for (int c = 0; c < nc; ++c) {
    const int cur = c & 1;
    const int c0 = c * L;
    const int n = min(L, S - c0);
    const bf16* xst = xs + cur * L * XS;
    const bf16* bst = bs + cur * L * NS;
    const bf16* cst = cs + cur * L * NS;
    const float* d0c = d0s + cur * L;
    const float* wsc = wsv + cur * L;
    __syncthreads();  // (1) this chunk's inputs, D dt, D0 and w are in place

    // B1: y = D0[t] (C h^T) over all t, this warp's 16 columns p; h is the B
    // operand straight from its accumulators, as three bf16 terms
    float yacc[kT][2][4];
#pragma unroll
    for (int mt = 0; mt < kT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) yacc[mt][nt][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t hb[3][2][2];  // [term][p n-tile][b0, b1]
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t t0[3], t1[3];
        split3(hacc[2 * kk][2 * nt], hacc[2 * kk][2 * nt + 1], t0);
        split3(hacc[2 * kk + 1][2 * nt], hacc[2 * kk + 1][2 * nt + 1], t1);
#pragma unroll
        for (int k = 0; k < 3; ++k) hb[k][nt][0] = t0[k], hb[k][nt][1] = t1[k];
      }
#pragma unroll
      for (int mt = 0; mt < kT; ++mt) {
        uint32_t a[4];
        ldmatrix_x4(a, repro::smem_u32(cst + (mt * 16 + (lane & 15)) * NS + kk * 16 +
                                       (lane >> 4) * 8));
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma_bf16(yacc[mt][nt], a, hb[k][nt][0], hb[k][nt][1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kT; ++mt) {
      const float lo = d0c[mt * 16 + g];
      const float hi = d0c[mt * 16 + 8 + g];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        yacc[mt][nt][0] *= lo, yacc[mt][nt][1] *= lo;
        yacc[mt][nt][2] *= hi, yacc[mt][nt][3] *= hi;
      }
    }

    // B2: M in 16 x 16 blocks (i, j) at or below the diagonal, dealt out
    // to the warps in turn: G = C B^T, times D dt, stored as three bf16
    // terms
    for (int u = warp; u < kT * (kT + 1) / 2; u += nwarps) {
      int i = 0;  // u = i (i + 1) / 2 + j, j <= i
      while ((i + 1) * (i + 2) / 2 <= u) ++i;
      const int j = u - i * (i + 1) / 2;
      float gacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t a[4], bk[4];  // C rows of tile i; (b0, b1) of B rows 16j .. 16j + 15
        ldmatrix_x4(a, repro::smem_u32(cst + (i * 16 + (lane & 15)) * NS + kk * 16 +
                                       (lane >> 4) * 8));
        ldmatrix_x4(bk, repro::smem_u32(bst + (j * 16 + ((lane >> 4) << 3) + (lane & 7)) * NS +
                                        kk * 16 + (((lane >> 3) & 1) << 3)));
        mma_bf16(gacc[0], a, bk[0], bk[1]);
        mma_bf16(gacc[1], a, bk[2], bk[3]);
      }
      const int t_lo = i * 16 + g;
      const int t_hi = t_lo + 8;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int s = j * 16 + nt * 8 + 2 * tig;
        const float2 wl = *reinterpret_cast<const float2*>(wm + t_lo * kWStride + s);
        const float2 wh = *reinterpret_cast<const float2*>(wm + t_hi * kWStride + s);
        uint32_t lo[3], hi[3];
        split3(gacc[nt][0] * wl.x, gacc[nt][1] * wl.y, lo);
        split3(gacc[nt][2] * wh.x, gacc[nt][3] * wh.y, hi);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          *reinterpret_cast<uint32_t*>(mrow(t_lo, k) + s) = lo[k];
          *reinterpret_cast<uint32_t*>(mrow(t_hi, k) + s) = hi[k];
        }
      }
    }
    __syncthreads();  // (2) M is in place

    // C1: y += M X over s <= t (k-steps at or below the diagonal), then out
    {
      uint32_t bx[kT][4];  // (b0, b1) of p n-tiles 0 and 1, per k-step of s
#pragma unroll
      for (int kk = 0; kk < kT; ++kk)
        ldmatrix_x4_trans(bx[kk], repro::smem_u32(xst + (kk * 16 + (((lane >> 3) & 1) << 3) +
                                                         (lane & 7)) * XS +
                                                  p0 + ((lane >> 4) << 3)));
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
#pragma unroll
        for (int kk = 0; kk < kT; ++kk) {
          if (kk > mt) continue;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            uint32_t a[4];
            ldmatrix_x4(a, repro::smem_u32(mrow(mt * 16 + (lane & 15), k) + kk * 16 +
                                           (lane >> 4) * 8));
            mma_bf16(yacc[mt][0], a, bx[kk][0], bx[kk][1]);
            mma_bf16(yacc[mt][1], a, bx[kk][2], bx[kk][3]);
          }
        }
#pragma unroll
      for (int mt = 0; mt < kT; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int t = mt * 16 + g + 8 * hf;
          if (t >= n) continue;
          float* yr = y + ((static_cast<int64_t>(b) * S + c0 + t) * H + h) * P + p0 + 2 * tig;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            *reinterpret_cast<float2*>(yr + 8 * nt) =
                make_float2(yacc[mt][nt][2 * hf], yacc[mt][nt][2 * hf + 1]);
        }
    }

    // C2: h <- D0[L-1] h + (X * w)^T B; X^T comes from ldmatrix.trans, is
    // widened, scaled by w and split into three bf16 terms in registers
    {
      const float dl = d0c[L - 1];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) hacc[j][r] *= dl;
#pragma unroll
      for (int kk = 0; kk < kT; ++kk) {
        uint32_t ax[4];  // rows p0 + g (+8), columns s = 16kk + 2tig (+1, +8, +9)
        ldmatrix_x4_trans(ax, repro::smem_u32(xst + (kk * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                                                        XS +
                                              p0 + (((lane >> 3) & 1) << 3)));
        const float2 wl = *reinterpret_cast<const float2*>(wsc + kk * 16 + 2 * tig);
        const float2 wh = *reinterpret_cast<const float2*>(wsc + kk * 16 + 8 + 2 * tig);
        uint32_t as[3][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 xv = unpack_bf16(ax[r]);
          const float2 wv = r < 2 ? wl : wh;
          uint32_t t3[3];
          split3(xv.x * wv.x, xv.y * wv.y, t3);
#pragma unroll
          for (int k = 0; k < 3; ++k) as[k][r] = t3[k];
        }
#pragma unroll
        for (int j = 0; j < kNT; j += 2) {
          uint32_t bv[4];  // (b0, b1) of n-tiles j and j + 1
          ldmatrix_x4_trans(bv, repro::smem_u32(bst + (kk * 16 + (((lane >> 3) & 1) << 3) +
                                                        (lane & 7)) * NS +
                                                j * 8 + ((lane >> 4) << 3)));
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            mma_bf16(hacc[j], as[k], bv[0], bv[1]);
            mma_bf16(hacc[j + 1], as[k], bv[2], bv[3]);
          }
        }
      }
    }
  }

  float* sTw = sT + (static_cast<int64_t>(bh) * P + p0) * N;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int n = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(sTw + g * N + n) = make_float2(hacc[j][0], hacc[j][1]);
    *reinterpret_cast<float2*>(sTw + (g + 8) * N + n) = make_float2(hacc[j][2], hacc[j][3]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *x, *bm, *cm, *dc, *dt, *s0;
  void *y, *sT;
  int B, H, S, P, N;
  int64_t sxb, sxt, sbb, sbt, scb, sct;
  int device;
  cudaStream_t stream;
};

template <typename T, int N>
cudaError_t launch_sequential(const Args& a) {
  ssd_sequential_kernel<T, N><<<a.B * a.H, a.P, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.bm), static_cast<const T*>(a.cm),
      static_cast<const float*>(a.dc), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.s0), static_cast<float*>(a.y), static_cast<float*>(a.sT),
      a.H, a.S, a.sxb, a.sxt, a.sbb, a.sbt, a.scb, a.sct);
  return cudaGetLastError();
}

template <typename T, int N>
cudaError_t launch_decode(const Args& a) {
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.P;
  const int64_t threads = rows * (N / 4);
  const int64_t blocks = (threads + kDecodeThreads - 1) / kDecodeThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_decode_kernel<T, N><<<static_cast<unsigned>(blocks), kDecodeThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.bm), static_cast<const T*>(a.cm),
      static_cast<const float*>(a.dc), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.s0), static_cast<float*>(a.y), static_cast<float*>(a.sT),
      a.H, a.P, rows, a.sxb, a.sbb, a.scb);
  return cudaGetLastError();
}

template <int N, bool kWide>
cudaError_t launch_chunked_as(const Args& a, int vec) {
  // dynamic shared memory above 48 KB needs the attribute: set once per
  // device, for the largest P of this instantiation
  static uint64_t configured = 0;
  if (a.device < 0 || a.device >= 64) return cudaErrorInvalidDevice;
  if (!((configured >> a.device) & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_chunked_kernel<N, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        chunk_smem_bytes(kWide ? kMaxP : 64, N));
    if (err != cudaSuccess) return err;
    configured |= uint64_t{1} << a.device;
  }
  ssd_chunked_kernel<N, kWide><<<a.B * a.H, 2 * a.P + 32, chunk_smem_bytes(a.P, N),
                                 a.stream>>>(
      static_cast<const bf16*>(a.x), static_cast<const bf16*>(a.bm),
      static_cast<const bf16*>(a.cm), static_cast<const float*>(a.dc),
      static_cast<const float*>(a.dt), static_cast<const float*>(a.s0),
      static_cast<float*>(a.y), static_cast<float*>(a.sT), a.H, a.S, a.P, a.sxb, a.sxt, a.sbb,
      a.sbt, a.scb, a.sct, vec);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_chunked(const Args& a) {
  // 16-byte copies need every row of x, B and C to start on 16 bytes
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.bm) |
                         reinterpret_cast<uintptr_t>(a.cm);
  const int64_t strides = a.sxb | a.sxt | a.sbb | a.sbt | a.scb | a.sct;
  const int vec = (ptrs & 15) == 0 && (strides & 7) == 0;
  return a.P > 64 ? launch_chunked_as<N, true>(a, vec) : launch_chunked_as<N, false>(a, vec);
}

template <typename T, int N>
cudaError_t launch(const Args& a, int dtype) {
  switch (route(a.S, a.P, a.N, dtype)) {
    case kDecode:
      return launch_decode<T, N>(a);
    case kChunked:
      if constexpr (N % 16 == 0) return launch_chunked<N>(a);
      return cudaErrorInvalidValue;  // route() never sends N 8 here
    default:
      return launch_sequential<T, N>(a);
  }
}

template <typename T>
cudaError_t dispatch_n(const Args& a, int dtype) {
  switch (a.N) {
    case 8:
      return launch<T, 8>(a, dtype);
    case 16:
      return launch<T, 16>(a, dtype);
    case 32:
      return launch<T, 32>(a, dtype);
    case 64:
      return launch<T, 64>(a, dtype);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The kernel a call with these sizes takes: 0 sequential, 1 decode, 2
// chunked (the rule in the note above).
extern "C" int repro_mamba2_ssd_route(int S, int P, int N, int dtype) {
  return route(S, P, N, dtype);
}

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
  const Args a{x, bm, cm, dc, dt, s0, y, sT, B, H, S, P, N,
               sxb, sxt, sbb, sbt, scb, sct, device, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case repro::kFloat32:
      return dispatch_n<float>(a, dtype);
    case repro::kBFloat16:
      return dispatch_n<bf16>(a, dtype);
    default:
      return cudaErrorInvalidValue;
  }
}
