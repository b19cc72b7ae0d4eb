// Flash-attention forward: blocked online-softmax attention of q (B,H,S,hd)
// against k, v (B,Hkv,T,hd), causal or full, with grouped-query heads.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_pallas
// (_flash_kernel).  What it keeps from the Pallas kernel: the running max,
// denominator and accumulator in f32, the GQA map (b//H)*Hkv + (b%H)//rep
// (here: query head h reads kv head h / rep of the same batch row), kv
// tiles above the causal diagonal skipped, and fully masked rows written
// as 0.  What differs: the TPU walks the kv axis as a sequential grid
// dimension with scratch carried across steps; here one block owns a
// 64-row query tile and loops over kv tiles itself, and the ragged key
// tail is masked with kpos < T in place of padding.  Causal masking aligns
// query row i with key i, so causal calls need S == T (the wrapper
// enforces it; the reference oracle's (T - S) offset is never needed on
// the serving path).
//
// Bound on the H100: at the serving shapes (hd 64 for granite, 80 for
// zamba2's shared block, 96 for phi-3-vision, S = T <= 1024) bytes: q, k, v
// and o once each over 3.35 TB/s take 6 to 15 us at (4, 32, 512, hd), the
// causal QK^T and PV products 4 to 7 us at 989 TFLOP/s.  Both are small,
// so what decides the time is how well the tensor cores are fed and how
// much latency is hidden.  hubert's encoder (non-causal, H 16, hd 80, S =
// T = 1024 at B 4) is the one shape where the products lead: 21.5 GFLOP,
// 22 us, against 13 us of bytes.
//
// The dtype chooses the kernel; nothing falls back on a failure.
//
// bf16 (flash_fwd_mma): FlashAttention-2 on warp-level tensor cores.  A
// block of 4 warps owns 64 query rows, 16 per warp.  Each warp loads its
// q fragment once with ldmatrix and keeps it in registers (hd/16 k-steps).
// K and V tiles of 64 keys x hd stay bf16 in shared memory, double-
// buffered with 16-byte cp.async copies so the next tile's load overlaps
// this tile's math; rows are padded by 16 bytes, which puts the 8 rows of
// every ldmatrix on distinct banks at each hd (a row is an odd number of
// 16-byte chunks: 208 B, 13 chunks, at hd 96).  hd 96 takes 66,560 B of
// shared memory a block, above the 48 KB default (launch_mma sets the
// attribute), and two blocks an SM take 133 KB of the 227 KB.  S = QK^T
// and O += PV run as mma.sync m16n8k16 bf16 products with f32
// accumulators; the f32 scores are multiplied by scale*log2(e) (never
// folded into the bf16 q, which would add a rounding the plain version
// does not make) and exponentiated with exp2f.  Each thread holds two rows of the score
// fragment: their max is taken over the quad with two shuffles per tile,
// their sums once at the end.  The score accumulator's layout is the A
// layout of the next product, so P goes to bf16 in registers (the plain
// version also rounds the probabilities to v's dtype) and never touches
// shared memory; V is read with ldmatrix.trans.  Tiles wholly above the
// causal diagonal are never loaded; only the diagonal tile and the ragged
// key tail are masked element by element, and rows past S or keys past T
// are zero-filled by cp.async.  The output is staged through the warp's
// own rows of the q tile and written as 16-byte stores.  Loads need 16-
// byte-aligned q, k and v (the wrapper checks).  The heaviest causal tiles
// are scheduled first.
//
// f32 (flash_fwd_simt): the first design, kept for f32 inputs.  TF32
// tensor cores keep about three decimal digits, which would miss the f32
// tolerances the kernel is held to.  One thread owns one query row, keeps
// q and the accumulator in registers, and runs the dot products and the
// P.V update as f32 FMAs on the CUDA cores, reading each key and value of
// the shared-memory tile as a broadcast.
#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 64;           // keys per shared-memory tile

using bf16 = __nv_bfloat16;

template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;  // elements per smem row: +16 B
  static constexpr int kElems = 64 * kStride;
  // q (later o) tile, then K and V, two buffers each
  static constexpr int kSmemBytes = 5 * kElems * static_cast<int>(sizeof(bf16));
  static constexpr int kChunksPerRow = HD / 8;  // 16-byte chunks
};

using repro::cp_async_16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mma_bf16;
using repro::pack_bf16;
using repro::smem_u32;

// Rows [row0, row0 + 64) of a (rows, HD) bf16 matrix into a padded smem
// tile; rows at or past `valid` are zero-filled and not read.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ src,
                                          int row0, int valid, int tid) {
  using TL = Tile<HD>;
  constexpr int kChunks = 64 * TL::kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "tile chunks must split evenly over the block");
#pragma unroll
  for (int it = 0; it < kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / TL::kChunksPerRow;
    const int c = i - r * TL::kChunksPerRow;
    const bool in = row0 + r < valid;
    const bf16* g = src + static_cast<int64_t>(in ? row0 + r : 0) * HD + c * 8;
    cp_async_16(smem_u32(tile + r * TL::kStride + c * 8), g, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o, int H, int Hkv, int S,
              int Tk, float scale_log2, int causal) {
  using TL = Tile<HD>;
  constexpr int kSteps = HD / 16;  // k-steps of QK^T
  constexpr int kDTiles = HD / 8;  // n-tiles of PV
  static_assert(HD % 16 == 0, "hd must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + TL::kElems;      // two buffers
  bf16* vs = ks + 2 * TL::kElems;  // two buffers

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockM;  // heaviest tiles first
  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int kvh = b * Hkv + (bh - b * H) / (H / Hkv);
  const bf16* qb = q + static_cast<int64_t>(bh) * S * HD;
  const bf16* kb = k + static_cast<int64_t>(kvh) * Tk * HD;
  const bf16* vb = v + static_cast<int64_t>(kvh) * Tk * HD;

  // causal (S == T): the tile's last query row attends keys [0, q0 + kBlockM)
  const int kv_end = causal ? min(Tk, q0 + kBlockM) : Tk;
  const int n_tiles = (kv_end + kBlockN - 1) / kBlockN;

  load_tile<HD>(qs, qb, q0, S, tid);
  if (n_tiles > 0) {
    load_tile<HD>(ks, kb, 0, Tk, tid);
    load_tile<HD>(vs, vb, 0, Tk, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 q rows as A fragments, one per k-step of 16 columns
  uint32_t qf[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(qs + (warp * 16 + (lane & 15)) * TL::kStride + kk * 16 +
                                 (lane >> 4) * 8));

  float acc[kDTiles][4];
#pragma unroll
  for (int d = 0; d < kDTiles; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this thread's share of the row sums
  const int row_g = q0 + warp * 16 + g;

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    if (j + 1 < n_tiles) {  // next tile into the other buffer, under this tile's math
      load_tile<HD>(ks + (cur ^ 1) * TL::kElems, kb, (j + 1) * kBlockN, Tk, tid);
      load_tile<HD>(vs + (cur ^ 1) * TL::kElems, vb, (j + 1) * kBlockN, Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + cur * TL::kElems;
    const bf16* vt = vs + cur * TL::kElems;
    const int kv0 = j * kBlockN;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bk[4];  // (b0, b1) of n-tiles nt and nt + 1
        ldmatrix_x4(bk, smem_u32(kt + (nt * 8 + ((lane >> 4) << 3) + (lane & 7)) * TL::kStride +
                                 kk * 16 + (((lane >> 3) & 1) << 3)));
        mma_bf16(s[nt], qf[kk], bk[0], bk[1]);
        mma_bf16(s[nt + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // element (nt, c): row row_g + 8 (c >> 1), key kv0 + 8 nt + 2 tig + (c & 1)
    const bool edge = kv0 + kBlockN > Tk || (causal && kv0 + kBlockN - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[nt][c] * scale_log2;
        if (edge) {
          const int key = kv0 + nt * 8 + 2 * tig + (c & 1);
          const int row = row_g + 8 * (c >> 1);
          if (key >= Tk || (causal && key > row)) x = -INFINITY;
        }
        s[nt][c] = x;
      }

    // online softmax over the two rows; a row's max over its quad
    float m_use[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m_run[hh];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hh], s[nt][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      m_use[hh] = mx == -INFINITY ? 0.f : mx;  // a row with no key yet stays at 0
      const float alpha = exp2f(m_run[hh] - m_use[hh]);  // 0 on the row's first tile
      m_run[hh] = mx;
      l_run[hh] *= alpha;
#pragma unroll
      for (int d = 0; d < kDTiles; ++d) {
        acc[d][2 * hh] *= alpha;
        acc[d][2 * hh + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = exp2f(s[nt][c] - m_use[c >> 1]);
        l_run[c >> 1] += s[nt][c];
      }

    // O += P V: the score C fragments of n-tiles 2t, 2t + 1 are the A
    // fragment of k-step t (16 keys)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * t][0], s[2 * t][1]), pack_bf16(s[2 * t][2], s[2 * t][3]),
          pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
          pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int d = 0; d < kDTiles; d += 2) {
        uint32_t bv[4];  // (b0, b1) of hd n-tiles d and d + 1
        ldmatrix_x4_trans(bv, smem_u32(vt + (t * 16 + (((lane >> 3) & 1) << 3) + (lane & 7)) *
                                                TL::kStride +
                                       d * 8 + ((lane >> 4) << 3)));
        mma_bf16(acc[d], pa, bv[0], bv[1]);
        mma_bf16(acc[d + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  // row sums over the quad; fully masked rows -> 0
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_run[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hh] = l > 0.f ? 1.f / l : 0.f;
  }

  // stage the warp's 16 output rows in its own rows of the q tile, then
  // write them as 16-byte chunks
  bf16* os = qs + warp * 16 * TL::kStride;
#pragma unroll
  for (int d = 0; d < kDTiles; ++d) {
    *reinterpret_cast<uint32_t*>(os + g * TL::kStride + d * 8 + 2 * tig) =
        pack_bf16(acc[d][0] * inv[0], acc[d][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * TL::kStride + d * 8 + 2 * tig) =
        pack_bf16(acc[d][2] * inv[1], acc[d][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kOutChunks = 16 * TL::kChunksPerRow;
  static_assert(kOutChunks % 32 == 0, "output chunks must split evenly over the warp");
#pragma unroll
  for (int it = 0; it < kOutChunks / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / TL::kChunksPerRow;
    const int c = i - r * TL::kChunksPerRow;
    const int row = q0 + warp * 16 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(o + (static_cast<int64_t>(bh) * S + row) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * TL::kStride + c * 8);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int Hkv, int S, int Tk, float scale, int causal, int device,
                       cudaStream_t stream) {
  // dynamic shared memory above 48 KB (hd 80: 55 KB, hd 96: 65 KB, hd 128:
  // 85 KB) needs the attribute, set once per device
  static uint64_t configured = 0;
  constexpr int kSmem = Tile<HD>::kSmemBytes;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!((configured >> device) & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    configured |= uint64_t{1} << device;
  }
  const dim3 grid((S + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_mma<HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, Hkv, S, Tk, scale * kLog2e, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSimtRows = 64;  // query rows per block, one thread each
constexpr int kSimtKeys = 32;  // keys per shared-memory tile

template <int HD>
__global__ void __launch_bounds__(kSimtRows)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int H, int Hkv, int S,
               int Tk, float scale_log2, int causal) {
  __shared__ float ks[kSimtKeys][HD];
  __shared__ float vs[kSimtKeys][HD];

  const int bh = blockIdx.y;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * kSimtRows;
  const int row = q0 + threadIdx.x;
  const bool live_row = row < S;

  const float* kbase = k + static_cast<int64_t>(kvh) * Tk * HD;
  const float* vbase = v + static_cast<int64_t>(kvh) * Tk * HD;

  // q pre-scaled by scale * log2(e): scores live in the log2 domain, so
  // exp2f gives exp(score - max) exactly as the oracle's softmax.
  float qr[HD];
  float acc[HD];
  if (live_row) {
    const float* qrow = q + (static_cast<int64_t>(bh) * S + row) * HD;
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = qrow[c] * scale_log2;
  } else {
#pragma unroll
    for (int c = 0; c < HD; ++c) qr[c] = 0.f;
  }
#pragma unroll
  for (int c = 0; c < HD; ++c) acc[c] = 0.f;
  float m = -INFINITY;
  float l = 0.f;

  // causal (S == T): the tile's last query row attends keys [0, q0 + kSimtRows)
  const int kv_end = causal ? min(Tk, q0 + kSimtRows) : Tk;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kSimtKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kSimtKeys * HD; i += kSimtRows) {
      const int r = i / HD;
      const int c = i - r * HD;
      const int kpos = kv0 + r;
      const bool in_range = kpos < Tk;
      ks[r][c] = in_range ? kbase[static_cast<int64_t>(kpos) * HD + c] : 0.f;
      vs[r][c] = in_range ? vbase[static_cast<int64_t>(kpos) * HD + c] : 0.f;
    }
    __syncthreads();

    // keys of this tile the row may see: kpos < T, and kpos <= row if causal
    int n = min(kSimtKeys, Tk - kv0);
    if (causal) n = min(n, row - kv0 + 1);
    if (!live_row || n <= 0) continue;

    float s[kSimtKeys];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSimtKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dot = fmaf(qr[c], ks[j][c], dot);
      s[j] = j < n ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);  // finite: n >= 1
    const float alpha = exp2f(m - m_new);     // 0 on the row's first tile
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kSimtKeys; ++j) {
      s[j] = exp2f(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < HD; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int j = 0; j < kSimtKeys; ++j) a = fmaf(s[j], vs[j][c], a);
      acc[c] = a;
    }
    m = m_new;
  }

  if (live_row) {
    float* orow = o + (static_cast<int64_t>(bh) * S + row) * HD;
    const float inv = l > 0.f ? 1.f / l : 0.f;  // fully masked rows -> 0
#pragma unroll
    for (int c = 0; c < HD; ++c) orow[c] = acc[c] * inv;
  }
}

template <int HD>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int Hkv, int S, int Tk, float scale, int causal,
                        cudaStream_t stream) {
  const dim3 grid((S + kSimtRows - 1) / kSimtRows, B * H);
  flash_fwd_simt<HD><<<grid, kSimtRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, S, Tk, scale * kLog2e,
      causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int S, int Tk, float scale, int causal, int dtype, int device,
                   cudaStream_t stream) {
  switch (dtype) {
    case repro::kFloat32:
      return launch_simt<HD>(q, k, v, o, B, H, Hkv, S, Tk, scale, causal, stream);
    case repro::kBFloat16:
      return launch_mma<HD>(q, k, v, o, B, H, Hkv, S, Tk, scale, causal, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, H, S, hd); k, v: (B, Hkv, T, hd); all contiguous, H % Hkv == 0,
// hd in {16, 32, 64, 80, 96, 128}, causal only with S == T; bf16 q, k, v
// 16-byte aligned.  dtype: repro::DType.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     int B, int H, int Hkv, int S, int T, int hd, float scale,
                                     int causal, int dtype, int device, void* stream) {
  cudaError_t err = repro::use_device(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, B, H, Hkv, S, T, scale, causal, dtype, device, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, Hkv, S, T, scale, causal, dtype, device, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, Hkv, S, T, scale, causal, dtype, device, s);
    case 80:  // zamba2's shared attention block, hubert-xlarge
      return launch<80>(q, k, v, o, B, H, Hkv, S, T, scale, causal, dtype, device, s);
    case 96:  // phi-3-vision-4.2b
      return launch<96>(q, k, v, o, B, H, Hkv, S, T, scale, causal, dtype, device, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, Hkv, S, T, scale, causal, dtype, device, s);
    default:
      return cudaErrorInvalidValue;
  }
}
