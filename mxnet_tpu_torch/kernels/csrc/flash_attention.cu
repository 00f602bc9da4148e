// Flash attention forward for Hopper (sm_90a), fp32 or bf16, over
// contiguous [B, H, L, D] tensors: causal or not, and offset-causal.
//
// Replaces two TPU kernels of mxnet_tpu/pallas_ops/flash_attention.py:
//  * _fa_kernel (the forward of flash_attention; its backward is XLA
//    code there and plain PyTorch in the port).  Query row i attends to
//    key j when the mask allows it (causal: i >= j, top-left aligned as
//    in the TPU kernel);
//  * _fa_offset_kernel (flash_attention_offset, the contiguous serving
//    plane's decode attention).  Query row r of sequence b = bh / H sits
//    at position offsets[b] + r of a [B, H, Lk, D] cache and attends to
//    key positions up to and including its own.
// Every body keeps the TPU kernels' semantics: s = (q . k) * scale, the
// scale after the product; masked scores are -1e30 and masked p is
// forced to 0; the online-softmax recurrence and both products'
// accumulation run in fp32; the output is acc / (l > 0 ? l : 1), written
// in the input dtype (bf16: rounded to nearest even), as the TPU kernels
// upcast their tiles to fp32 and cast the output back.  `offsets` null
// with `causal` is the causal case (every offset 0); `causal` 0 and no
// offsets is unmasked.  Keys past the last query position a CTA (decode:
// its row) can see are never read: the dynamic block skip of the offset
// kernel, at key granularity.  Every body sums in a fixed order with no
// atomics and no split of the keys over CTAs: a launch gives the same
// bits every time.
//
// Three bodies behind each entry point, and a fourth (wgmma) behind bf16
// flash_attention; kernels/flash_attention.py::_plan picks the body
// (path) and the query rows a CTA (block_q) from the shape, and the entry
// point refuses a pair the shape does not allow.
//
// * wgmma (path 3: bf16 flash_attention, Lq above the decode body's
//   threshold, D <= 128; the contiguous plane's bf16 prefill and the bf16
//   training forward), Hopper's warpgroup MMA.  At B16 H8 L512 D64 causal
//   the work is 1.1 GFLOP against 16.8 MB of bf16 q/k/v/out: the bytes
//   bound it, yet at these sizes each CTA's chain of tiles, not the card's
//   rates, sets the time (PERF.md §6 row 6b).
//   - A CTA is one producer warp and one consumer warpgroup of 64 query
//     rows (wgmma's M), three CTAs an SM at D 64; grid (B*H, q-tiles),
//     the last q-tiles first in causal mode.  Two warpgroups of 64 rows
//     sharing each stage were as fast or slower at every path shape.
//   - Loads by TMA, issued by one thread of the producer warp: Q once,
//     then K and V a 64-key stage at a time into a
//     ring of 4 stages (3 at D > 64), 128-byte swizzled boxes of 64 rows x
//     64 columns (one 128-byte bf16 row at D 64); K full, V full and
//     empty mbarriers a stage.  TMA zero-fills rows past Lq and Lk and
//     columns past D (D padded to 64 or 128); tiles wholly above the
//     diagonal are never loaded.  The three tensor maps are encoded per
//     launch through the driver's cuTensorMapEncodeTiled (reached with
//     cudaGetDriverEntryPoint: the library links no libcuda) and passed
//     as __grid_constant__ parameters.
//   - S = Q K^T: wgmma m64n64k16 from shared memory, K K-major; P V:
//     wgmma with P from registers (S's C layout is the A fragment as it
//     stands) and V MN-major from shared memory (the transpose bit), so no
//     ldmatrix and no second copy of V.  P in two bf16 terms (hi =
//     bf16(p), lo = bf16(p - hi)), two wgmmas a k-step into one fp32
//     accumulator, as the mma.sync tile has it: P rounded once errs more
//     (tests/test_torch_fa_wgmma_plan.py records both).
//   - The online softmax runs on the accumulator fragments in registers
//     (a row's max over the 4 lanes that hold it), the scale folded into
//     one FMA before ex2; the mask costs two instructions a score and no
//     branch.  S of tile t+1 is issued before P V of tile t, and tile
//     t+1's softmax overlaps that P V; the loop is peeled so that no
//     branch lies inside a window where a wgmma is in flight (a branch
//     there makes ptxas serialize every wgmma).
//   - Epilogue: O / l in fp32, rounded once to bf16, stored from
//     registers (rows past Lq and columns past D are not stored).
// * tile (path 2: Lq above the decode body's threshold, D <= 128; the
//   fp32 prefill's causal attention and training forward, and the offset
//   kernel in both dtypes; bf16 flash_attention takes wgmma instead),
//   tensor cores (mma.sync).  At the training shape (B16 H8 L256 D64, causal) the work
//   is about 1.07 GFLOP against 33.5 MB of fp32 q/k/v/out: the bytes bound
//   it at the tensor-core rates.
//   - A CTA is 4 warps and 64 query rows, 16 a warp (the mma's M); the
//     grid is (B*H, ceil(Lq/64)), and in masked mode the last q tiles,
//     which see the most keys, launch first, so the causal tail does not
//     become one long last wave.
//   - 64-key K/V tiles (32 for D > 64) stream through shared memory by
//     16-byte cp.async (4 fp32 or 8 bf16 elements a copy),
//     double-buffered; rows are D zero-padded to DP (16, 32, 64 or 128)
//     plus 16 bytes, which makes the fragment reads free of bank
//     conflicts; keys past the end are zero-filled.
//   - The mask runs only on tiles that cross the (offset) diagonal or the
//     end of the keys, tiles wholly above the diagonal are never read, and
//     a warp skips the 8-key blocks above its own rows.
//   - Online softmax in registers: a row's max reduces over the 4 lanes
//     that hold it in the C layout (shuffles xor 1 and 2); each lane keeps
//     a partial l, rescaled by the row's alpha, and the 4 partials are
//     added once at the end.  Each tile's P.V accumulates in fresh
//     registers and joins the output as acc * alpha + pv on the CUDA cores
//     (the TPU kernel's association).
//   - fp32: one TF32 pass keeps 10 mantissa bits and misses the 1e-4
//     tolerance tenfold, so both products run in "3xTF32": x = hi + lo
//     with hi = tf32(x) and lo = x - hi (split_tf32), a . b ~ lo.hi +
//     hi.lo + hi.hi, three mma.sync.m16n8k8 a k-step into one fp32
//     accumulator.  Each warp splits its Q rows once and keeps them in
//     registers (D > 64: in shared memory, each lane's own).  P.V takes P
//     from S's C fragments: lane t holds keys 2t and 2t+1 of each 8-key
//     block, used as the mma's k = t and k = t + 4, and V's B fragment is
//     read with the same relabeling (only the order of additions
//     changes).
//   - bf16: Q K^T is one m16n8k16 bf16 mma a k-step (products of bf16
//     values are exact in the fp32 accumulator, as the TPU kernel's
//     upcast is), with Q's A fragments read from device memory once.  P.V
//     takes P from S's C fragments as they stand (blocks 2jj and 2jj+1 are
//     the A fragment of 16 keys), split in two bf16 terms (hi = bf16(p),
//     lo = bf16(p - hi), split_bf16x2): P rounded once to bf16 errs half
//     of a one-ulp bound.  V's B fragments come from ldmatrix.trans.
// * decode (path 1: Lq up to the decode threshold, D <= 128; the
//   contiguous plane's decode step, Lq 1), CUDA cores.  Bound: bytes
//   (each key row feeds 4*D flops).  An m16 tile would waste 15 of its 16
//   rows, so one CTA of 4 warps runs one query row, and Lq CTAs read a
//   sequence's keys.  A stage is 64 keys (fp32) or 128 (bf16: the same
//   32 KB at D 64), two stages in flight by 16-byte cp.async, and each
//   warp takes its own quarter of every stage, 16 keys at a time, with
//   its own online softmax (m, l, acc): no traffic between warps but the
//   staging barrier, and no warp idle.  In a 16-key step lane k and lane
//   k + 16 each dot half of key k's row with the query (bf16 widened
//   exactly to fp32), joined by one shuffle; for P.V the lanes split into
//   key groups x 4-column groups (D 64: 2 x 16).  The 4 warps' partials
//   merge in warp order at the end.  The CTA of the longest sequence
//   sets the time: it walks its stages one after another.  This is the
//   paged plane's decode body (paged_attention.cu) without the block
//   table: the cache rows of a (sequence, head) are contiguous.
// * v1 (path 0: every D up to 256, the only body for D in (128, 256],
//   which no path of the port runs, and on request for timing), CUDA
//   cores: one CTA of 4 warps per (32 query rows, b*h), warp w owning
//   rows w, w+4, ..., w+28; 32-key tiles staged by 16-byte cp.async,
//   double-buffered; lane k computes query-row . key-k, and P.V runs one
//   key at a time through shuffles, D/32 output columns a lane.
// Requires a 16-byte row: D % 4 == 0 (fp32) or D % 8 == 0 (bf16), and
// D <= 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the entry points' path argument (kernels/flash_attention.py _PATH)
constexpr int kPathV1 = 0;
constexpr int kPathDecode = 1;
constexpr int kPathTile = 2;
constexpr int kPathWgmma = 3;

// ---------------------------------------------------------------------------
// v1: CUDA cores, one key a lane
// ---------------------------------------------------------------------------
constexpr int kKeyTile = 32;        // keys per shared-memory tile
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kRowsPerWarp * kWarps;
constexpr int kKPadBytes = 16;      // K row stride D * sizeof(E) + 16 bytes

// E: q/k/v/out element, float or __nv_bfloat16.  DPL: head-dim elements
// each lane accumulates (D <= 32 * DPL).
template <typename E, int DPL>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const int* __restrict__ offsets,
    E* __restrict__ out, int H, int Lq, int Lk, int D, int causal,
    float scale) {
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(E);    // elements per 16-byte copy
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, Lq - q0);
  const int DV = D / kVec;                // 16-byte chunks per row
  const int ks_stride = D + kKPadBytes / static_cast<int>(sizeof(E));

  // shared memory: Q [kBlockQ][D] fp32, then two stages of
  // K [kKeyTile][D + pad] followed by V [kKeyTile][D], in E
  float* qs = smem;
  E* stages = reinterpret_cast<E*>(qs + kBlockQ * D);
  const int stage = kKeyTile * (ks_stride + D);

  // global position of query row 0: offsets[b] in offset mode (which
  // is causal), 0 otherwise
  const int ofs = offsets != nullptr ? offsets[bh / H] : 0;
  const bool masked = causal || offsets != nullptr;
  const int n_keys = masked ? min(ofs + q0 + nq, Lk) : Lk;
  const int n_tiles = n_keys > 0 ? (n_keys + kKeyTile - 1) / kKeyTile : 0;
  const E* kh = k + bh * Lk * D;
  const E* vh = v + bh * Lk * D;

  // stage tile t's K and V rows: kKeyTile keys x DV 16-byte chunks each
  auto issue = [&](int t, int buf) {
    const int base = t * kKeyTile;
    const int nk = min(kKeyTile, n_keys - base);
    E* ks = stages + buf * stage;
    for (int i = threadIdx.x; i < nk * DV; i += kThreads) {
      const int kk = i / DV;
      const int c = i - kk * DV;
      const size_t row = static_cast<size_t>(base + kk);
      cp_async16(ks + kk * ks_stride + kVec * c, kh + row * D + kVec * c);
      cp_async16(ks + kKeyTile * ks_stride + kk * D + kVec * c,
                 vh + row * D + kVec * c);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0, 0);
  const E* qg = q + (bh * Lq + q0) * D;
  for (int i = threadIdx.x; i < nq * D; i += kThreads) qs[i] = widen(qg[i]);

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[rr][e] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      issue(t + 1, buf ^ 1);
      cp_async_wait<1>();    // tile t has landed, tile t+1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();         // tile t (and Q) visible to every warp
    const int nk = min(kKeyTile, n_keys - t * kKeyTile);
    const int kpos = t * kKeyTile + lane;     // this lane's key position
    const E* ks = stages + buf * stage;
    const E* vs = ks + kKeyTile * ks_stride;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r < nq) {                          // uniform across the warp
        const int qpos = ofs + q0 + r;
        const bool vis = lane < nk && (!masked || qpos >= kpos);
        float s = kNeg;
        if (lane < nk) {
          const float4* q4 = reinterpret_cast<const float4*>(qs + r * D);
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          if constexpr (kBf16) {
            // 8 values a chunk, two q float4s
            const uint4* k16 =
                reinterpret_cast<const uint4*>(ks + lane * ks_stride);
            for (int j = 0; j < DV; ++j) {
              const uint4 w = k16[j];
              const float4 a = q4[2 * j];
              const float4 c = q4[2 * j + 1];
              d0 += a.x * bf16_at(w.x, 0);
              d1 += a.y * bf16_at(w.x, 1);
              d2 += a.z * bf16_at(w.y, 0);
              d3 += a.w * bf16_at(w.y, 1);
              d0 += c.x * bf16_at(w.z, 0);
              d1 += c.y * bf16_at(w.z, 1);
              d2 += c.z * bf16_at(w.w, 0);
              d3 += c.w * bf16_at(w.w, 1);
            }
          } else {
            const float4* k4 =
                reinterpret_cast<const float4*>(ks + lane * ks_stride);
            for (int j = 0; j < DV; ++j) {
              const float4 a = q4[j];
              const float4 c = k4[j];
              d0 += a.x * c.x;
              d1 += a.y * c.y;
              d2 += a.z * c.z;
              d3 += a.w * c.w;
            }
          }
          if (vis) s = ((d0 + d1) + (d2 + d3)) * scale;
        }
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float p = vis ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[rr] - m_new);
        l[rr] = l[rr] * alpha + warp_sum(p);
        m[rr] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[rr][e] *= alpha;
        for (int kk = 0; kk < nk; ++kk) {
          const float pk = __shfl_sync(kFull, p, kk);
          const E* vr = vs + kk * D;
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            if (d < D) acc[rr][e] += pk * widen(vr[d]);
          }
        }
      }
    }
    __syncthreads();         // buffer `buf` free for tile t+2's copies
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < nq) {
      const float denom = l[rr] > 0.f ? l[rr] : 1.f;
      E* orow = out + (bh * Lq + q0 + r) * D;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) narrow(orow + d, acc[rr][e] / denom);
      }
    }
  }
}

template <typename E, int DPL>
int launch_v1(const E* q, const E* k, const E* v, const int* offsets,
              E* out, int BH, int H, int Lq, int Lk, int D, int causal,
              float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kBlockQ) * D +
      sizeof(E) * (2 * static_cast<size_t>(kKeyTile) *
                       (D + kKPadBytes / sizeof(E)) +
                   2 * static_cast<size_t>(kKeyTile) * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<E, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, BH);
  flash_attention_kernel<E, DPL><<<grid, kThreads, smem, stream>>>(
      q, k, v, offsets, out, H, Lq, Lk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int dispatch_v1(const E* q, const E* k, const E* v, const int* offsets,
                E* out, int BH, int H, int Lq, int Lk, int D, int causal,
                float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch_v1<E, 1>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal,
                           scale, stream);
  if (D <= 64)
    return launch_v1<E, 2>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal,
                           scale, stream);
  if (D <= 128)
    return launch_v1<E, 4>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal,
                           scale, stream);
  return launch_v1<E, 8>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal,
                         scale, stream);
}

// ---------------------------------------------------------------------------
// decode: CUDA cores, one query row a CTA, every warp on its own keys
// ---------------------------------------------------------------------------
constexpr int kDecodeStages = 2;    // stage buffers: copies run this many

// keys a stage, 32 KB of K and V at D 64 in either dtype
template <typename E>
__host__ __device__ constexpr int decode_keys() {
  return sizeof(E) == 4 ? 64 : 128;
}

// One stage of KS keys: K rows, then V rows, each DP elements (D
// zero-padded to 64 or 128) plus 16 bytes.
template <typename E, int DP, int KS>
struct Stage {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  static constexpr int kChunks = DP / kVec;         // copies a padded row
  static constexpr int kRow = DP + kVec;            // row stride, elements
  static constexpr int kStep = kThreads / kChunks;  // keys a copy round
  static constexpr int kBytes = 2 * KS * kRow * static_cast<int>(sizeof(E));
  static_assert(kThreads % kChunks == 0 && KS % kStep == 0,
                "whole copy rounds");
};

// Start the copies of keys [base, base + KS) of one (sequence, head) into
// stage buffer `buf` as one commit group; keys at or past n_keys and the
// columns past D are zero-filled.  Thread i copies chunk i % kChunks of
// keys i / kChunks + j * kStep: neighbouring threads, neighbouring bytes.
template <typename E, int DP, int KS>
__device__ __forceinline__ void load_stage(char* buf, const E* kh,
                                           const E* vh, int base, int n_keys,
                                           int D) {
  using S = Stage<E, DP, KS>;
  const int c = threadIdx.x % S::kChunks;
  const int k0 = threadIdx.x / S::kChunks;
  const bool col_ok = c < D / S::kVec;
  E* ks = reinterpret_cast<E*>(buf);
  E* vs = ks + KS * S::kRow;
#pragma unroll
  for (int j = 0; j < KS / S::kStep; ++j) {
    const int k = k0 + j * S::kStep;
    const bool ok = base + k < n_keys && col_ok;
    const size_t src =
        ok ? static_cast<size_t>(base + k) * D + S::kVec * c : 0;
    cp_async16_zfill(ks + k * S::kRow + S::kVec * c, kh + src, ok ? 16 : 0);
    cp_async16_zfill(vs + k * S::kRow + S::kVec * c, vh + src, ok ? 16 : 0);
  }
  cp_async_commit();
}

// Sum over the lane's half of a key row (16-byte chunks 2c + hq, c <
// NCH) of key . query-row q4 (fp32, zero past D as the row is).
template <typename E, int NCH>
__device__ __forceinline__ float half_dot(const uint4* kr, const float4* q4,
                                          int hq) {
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const uint4 w = kr[c];
    const int ci = 2 * c + hq;
    if constexpr (std::is_same<E, float>::value) {
      const float4 a = q4[ci];
      d0 += a.x * __uint_as_float(w.x);
      d1 += a.y * __uint_as_float(w.y);
      d2 += a.z * __uint_as_float(w.z);
      d3 += a.w * __uint_as_float(w.w);
    } else {
      const float4 a = q4[2 * ci];
      const float4 b = q4[2 * ci + 1];
      d0 += a.x * bf16_at(w.x, 0);
      d1 += a.y * bf16_at(w.x, 1);
      d2 += a.z * bf16_at(w.y, 0);
      d3 += a.w * bf16_at(w.y, 1);
      d0 += b.x * bf16_at(w.z, 0);
      d1 += b.y * bf16_at(w.z, 1);
      d2 += b.z * bf16_at(w.w, 0);
      d3 += b.w * bf16_at(w.w, 1);
    }
  }
  return (d0 + d1) + (d2 + d3);
}

// One query row a CTA: grid (Lq, B*H).  E: q/k/v/out element; DP: D
// zero-padded (64 or 128).
template <typename E, int DP>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const int* __restrict__ offsets,
    E* __restrict__ out, int H, int Lq, int Lk, int D, int causal,
    float scale) {
  constexpr int KS = decode_keys<E>();
  using S = Stage<E, DP, KS>;
  constexpr int kWarpKeys = KS / kWarps;   // 16 or 32
  constexpr int kHalf = S::kChunks / 2;    // 16-byte chunks a half row
  constexpr int CG = DP / 4;               // P.V: 4-column groups
  constexpr int KG = 32 / CG;              // P.V: key groups
  static_assert(CG <= 32 && 32 % CG == 0, "lanes = key x column groups");
  extern __shared__ float4 smem4[];
  // shared memory: the query row [DP] fp32, then the stages
  float* qs = reinterpret_cast<float*>(smem4);
  char* stages = reinterpret_cast<char*>(qs + DP);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x;
  const size_t bh = blockIdx.y;
  const int qpos = (offsets != nullptr ? offsets[bh / H] : 0) + r;
  const bool masked = causal || offsets != nullptr;
  const int n_keys = masked ? max(min(qpos + 1, Lk), 0) : Lk;
  const int n_stages = (n_keys + KS - 1) / KS;
  const E* kh = k + bh * Lk * D;
  const E* vh = v + bh * Lk * D;

  // the first stages, a commit group each (empty past the last stage, so
  // that the wait below always leaves kDecodeStages - 1 groups in flight)
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) {
    if (s < n_stages)
      load_stage<E, DP, KS>(stages + s * S::kBytes, kh, vh, s * KS, n_keys,
                            D);
    else
      cp_async_commit();
  }
  const size_t row = bh * Lq + r;
  for (int d = threadIdx.x; d < DP; d += kThreads)
    qs[d] = d < D ? widen(q[row * D + d]) : 0.f;

  // scores: lane kq and kq + 16 each take half of key kq's row; P.V:
  // lane (kg, cg) takes columns 4cg..4cg+3 of keys kg, kg + KG, ...
  const int kq = lane & 15;
  const int hq = lane >> 4;
  const int cg = lane % CG;
  const int kg = lane / CG;
  const float4* q4 = reinterpret_cast<const float4*>(qs);
  float m = kNeg, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int st = 0; st < n_stages; ++st) {
    const int ahead = st + kDecodeStages - 1;
    if (ahead < n_stages)    // into the buffer stage st - 1 freed
      load_stage<E, DP, KS>(stages + ahead % kDecodeStages * S::kBytes, kh,
                            vh, ahead * KS, n_keys, D);
    else
      cp_async_commit();
    cp_async_wait<kDecodeStages - 1>();   // stage st has landed
    __syncthreads();         // stage st (and q) visible to every warp
    const E* ks = reinterpret_cast<const E*>(
        stages + st % kDecodeStages * S::kBytes);
    const E* vs = ks + KS * S::kRow;
#pragma unroll
    for (int sub = 0; sub < kWarpKeys; sub += 16) {
      const int kb = warp * kWarpKeys + sub;   // the 16 keys' first
      if (st * KS + kb >= n_keys) break;       // uniform across the warp
      const int key = kb + kq;
      const bool vis = st * KS + key < n_keys;
      uint4 kr[kHalf];
      const uint4* krow = reinterpret_cast<const uint4*>(ks + key * S::kRow);
#pragma unroll
      for (int c = 0; c < kHalf; ++c) kr[c] = krow[2 * c + hq];
      float d = half_dot<E, kHalf>(kr, q4, hq);
      d += __shfl_xor_sync(kFull, d, 16);
      const float s = vis ? d * scale : kNeg;
      float mx = s;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m, mx);
      const float p = vis ? expf(s - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + p;                       // this lane's key's share
      m = m_new;
      acc.x *= alpha;
      acc.y *= alpha;
      acc.z *= alpha;
      acc.w *= alpha;
#pragma unroll
      for (int j = 0; j < 16 / KG; ++j) {
        const int kk = kg + KG * j;
        const float4 vv = load4(vs + (kb + kk) * S::kRow + 4 * cg);
        const float pk = __shfl_sync(kFull, p, kk);
        acc.x += pk * vv.x;
        acc.y += pk * vv.y;
        acc.z += pk * vv.z;
        acc.w += pk * vv.w;
      }
    }
    __syncthreads();         // the buffer free for the next copies
  }

  // the warp's partials: acc summed over its key groups, l over its 16
  // key lanes (both halves hold every key's p), in a fixed order
#pragma unroll
  for (int o = CG; o < 32; o <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, o);
    acc.y += __shfl_xor_sync(kFull, acc.y, o);
    acc.z += __shfl_xor_sync(kFull, acc.z, o);
    acc.w += __shfl_xor_sync(kFull, acc.w, o);
  }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
  // the stages are free (last barrier above): acc [warp][DP], then m and
  // l [warp]
  float* red = reinterpret_cast<float*>(stages);
  float* rm = red + kWarps * DP;
  float* rl = rm + kWarps;
  if (kg == 0) store4(red + warp * DP + 4 * cg, acc);
  if (lane == 0) {
    rm[warp] = m;
    rl[warp] = l;
  }
  __syncthreads();
  // merge the 4 warps in warp order, 4 output columns a thread
  const int c4 = threadIdx.x;
  if (c4 < CG && 4 * c4 < D) {
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, rm[w]);
    float lsum = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(rm[w] - mx);
      const float4 a = load4(red + w * DP + 4 * c4);
      lsum += rl[w] * f;
      o.x += a.x * f;
      o.y += a.y * f;
      o.z += a.z * f;
      o.w += a.w * f;
    }
    const float denom = lsum > 0.f ? lsum : 1.f;
    store4(out + row * D + 4 * c4,
           make_float4(o.x / denom, o.y / denom, o.z / denom, o.w / denom));
  }
}

template <typename E, int DP>
int launch_decode(const E* q, const E* k, const E* v, const int* offsets,
                  E* out, int BH, int H, int Lq, int Lk, int D, int causal,
                  float scale, cudaStream_t stream) {
  using S = Stage<E, DP, decode_keys<E>()>;
  const size_t smem = sizeof(float) * DP + kDecodeStages * S::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<E, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Lq, BH);
  flash_decode_kernel<E, DP><<<grid, kThreads, smem, stream>>>(
      q, k, v, offsets, out, H, Lq, Lk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// tile: tensor cores, 3xTF32 (fp32) or bf16 mma.sync
// ---------------------------------------------------------------------------
constexpr int kTcBlockQ = 16 * kWarps;   // 16 query rows a warp (mma M)

// E: q/k/v/out element; DP: D zero-padded to 16, 32, 64 or 128; KT: keys
// a shared-memory tile.
template <typename E, int DP, int KT>
__global__ void __launch_bounds__(kThreads) flash_attention_tc_kernel(
    const E* __restrict__ q, const E* __restrict__ k,
    const E* __restrict__ v, const int* __restrict__ offsets,
    E* __restrict__ out, int H, int Lq, int Lk, int D, int causal,
    float scale) {
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  constexpr int KSTEPS = kBf16 ? DP / 16 : DP / 8;  // Q K^T k-steps
  constexpr int NO = DP / 8;              // output n-blocks
  constexpr int kStride = DP + kVec;      // elements a K/V row in smem
  constexpr int kStage = 2 * KT * kStride;  // K tile, then V tile
  constexpr int NB = KT / 8;              // 8-key blocks a tile
  constexpr int kChunks = DP / kVec;      // 16-byte chunks a row
  // fp32: Q's hi/lo A fragments in registers up to D 64, else in shared
  // memory, each lane's own (registers: D 128 spilled)
  constexpr bool kQSmem = !kBf16 && DP > 64;
  constexpr int kQR = kQSmem ? 1 : KSTEPS;
  constexpr int kNC = NO < 8 ? NO : 8;    // P.V's n-blocks a pass
  static_assert(KT * kChunks % kThreads == 0, "whole copy rounds");
  static_assert(NB * 4 <= 32, "one visibility bit a score");
  static_assert(!kBf16 || kNC % 2 == 0, "ldmatrix.x4 feeds two n-blocks");
  extern __shared__ float4 smem4[];
  E* smem = reinterpret_cast<E*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t bh = blockIdx.x;
  // global position of query row 0: offsets[b] in offset mode (which
  // is causal), 0 otherwise
  const int ofs = offsets != nullptr ? offsets[bh / H] : 0;
  const bool masked = causal || offsets != nullptr;
  const int qt = masked ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kTcBlockQ;
  const int r0 = q0 + 16 * warp;          // the warp's first query row
  // keys the CTA reads, and keys the warp's rows can see: [0, n)
  const int n_keys =
      masked ? min(ofs + min(q0 + kTcBlockQ, Lq), Lk) : Lk;
  const int warp_keys =
      r0 >= Lq ? 0 : masked ? min(ofs + min(r0 + 16, Lq), Lk) : Lk;
  const int n_tiles = n_keys > 0 ? (n_keys + KT - 1) / KT : 0;
  const E* kh = k + bh * Lk * D;
  const E* vh = v + bh * Lk * D;

  // stage tile `tile` in buffer `buf`: K rows, then V rows; keys past
  // n_keys and the columns past D are zero-filled
  auto load_tile = [&](int tile, int buf) {
    const int base = tile * KT;
    E* ks = smem + buf * kStage;
    E* vs = ks + KT * kStride;
#pragma unroll
    for (int it = 0; it < KT * kChunks / kThreads; ++it) {
      const int i = threadIdx.x + it * kThreads;
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool ok = base + r < n_keys && c < D / kVec;
      const size_t off =
          ok ? static_cast<size_t>(base + r) * D + kVec * c : 0;
      cp_async16_zfill(ks + r * kStride + kVec * c, kh + off, ok ? 16 : 0);
      cp_async16_zfill(vs + r * kStride + kVec * c, vh + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_tile(0, 0);

  // Q's A fragments, rows r0 + (g, g+8); zero past Lq rows and D columns.
  // fp32: hi/lo of columns 8s + (t, t+4); bf16: pairs at columns 16s +
  // 2t.. and 16s + 2t + 8..
  uint32_t qhi[kQR][4], qlo[kBf16 ? 1 : kQR][4];
  // fp32, D > 64: k-step s's hi and lo of this lane at qfrag[64 s],
  // [64 s + 32]
  uint4* qfrag = reinterpret_cast<uint4*>(smem + 2 * kStage) +
                 warp * KSTEPS * 64 + lane;
  const E* qg = q + bh * Lq * D;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    if constexpr (kBf16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e & 1);
        const int col = 16 * s + 2 * t + 8 * (e >> 1);
        qhi[s][e] = row < Lq && col < D
                        ? *reinterpret_cast<const uint32_t*>(
                              qg + static_cast<size_t>(row) * D + col)
                        : 0u;
      }
    } else {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e & 1);
        const int col = 8 * s + t + 4 * (e >> 1);
        const float x = row < Lq && col < D
                            ? qg[static_cast<size_t>(row) * D + col]
                            : 0.f;
        split_tf32(x, hi[e], lo[e]);
      }
      if constexpr (kQSmem) {
        qfrag[64 * s] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        qfrag[64 * s + 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qhi[s][e] = hi[e];
          qlo[s][e] = lo[e];
        }
      }
    }
  }

  // rows g and g+8 of the warp: running max, this lane's partial sum;
  // the output's C fragments, one per 8 columns
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, buf ^ 1);
      cp_async_wait<1>();    // tile has landed, tile+1 in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();         // the tile visible to every warp
    const int k0 = tile * KT;
    const int nvis = min(KT, warp_keys - k0);
    if (nvis > 0) {          // uniform across the warp
      const int jn = (nvis + 7) / 8;       // 8-key blocks the warp sees
      const E* ks = smem + buf * kStage;
      const E* vs = ks + KT * kStride;

      // S = Q K^T
      float sc[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        if constexpr (kBf16) {
          // B: key 8j + g, columns 16s + 2t.. and 16s + 2t + 8..
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            if (j < jn) {
              const uint32_t* kr = reinterpret_cast<const uint32_t*>(
                  ks + (8 * j + g) * kStride + 16 * s + 2 * t);
              mma_bf16(sc[j], qhi[s], kr[0], kr[4]);
            }
          }
        } else {
          uint32_t ah[4], al[4];
          if constexpr (kQSmem) {
            const uint4 hv = qfrag[64 * s], lv = qfrag[64 * s + 32];
            ah[0] = hv.x, ah[1] = hv.y, ah[2] = hv.z, ah[3] = hv.w;
            al[0] = lv.x, al[1] = lv.y, al[2] = lv.z, al[3] = lv.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[e] = qhi[s][e];
              al[e] = qlo[s][e];
            }
          }
          // B: key 8j + g, columns 8s + t and 8s + t + 4
          uint32_t kb_hi[NB][2], kb_lo[NB][2];
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            if (j < jn) {
              const float* kr = reinterpret_cast<const float*>(ks) +
                                (8 * j + g) * kStride + 8 * s + t;
              split_tf32(kr[0], kb_hi[j][0], kb_lo[j][0]);
              split_tf32(kr[4], kb_hi[j][1], kb_lo[j][1]);
            }
          }
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (j < jn) mma_tf32(sc[j], al, kb_hi[j][0], kb_hi[j][1]);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (j < jn) mma_tf32(sc[j], ah, kb_lo[j][0], kb_lo[j][1]);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            if (j < jn) mma_tf32(sc[j], ah, kb_hi[j][0], kb_hi[j][1]);
        }
      }

      // scale; mask where the tile crosses the (offset) diagonal or the
      // end of the keys (bit 4j + e: score (j, e) visible); the new row
      // max
      const bool edge =
          k0 + KT > n_keys || (masked && k0 + KT - 1 > ofs + r0);
      uint32_t vis = 0xffffffffu;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[j][e] * scale;
          if (edge) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            if (kpos >= Lk || (masked && kpos > ofs + row)) {
              s = kNeg;
              vis &= ~(1u << (4 * j + e));
            }
          }
          sc[j][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
        alpha[h] = expf(m[h] - mx[h]);
        m[h] = mx[h];
      }
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              (vis >> (4 * j + e)) & 1u ? expf(sc[j][e] - m[e >> 1]) : 0.f;
          sc[j][e] = p;
          rsum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];

      // O = O * alpha + P V, kNC output n-blocks a pass
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += kNC) {
        float pv[kNC][4];
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[c][e] = 0.f;
        if constexpr (kBf16) {
          // 16 keys a k-step: blocks 2jj and 2jj+1 of S's C fragments are
          // P's A fragment as they stand; V's rows 16jj.. by ldmatrix
#pragma unroll
          for (int jj = 0; jj < NB / 2; ++jj) {
            if (2 * jj < jn) {
              uint32_t ph[4], pl[4];
              split_bf16x2(sc[2 * jj][0], sc[2 * jj][1], ph[0], pl[0]);
              split_bf16x2(sc[2 * jj][2], sc[2 * jj][3], ph[1], pl[1]);
              split_bf16x2(sc[2 * jj + 1][0], sc[2 * jj + 1][1], ph[2],
                           pl[2]);
              split_bf16x2(sc[2 * jj + 1][2], sc[2 * jj + 1][3], ph[3],
                           pl[3]);
              // lanes 8i..: matrix i = (keys + 8 (i & 1), n-block + i / 2)
              const E* vrow = vs + (16 * jj + (lane & 7) +
                                    8 * ((lane >> 3) & 1)) * kStride +
                              8 * (n0 + (lane >> 4));
#pragma unroll
              for (int c = 0; c < kNC; c += 2) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, vrow + 8 * c);
                mma_bf16(pv[c], pl, bv[0], bv[1]);
                mma_bf16(pv[c + 1], pl, bv[2], bv[3]);
                mma_bf16(pv[c], ph, bv[0], bv[1]);
                mma_bf16(pv[c + 1], ph, bv[2], bv[3]);
              }
            }
          }
        } else {
          // 3xTF32; key 2t of block j is the mma's k = t, key 2t+1 its
          // k = t + 4, in A (P from S's C fragment) and in B (V rows)
          // alike
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            if (j < jn) {
              // a0 P(g, 2t), a1 P(g+8, 2t), a2 P(g, 2t+1), a3 P(g+8, 2t+1)
              uint32_t ph[4], pl[4];
              split_tf32(sc[j][0], ph[0], pl[0]);
              split_tf32(sc[j][2], ph[1], pl[1]);
              split_tf32(sc[j][1], ph[2], pl[2]);
              split_tf32(sc[j][3], ph[3], pl[3]);
              // b0 V(8j + 2t, col), b1 V(8j + 2t + 1, col), col 8n + g
              const float* v0 = reinterpret_cast<const float*>(vs) +
                                (8 * j + 2 * t) * kStride + g;
              uint32_t vhi[kNC][2], vlo[kNC][2];
#pragma unroll
              for (int c = 0; c < kNC; ++c) {
                split_tf32(v0[8 * (n0 + c)], vhi[c][0], vlo[c][0]);
                split_tf32(v0[kStride + 8 * (n0 + c)], vhi[c][1],
                           vlo[c][1]);
              }
#pragma unroll
              for (int c = 0; c < kNC; ++c)
                mma_tf32(pv[c], pl, vhi[c][0], vhi[c][1]);
#pragma unroll
              for (int c = 0; c < kNC; ++c)
                mma_tf32(pv[c], ph, vlo[c][0], vlo[c][1]);
#pragma unroll
              for (int c = 0; c < kNC; ++c)
                mma_tf32(pv[c], ph, vhi[c][0], vhi[c][1]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[n0 + c][e] = o[n0 + c][e] * alpha[e >> 1] + pv[c][e];
      }
    }
    __syncthreads();         // buffer `buf` free for tile+2's copies
  }

  // the row sums of the 4 lanes of a row, in the same order on each
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row < Lq) {
      const float denom = l[h] > 0.f ? l[h] : 1.f;
      E* orow = out + (bh * Lq + row) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;     // D even: col + 1 < D too
        if (col < D)
          store2(orow + col, o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
      }
    }
  }
}

template <typename E, int DP, int KT>
int launch_tc(const E* q, const E* k, const E* v, const int* offsets,
              E* out, int BH, int H, int Lq, int Lk, int D, int causal,
              float scale, cudaStream_t stream) {
  constexpr bool kQSmem = std::is_same<E, float>::value && DP > 64;
  // two stages of K and V tiles; fp32 at D > 64: the Q fragments
  const size_t smem =
      sizeof(E) * 2 * 2 * KT * (DP + 16 / sizeof(E)) +
      (kQSmem ? sizeof(uint4) * 64 * kWarps * (DP / 8) : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<E, DP, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_qt = (Lq + kTcBlockQ - 1) / kTcBlockQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, n_qt);
  flash_attention_tc_kernel<E, DP, KT><<<grid, kThreads, smem, stream>>>(
      q, k, v, offsets, out, H, Lq, Lk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wgmma: bf16 on Hopper's warpgroup MMA, TMA loads, a producer warp
// ---------------------------------------------------------------------------
constexpr int kWgRows = 64;      // query rows a consumer warpgroup (wgmma M)
constexpr int kWgKeys = 64;      // keys a K/V stage (S's N)
constexpr int kBoxCols = 64;     // bf16 columns a TMA box: one 128-byte row
constexpr int kBoxBytes = 64 * 128;   // a 64-row box

constexpr int kWgThreads = 128 + 32;   // a consumer warpgroup + a producer warp

// Shared memory of one CTA (1024-byte aligned): the Q rows as DP / 64
// boxes of [64 rows][64 columns], then the ring's stages, each the K
// boxes of 64 keys followed by the V boxes, then the barriers (K full,
// V full and empty a stage, then Q's).  Every box is in the 128-byte
// swizzle that TMA writes and wgmma reads.  The ring holds 4 stages at D
// 64, 3 at D 128: 74 KB a CTA at D 64, so three CTAs fit an SM, as
// their registers do (at most 136 a thread, __launch_bounds__).
template <int DP>
struct WgLayout {
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr int kSub = DP / kBoxCols;   // boxes a row
  static constexpr int kQBytes = kSub * kBoxBytes;
  static constexpr int kHalfBytes = kSub * kBoxBytes;   // a stage's K (or V)
  static constexpr int kStageBytes = 2 * kHalfBytes;
  static constexpr int kBar = kQBytes + kStages * kStageBytes;
  static constexpr int kBytes = kBar + 8 * (3 * kStages + 1);
  static_assert(kWgKeys * 128 == kBoxBytes, "a stage's box is 64 keys");
};

// The online softmax of one 64 x 64 S tile in wgmma's C layout, in
// place: sc (this lane's raw scores q.k of rows g and g + 8 of its warp,
// keys k0 + 8j + 2tq + (e & 1) at sc[4j + e]) becomes p; the running max
// m (of raw scores) and this lane's partial l move on; alpha receives
// each row's rescale factor.  vis[h]: the keys row h of the pair sees,
// counted from k0 + 2tq (a score is visible when 8j + (e & 1) < vis[h]),
// so the mask is two instructions a score and no branch.  A masked score
// is -1e30 and its p underflows to exactly 0 (every row sees key 0 in
// the first tile, so m is finite from there on).  p = 2^(s * scale log2
// e - m * scale log2 e): one FMA and one ex2 a score.
__device__ __forceinline__ void wg_softmax(float* sc, float* m, float* l,
                                           float* alpha, const int* vis,
                                           float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = sc[4 * j + e];
      x = 8 * j + (e & 1) < vis[e >> 1] ? x : kNeg;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float ms[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    alpha[h] = exp2f((m[h] - mx[h]) * scale_log2);
    m[h] = mx[h];
    ms[h] = mx[h] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(sc[4 * j + e], scale_log2, -ms[e >> 1]));
      sc[4 * j + e] = p;
      rsum[e >> 1] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rsum[h];
}

// One consumer warpgroup of 64 query rows and one producer warp; grid
// (B*H, q-tiles of 64 rows), the last q-tiles first in causal mode.  DP:
// D zero-padded to 64 or 128 (by TMA's out-of-bounds fill).  Three CTAs
// an SM at D 64: the 136-register cap leaves ptxas enough with no spill,
// where its free choice fitted two CTAs and ran slower (PERF.md §6 row
// 6b); two at D 128.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, DP == 64 ? 3 : 2)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 __nv_bfloat16* __restrict__ out, int Lq,
                                 int Lk, int D, int causal,
                                 float scale_log2) {
  using L = WgLayout<DP>;
  constexpr int NS = L::kStages;
  constexpr int NO = DP / 8;               // the output's n-blocks
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  // the swizzle's period starts on a 1024-byte shared address
  const uint32_t raw = smem_addr(wg_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  auto kfull = [&](int s) { return bars + 8 * s; };
  auto vfull = [&](int s) { return bars + 8 * (NS + s); };
  auto empty = [&](int s) { return bars + 8 * (2 * NS + s); };
  const uint32_t qbar = bars + 8 * 3 * NS;
  auto k_at = [&](int s) { return base + L::kQBytes + s * L::kStageBytes; };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                        : static_cast<int>(blockIdx.y);
  const int q0 = qt * kWgRows;
  // keys the CTA's rows can see: tiles [0, n_tiles)
  const int n_keys = causal ? min(min(q0 + kWgRows, Lq), Lk) : Lk;
  const int n_tiles = (n_keys + kWgKeys - 1) / kWgKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(kfull(s), 1);              // the producer's expect_tx
      mbar_init(vfull(s), 1);
      mbar_init(empty(s), 4);              // one arrival a consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // the producer: one thread issues every copy; Q once, then K and V
    // tile by tile into the ring, each stage once the consumers freed it
    if (lane == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      mbar_expect_tx(qbar, L::kQBytes);
      for (int c = 0; c < L::kSub; ++c)
        tma_load_3d(base + c * kBoxBytes, &tm_q, qbar, c * kBoxCols, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % NS;
        mbar_wait(empty(s), ((t / NS) & 1) ^ 1);
        mbar_expect_tx(kfull(s), L::kHalfBytes);
        for (int c = 0; c < L::kSub; ++c)
          tma_load_3d(k_at(s) + c * kBoxBytes, &tm_k, kfull(s), c * kBoxCols,
                      t * kWgKeys, bh);
        mbar_expect_tx(vfull(s), L::kHalfBytes);
        for (int c = 0; c < L::kSub; ++c)
          tma_load_3d(k_at(s) + L::kHalfBytes + c * kBoxBytes, &tm_v,
                      vfull(s), c * kBoxCols, t * kWgKeys, bh);
      }
    }
    return;
  }

  // the consumer warpgroup: warp w of it holds rows rw..rw + 15
  const int g = lane / 4;
  const int tq = lane % 4;
  const int rw = q0 + 16 * warp;
  const uint32_t q_s = base;

  // S = Q K^T of tile t into sc, issued and committed as one group:
  // DP / 16 k-steps, step kk 32 bytes into box kk / 4 of Q and of K
  float sc[32];
  auto issue_s = [&](int t) {
    const int s = t % NS;
    mbar_wait(kfull(s), (t / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n64(sc, sw128_desc(q_s + off, 16),
                   sw128_desc(k_at(s) + off, 16), kk > 0);
    }
    wgmma_commit();
  };
  // the keys rows g and g + 8 of the warp see in tile t, from k0 + 2tq:
  // all of them but in the CTA's last tile, where the diagonal and the
  // end of the keys fall
  auto visible = [&](int t, int* vis) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rw + g + 8 * h;
      vis[h] = (causal ? min(row + 1, Lk) : Lk) - t * kWgKeys - 2 * tq;
    }
  };

  // rows g and g+8 of the warp: running max of raw scores, this lane's
  // partial sum, the rescale of the tile in hand; O in wgmma's C layout,
  // 4 values an n-block
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  int vis[2];
  float o[4 * NO];
#pragma unroll
  for (int i = 0; i < 4 * NO; ++i) o[i] = 0.f;

  // tile t's P (sc) to two bf16 terms and O *= alpha; then, with tile
  // t+1 (`next`), S of tile t+1 is issued before O += P V, and tile t+1's
  // softmax runs while P V is in flight.  The steady loop runs `next`
  // and the last tile is peeled, so no branch lies inside the in-flight
  // window (a branch there makes ptxas serialize every wgmma).
  uint32_t ph[4][4], pl[4][4];
  auto step = [&](int t, auto next) {
    const int s = t % NS;
    // P in n-blocks 2kk and 2kk+1 of S's C layout is wgmma's A fragment
    // of keys 16kk.. as it stands; hi = bf16(p), lo = bf16(p - hi)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16x2(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], ph[kk][i],
                     pl[kk][i]);
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) {
      o[i] *= alpha[(i >> 1) & 1];
      reg_fence(o[i]);                     // before the wgmmas, not after
    }
    if constexpr (decltype(next)::value) issue_s(t + 1);
    // O += P V, lo first: V MN-major from its boxes (k-step kk 16 rows =
    // 2048 bytes in; the next 64 columns one box on)
    mbar_wait(vfull(s), (t / NS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv =
          sw128_desc(k_at(s) + L::kHalfBytes + kk * 2048, kBoxBytes);
      if constexpr (DP == 64) {
        wgmma_rs_n64(o, pl[kk], dv);
        wgmma_rs_n64(o, ph[kk], dv);
      } else {
        wgmma_rs_n128(o, pl[kk], dv);
        wgmma_rs_n128(o, ph[kk], dv);
      }
    }
    wgmma_commit();
    if constexpr (decltype(next)::value) {
      wgmma_wait<1>();                     // S of tile t+1 (the older group)
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(sc[i]);
      visible(t + 1, vis);
      wg_softmax(sc, m, l, alpha, vis, scale_log2);
    }
    wgmma_wait<0>();                       // P V of tile t
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        reg_hold(ph[kk][i]);
        reg_hold(pl[kk][i]);
      }
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) reg_fence(o[i]);
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(sc[i]);
    if (lane == 0) mbar_arrive(empty(s));  // the stage is free
  };

  mbar_wait(qbar, 0);
  issue_s(0);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 32; ++i) reg_fence(sc[i]);
  visible(0, vis);
  wg_softmax(sc, m, l, alpha, vis, scale_log2);
  for (int t = 0; t + 1 < n_tiles; ++t) step(t, std::true_type());
  step(n_tiles - 1, std::false_type());

  // the row sums of the 4 lanes of a row, then acc / (l > 0 ? l : 1),
  // rounded once to bf16; rows past Lq and columns past D are not stored
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rw + g + 8 * h;
    if (row < Lq) {
      const float denom = l[h] > 0.f ? l[h] : 1.f;
      __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * Lq + row) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * tq;      // D even: col + 1 < D too
        if (col < D)
          store2(orow + col, o[4 * n + 2 * h] / denom,
                 o[4 * n + 2 * h + 1] / denom);
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda); null where the driver lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a contiguous bf16 (BH, L, D) tensor as 64-row x 64-column
// boxes in the 128-byte swizzle; rows past L and columns past D read as
// zeros.  Returns false when the driver refuses it.
bool encode_rows(EncodeTiled fn, CUtensorMap* map, const __nv_bfloat16* x,
                 int BH, int L, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(L) * D * 2};
  const cuuint32_t box[3] = {kBoxCols, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
            const_cast<__nv_bfloat16*>(x), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* out, int BH, int Lq,
                 int Lk, int D, int causal, float scale,
                 cudaStream_t stream) {
  using L = WgLayout<DP>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_rows(fn, &tm_q, q, BH, Lq, D) ||
      !encode_rows(fn, &tm_k, k, BH, Lk, D) ||
      !encode_rows(fn, &tm_v, v, BH, Lk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = L::kBytes + 1024;       // + the alignment slack
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (Lq + kWgRows - 1) / kWgRows;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, n_qt);
  flash_attention_wgmma_kernel<DP><<<grid, kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, out, Lq, Lk, D, causal,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// One launch of `path` with `block_q` query rows a CTA; refuses a pair
// the shape does not allow.  q (BH, Lq, D); k, v (BH, Lk, D); out like
// q; offsets (BH / H,) int32 or null.
template <typename E>
int run(int path, int block_q, const E* q, const E* k, const E* v,
        const int* offsets, E* out, int BH, int H, int Lq, int Lk, int D,
        int causal, float scale, cudaStream_t stream) {
  constexpr int kMult = std::is_same<E, float>::value ? 4 : 8;
  if (BH <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % kMult != 0 || Lk <= 0 || H <= 0 ||
      BH % H != 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == kPathV1 && block_q == kBlockQ)
    return dispatch_v1<E>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal,
                          scale, stream);
  if (path == kPathDecode && D <= 128 && block_q == 1) {
    if (D <= 64)
      return launch_decode<E, 64>(q, k, v, offsets, out, BH, H, Lq, Lk, D,
                                  causal, scale, stream);
    return launch_decode<E, 128>(q, k, v, offsets, out, BH, H, Lq, Lk, D,
                                 causal, scale, stream);
  }
  if (path == kPathTile && D <= 128 && block_q == kTcBlockQ) {
    if (D <= 16)
      return launch_tc<E, 16, 64>(q, k, v, offsets, out, BH, H, Lq, Lk, D,
                                  causal, scale, stream);
    if (D <= 32)
      return launch_tc<E, 32, 64>(q, k, v, offsets, out, BH, H, Lq, Lk, D,
                                  causal, scale, stream);
    if (D <= 64)
      return launch_tc<E, 64, 64>(q, k, v, offsets, out, BH, H, Lq, Lk, D,
                                  causal, scale, stream);
    return launch_tc<E, 128, 32>(q, k, v, offsets, out, BH, H, Lq, Lk, D,
                                 causal, scale, stream);
  }
  if constexpr (std::is_same<E, __nv_bfloat16>::value) {
    if (path == kPathWgmma && D <= 128 && offsets == nullptr &&
        block_q == kWgRows) {
      if (D <= 64)
        return launch_wgmma<64>(q, k, v, out, BH, Lq, Lk, D, causal, scale,
                                stream);
      return launch_wgmma<128>(q, k, v, out, BH, Lq, Lk, D, causal, scale,
                               stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// flash_attention: q (B*H, Lq, D); k, v (B*H, Lk, D); out like q; all
// contiguous fp32.  path 0 v1, 1 decode, 2 tile.
extern "C" int mxt_flash_attention_f32(const float* q, const float* k,
                                       const float* v, float* out, int BH,
                                       int Lq, int Lk, int D, int causal,
                                       float scale, int path, int block_q,
                                       cudaStream_t stream) {
  return run<float>(path, block_q, q, k, v, nullptr, out, BH, 1, Lq, Lk, D,
                    causal, scale, stream);
}

// the same in bf16 (q, k, v and out); D % 8 == 0; also path 3, wgmma
extern "C" int mxt_flash_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* out, int BH, int Lq, int Lk, int D, int causal,
    float scale, int path, int block_q, cudaStream_t stream) {
  return run<__nv_bfloat16>(path, block_q, q, k, v, nullptr, out, BH, 1, Lq,
                            Lk, D, causal, scale, stream);
}

// flash_attention_offset: q (B*H, Lq, D); k, v (B*H, Lk, D); offsets (B,)
// int32; out like q; all contiguous fp32 but the offsets.
extern "C" int mxt_flash_attention_offset_f32(
    const float* q, const float* k, const float* v, const int* offsets,
    float* out, int B, int H, int Lq, int Lk, int D, float scale, int path,
    int block_q, cudaStream_t stream) {
  return run<float>(path, block_q, q, k, v, offsets, out, B * H, H, Lq, Lk,
                    D, 1, scale, stream);
}

// the same in bf16 (q, k, v and out); D % 8 == 0
extern "C" int mxt_flash_attention_offset_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const int* offsets, __nv_bfloat16* out, int B, int H, int Lq, int Lk,
    int D, float scale, int path, int block_q, cudaStream_t stream) {
  return run<__nv_bfloat16>(path, block_q, q, k, v, offsets, out, B * H, H,
                            Lq, Lk, D, 1, scale, stream);
}
