// Paged flash attention forward for Hopper (sm_90a): fp32 pools, bf16
// pools (with bf16 q and output), and int8 code pools with per-(head,
// physical block) fp32 scales.
//
// Replaces the TPU kernel _paged_kernel of
// mxnet_tpu/pallas_ops/paged_attention.py, both of its variants
// (int8=False and int8=True), with its semantics (:66-109): query row r
// of sequence b sits at global position positions[b] + r and attends,
// offset-causally, to every key position <= its own; logical key
// position p of sequence b lives at pool row tables[b, p / bs] * bs +
// p % bs of the per-head (H, pool_rows, D) K and V pools; s = (q . k) *
// scale; masked scores are -1e30 and masked p is 0; the online softmax
// runs in fp32; the output is acc / (l > 0 ? l : 1) in q's dtype; an
// int8 key or value is its code times scale[h, tables[b, p / bs]] (per
// key: a tile may span physical blocks).  Keys past a CTA's last query
// position are never read (the dynamic block skip of :75, at key
// granularity), so table entries past the frontier, which point at the
// trash block 0, never leak.  Every body sums in a fixed order with no
// atomics: a launch gives the same bits every time.
//
// Three bodies behind each entry point; kernels/paged_attention.py::_plan
// picks the body (path) and the query rows a CTA (block_q) from the
// shape, and the entry point refuses a pair the shape does not allow.
// All three stage K/V rows key by key through the block table into shared
// memory with 16-byte cp.async copies, double-buffered: the next stage's
// copies are in flight while the current one is computed, and a stage
// may span physical blocks of any block size.  Rows are padded by 16
// bytes, so 8 keys' rows start 4 banks apart.
//
// * decode (path 1; the serving path's decode step, Lq 1; int8 pools up
//   to Lq 4), D <= 128, CUDA cores.  Bound: bytes (each key row feeds 4*D
//   flops).  One CTA of 4 warps per (sequence, head, query row), so Lq
//   CTAs read a sequence's keys; a stage is 64 keys (fp32) or 128 (bf16,
//   int8: the same 32 KB at D 64), and each warp takes its own
//   quarter of every stage, 16 keys at a time, with its own online
//   softmax (m, l, acc): no traffic between warps but the staging
//   barrier, and no warp idle.  In a 16-key step lane k and lane k + 16
//   each dot half of key k's row with the query (joined by one shuffle),
//   and for P.V the lanes split into key groups x 4-column groups (D 64:
//   2 x 16), so a warp walks 8 keys in turn, not 32.  The 4 warps'
//   partials are merged in warp order at the end.  The CTA of the longest
//   sequence sets the time: it walks its stages one after another.  int8
//   folds each key's scales into s and p (s = (q . codes) * sk * scale,
//   acc += (p * sv) * codes, l sums p).
// * tile (path 2; Lq above the decode body's, the prefill chunk Lq 32),
//   D <= 128, tensor cores (mma.sync).  One CTA of 4 warps per
//   (sequence, head, 32 query rows, or 16 where the 32-row grid would not
//   fill the card); the query rows are the mma's M.  With 32 rows warps
//   0-1 take rows 0-15 and 16-31 over keys 0-31 of each 64-key stage and
//   warps 2-3 the same rows over keys 32-63; with 16 rows each warp takes
//   16 keys of each stage.  Each warp keeps (m, l, acc) for its rows in
//   registers; the partials of the warps that share rows are merged in
//   shared memory at the end, in key order.  The mask runs only on
//   stages that cross a row's frontier.  P.V takes P from S's C
//   fragments with no shared-memory round trip.  Bound: bytes, at the
//   tensor-core rates below.
//   - fp32 pools: both products in 3xTF32 (hi.hi + hi.lo + lo.hi,
//     m16n8k8, split_tf32 of attention_common.cuh) as flash_attention.cu's
//     tensor-core body: one TF32 pass misses 1e-4 tenfold.  P's C
//     fragment gives lane t keys 2t and 2t+1 of each 8-key block; key 2t
//     is the mma's k = t and key 2t+1 its k = t + 4, in P and in V's rows
//     alike (P.V sums over keys, so only the order of additions changes).
//   - int8 pools: the codes (|c| <= 127) are exact in TF32, so 2xTF32
//     (q_hi.c + q_lo.c) is enough in both products; S is multiplied by
//     each key's scale on its C fragment, and P.V takes p' = p * sv split
//     in two TF32 parts over the codes of V; l sums the unscaled p.
//   - bf16 pools: Q K^T in one m16n8k16 bf16 mma a k-step (products of
//     bf16 values are exact in the fp32 accumulator); for P.V, p is split
//     into hi = bf16(p) and lo = bf16(p - hi), two mma a k-step, which
//     keeps P near fp32; V's B fragments come from ldmatrix.trans.
// * v1 (path 0; every D up to 256, the only body for D in (128, 256],
//   which no path of the port runs, and on request for timing), CUDA
//   cores: one CTA of 4 warps per (sequence, head, up to 16 query rows),
//   warp w owning rows w, w+4, w+8, w+12, 32-key tiles, lane k computing
//   query-row . key-k and P.V one key at a time through shuffles.
// Requires a 16-byte row: D % 4 == 0 (fp32), D % 8 == 0 (bf16) or
// D % 16 == 0 (int8).  No split of one sequence's keys over several CTAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
// the entry points' path argument (kernels/paged_attention.py _PATH)
constexpr int kPathV1 = 0;
constexpr int kPathDecode = 1;
constexpr int kPathTile = 2;

// ---------------------------------------------------------------------------
// v1: CUDA cores, one key a lane
// ---------------------------------------------------------------------------
constexpr int kKeyTile = 32;        // keys per shared-memory tile: one a lane
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxBlockQ = kMaxRowsPerWarp * kWarps;
constexpr int kKPadBytes = 16;      // K row stride D * sizeof(E) + 16 bytes

// an int8 code widened to fp32 (widen's int8 overload)
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float code_at(uint32_t word, int e) {
  // byte e of a little-endian word, sign-extended
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * e)) >>
                            24);
}

// E: pool element, float, __nv_bfloat16 or int8_t (codes, with
// k_scale/v_scale (H, num_blocks) fp32; null otherwise).  Q: q and out
// element, float or __nv_bfloat16.  DPL: head-dim elements each lane
// accumulates (D <= 32 * DPL).
template <typename E, typename Q, int DPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const Q* __restrict__ q, const E* __restrict__ k_pool,
    const E* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, Q* __restrict__ out, int H,
    int Lq, int D, int T, int bs, int pool_rows, int num_blocks,
    int block_q, float scale) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  constexpr int kVec = 16 / sizeof(E);   // elements per 16-byte copy
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, Lq - q0);
  const int DV = D / kVec;                // 16-byte chunks per row
  const int ks_stride = D + kKPadBytes / static_cast<int>(sizeof(E));

  // shared memory: Q [block_q][D] fp32, then two stages of
  // K [kKeyTile][D + pad] followed by V [kKeyTile][D], in E
  float* qs = smem;
  E* stages = reinterpret_cast<E*>(qs + block_q * D);
  const int stage = kKeyTile * (ks_stride + D);

  const int ofs = positions[b];
  const int q_last = ofs + q0 + nq - 1;   // global position, last row
  const int n_keys = min(q_last + 1, T * bs);
  const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile;
  const E* kh = k_pool + static_cast<size_t>(h) * pool_rows * D;
  const E* vh = v_pool + static_cast<size_t>(h) * pool_rows * D;
  const int* tbl = tables + static_cast<size_t>(b) * T;

  // stage tile t's K and V rows: kKeyTile keys x DV 16-byte chunks each
  auto issue = [&](int t, int buf) {
    const int base = t * kKeyTile;
    const int nk = min(kKeyTile, n_keys - base);
    for (int i = threadIdx.x; i < nk * DV; i += kThreads) {
      const int k = i / DV;
      const int c = i - k * DV;
      const int p = base + k;
      const size_t row =
          static_cast<size_t>(tbl[p / bs]) * bs + static_cast<size_t>(p % bs);
      E* ks = stages + buf * stage;
      cp_async16(ks + k * ks_stride + kVec * c, kh + row * D + kVec * c);
      cp_async16(ks + kKeyTile * ks_stride + k * D + kVec * c,
                 vh + row * D + kVec * c);
    }
    cp_async_commit();
  };

  issue(0, 0);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const Q* qg = q + (bh * Lq + q0) * D;
  for (int i = threadIdx.x; i < nq * D; i += kThreads) qs[i] = widen(qg[i]);

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp];
  float acc[kMaxRowsPerWarp][DPL];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
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
    // int8: this lane's key's scales (lanes past nk hold 0, unused)
    float sk = 0.f, sv = 0.f;
    if constexpr (kInt8) {
      if (lane < nk) {
        const size_t sidx = static_cast<size_t>(h) * num_blocks +
                            static_cast<size_t>(tbl[kpos / bs]);
        sk = k_scale[sidx];
        sv = v_scale[sidx];
      }
    }
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r < nq) {                          // uniform across the warp
        const int qpos = ofs + q0 + r;
        const bool vis = lane < nk && qpos >= kpos;
        float s = kNeg;
        if (lane < nk) {
          const float4* q4 = reinterpret_cast<const float4*>(qs + r * D);
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          if constexpr (kInt8) {
            // 16 codes a chunk, each dequantized before its product
            const uint4* k16 =
                reinterpret_cast<const uint4*>(ks + lane * ks_stride);
            for (int j = 0; j < DV; ++j) {
              const uint4 w = k16[j];
              const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const float4 a = q4[4 * j + u];
                d0 += a.x * (code_at(words[u], 0) * sk);
                d1 += a.y * (code_at(words[u], 1) * sk);
                d2 += a.z * (code_at(words[u], 2) * sk);
                d3 += a.w * (code_at(words[u], 3) * sk);
              }
            }
          } else if constexpr (kBf16) {
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
        for (int k = 0; k < nk; ++k) {
          const float pk = __shfl_sync(kFull, p, k);
          const E* vr = vs + k * D;
          if constexpr (kInt8) {
            const float svk = __shfl_sync(kFull, sv, k);
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              const int d = lane + 32 * e;
              if (d < D)
                acc[rr][e] += pk * (widen(vr[d]) * svk);
            }
          } else {
#pragma unroll
            for (int e = 0; e < DPL; ++e) {
              const int d = lane + 32 * e;
              if (d < D) acc[rr][e] += pk * widen(vr[d]);
            }
          }
        }
      }
    }
    __syncthreads();         // buffer `buf` free for tile t+2's copies
  }

#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < nq) {
      const float denom = l[rr] > 0.f ? l[rr] : 1.f;
      Q* orow = out + (bh * Lq + q0 + r) * D;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) narrow(orow + d, acc[rr][e] / denom);
      }
    }
  }
}

template <typename E, typename Q, int DPL>
int launch_v1(const Q* q, const E* k_pool, const E* v_pool,
              const float* k_scale, const float* v_scale, const int* tables,
              const int* positions, Q* out, int B, int H, int Lq, int D,
              int T, int bs, int pool_rows, int num_blocks, int block_q,
              float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(block_q) * D +
      sizeof(E) * (2 * static_cast<size_t>(kKeyTile) *
                       (D + kKPadBytes / sizeof(E)) +
                   2 * static_cast<size_t>(kKeyTile) * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<E, Q, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Lq + block_q - 1) / block_q, H, B);
  paged_attention_kernel<E, Q, DPL><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, k_scale, v_scale, tables, positions, out, H, Lq,
      D, T, bs, pool_rows, num_blocks, block_q, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, typename Q>
int dispatch_v1(const Q* q, const E* k_pool, const E* v_pool,
                const float* k_scale, const float* v_scale,
                const int* tables, const int* positions, Q* out, int B,
                int H, int Lq, int D, int T, int bs, int pool_rows,
                int num_blocks, int block_q, float scale,
                cudaStream_t stream) {
  if (D <= 32)
    return launch_v1<E, Q, 1>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              positions, out, B, H, Lq, D, T, bs, pool_rows,
                              num_blocks, block_q, scale, stream);
  if (D <= 64)
    return launch_v1<E, Q, 2>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              positions, out, B, H, Lq, D, T, bs, pool_rows,
                              num_blocks, block_q, scale, stream);
  if (D <= 128)
    return launch_v1<E, Q, 4>(q, k_pool, v_pool, k_scale, v_scale, tables,
                              positions, out, B, H, Lq, D, T, bs, pool_rows,
                              num_blocks, block_q, scale, stream);
  return launch_v1<E, Q, 8>(q, k_pool, v_pool, k_scale, v_scale, tables,
                            positions, out, B, H, Lq, D, T, bs, pool_rows,
                            num_blocks, block_q, scale, stream);
}

// ---------------------------------------------------------------------------
// decode and tile: shared staging
// ---------------------------------------------------------------------------
constexpr int kTileKeys = 64;       // tile: keys a stage
constexpr int kDecodeStages = 2;    // stage buffers: copies run this many
constexpr int kTileStages = 2;      // stages minus one ahead

// decode: keys a stage, 32 KB of K and V at D 64 in every dtype
template <typename E>
__host__ __device__ constexpr int decode_keys() {
  return sizeof(E) == 4 ? 64 : 128;
}

// One stage of KS keys: K rows, then V rows, each DP elements (D
// zero-padded to 64 or 128) plus 16 bytes; int8: then the keys' K and V
// scales, KS floats each.
template <typename E, int DP, int KS>
struct Stage {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(E));
  static constexpr int kChunks = DP / kVec;         // copies a padded row
  static constexpr int kRow = DP + kVec;            // row stride, elements
  static constexpr int kStep = kThreads / kChunks;  // keys a copy round
  static constexpr bool kScales = std::is_same<E, int8_t>::value;
  static constexpr int kBytes = 2 * KS * kRow * static_cast<int>(sizeof(E)) +
                                (kScales ? 2 * KS * 4 : 0);
  static_assert(kThreads % kChunks == 0 && KS % kStep == 0,
                "whole copy rounds");
};

__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes));
}

// Start the copies of keys [base, base + KS) of one (sequence, head) into
// stage buffer `buf` as one commit group; keys at or past n_keys and the
// columns past D are zero-filled.  Thread i copies chunk i % kChunks of
// keys i / kChunks + j * kStep, walking the block table with one division
// a stage.
template <typename E, int DP, int KS>
__device__ __forceinline__ void load_stage(char* buf, const E* kh,
                                           const E* vh, const float* skh,
                                           const float* svh, const int* tbl,
                                           int base, int n_keys, int D,
                                           int bs) {
  using S = Stage<E, DP, KS>;
  const int c = threadIdx.x % S::kChunks;
  const int k0 = threadIdx.x / S::kChunks;
  const bool col_ok = c < D / S::kVec;
  E* ks = reinterpret_cast<E*>(buf);
  E* vs = ks + KS * S::kRow;
  int blk = (base + k0) / bs;
  int off = base + k0 - blk * bs;
#pragma unroll
  for (int j = 0; j < KS / S::kStep; ++j) {
    const int k = k0 + j * S::kStep;
    const bool key_ok = base + k < n_keys;
    const int phys = key_ok ? tbl[blk] : 0;
    const bool ok = key_ok && col_ok;
    const size_t src =
        ok ? (static_cast<size_t>(phys) * bs + off) * D + S::kVec * c : 0;
    cp_async16_zfill(ks + k * S::kRow + S::kVec * c, kh + src, ok ? 16 : 0);
    cp_async16_zfill(vs + k * S::kRow + S::kVec * c, vh + src, ok ? 16 : 0);
    if constexpr (S::kScales) {
      if (c == 0) {
        float* sc = reinterpret_cast<float*>(vs + KS * S::kRow);
        cp_async4_zfill(sc + k, skh + phys, key_ok ? 4 : 0);
        cp_async4_zfill(sc + KS + k, svh + phys, key_ok ? 4 : 0);
      }
    }
    off += S::kStep;
    while (off >= bs) {
      off -= bs;
      ++blk;
    }
  }
  cp_async_commit();
}

// the code in byte e of a word whose bytes were XORed with 0x80, widened
// to fp32 without an int -> float conversion: 2^23 + (c + 128) as float
// bits, minus 2^23 + 128 (exact)
__device__ __forceinline__ float widen_code(uint32_t biased, int e) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + e)) -
         8388736.0f;
}

// 4 consecutive int8 codes from shared memory, widened to fp32 (load4's
// int8 overload)
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  return make_float4(widen_code(w, 0), widen_code(w, 1), widen_code(w, 2),
                     widen_code(w, 3));
}

// ---------------------------------------------------------------------------
// decode: CUDA cores, every warp on its own keys of each stage
// ---------------------------------------------------------------------------
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
    } else if constexpr (std::is_same<E, __nv_bfloat16>::value) {
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
    } else {
      const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                 w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a = q4[4 * ci + u];
        d0 += a.x * widen_code(words[u], 0);
        d1 += a.y * widen_code(words[u], 1);
        d2 += a.z * widen_code(words[u], 2);
        d3 += a.w * widen_code(words[u], 3);
      }
    }
  }
  return (d0 + d1) + (d2 + d3);
}

// One query row a CTA.  E: pool element; Q: q and out element; DP: D
// zero-padded (64 or 128).
template <typename E, typename Q, int DP>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const Q* __restrict__ q, const E* __restrict__ k_pool,
    const E* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, Q* __restrict__ out, int H, int Lq,
    int D, int T, int bs, int pool_rows, int num_blocks, float scale) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
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
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qpos = positions[b] + r;       // the row's global position
  const int n_keys = min(qpos + 1, T * bs);
  const int n_stages = (n_keys + KS - 1) / KS;
  const E* kh = k_pool + static_cast<size_t>(h) * pool_rows * D;
  const E* vh = v_pool + static_cast<size_t>(h) * pool_rows * D;
  const float* skh = kInt8 ? k_scale + static_cast<size_t>(h) * num_blocks
                           : nullptr;
  const float* svh = kInt8 ? v_scale + static_cast<size_t>(h) * num_blocks
                           : nullptr;
  const int* tbl = tables + static_cast<size_t>(b) * T;

  // the first stages, a commit group each (empty past the last stage, so
  // that the wait below always leaves kDecodeStages - 1 groups in flight)
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) {
    if (s < n_stages)
      load_stage<E, DP, KS>(stages + s * S::kBytes, kh, vh, skh, svh, tbl,
                            s * KS, n_keys, D, bs);
    else
      cp_async_commit();
  }
  const size_t row = (static_cast<size_t>(b) * H + h) * Lq + r;
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
                            vh, skh, svh, tbl, ahead * KS, n_keys, D, bs);
    else
      cp_async_commit();
    cp_async_wait<kDecodeStages - 1>();   // stage st has landed
    __syncthreads();         // stage st (and q) visible to every warp
    const E* ks = reinterpret_cast<const E*>(
        stages + st % kDecodeStages * S::kBytes);
    const E* vs = ks + KS * S::kRow;
    const float* sks = reinterpret_cast<const float*>(vs + KS * S::kRow);
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
      float s = kNeg;
      if (vis) s = (kInt8 ? d * sks[key] : d) * scale;
      float mx = s;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m, mx);
      const float p = vis ? expf(s - m_new) : 0.f;
      const float alpha = expf(m - m_new);
      l = l * alpha + p;                       // this lane's key's share
      m = m_new;
      const float pv = kInt8 ? p * sks[KS + key] : p;
      acc.x *= alpha;
      acc.y *= alpha;
      acc.z *= alpha;
      acc.w *= alpha;
#pragma unroll
      for (int j = 0; j < 16 / KG; ++j) {
        const int kk = kg + KG * j;
        const float4 v = load4(vs + (kb + kk) * S::kRow + 4 * cg);
        const float pk = __shfl_sync(kFull, pv, kk);
        acc.x += pk * v.x;
        acc.y += pk * v.y;
        acc.z += pk * v.z;
        acc.w += pk * v.w;
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

template <typename E, typename Q, int DP>
int launch_decode(const Q* q, const E* k_pool, const E* v_pool,
                  const float* k_scale, const float* v_scale,
                  const int* tables, const int* positions, Q* out, int B,
                  int H, int Lq, int D, int T, int bs, int pool_rows,
                  int num_blocks, float scale, cudaStream_t stream) {
  using S = Stage<E, DP, decode_keys<E>()>;
  const size_t smem = sizeof(float) * DP + kDecodeStages * S::kBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<E, Q, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Lq, H, B);
  paged_decode_kernel<E, Q, DP><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, k_scale, v_scale, tables, positions, out, H, Lq, D,
      T, bs, pool_rows, num_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// tile: tensor cores, the query rows as the mma's M
// ---------------------------------------------------------------------------
// an int8 code as the fp32 bits the TF32 mma reads exactly
__device__ __forceinline__ uint32_t code_tf32(int8_t c) {
  return __float_as_uint(static_cast<float>(c));
}

// tile: floats of a warp's partial (o, m, l) a lane
template <int DP>
__host__ __device__ constexpr int tile_part_floats() {
  return 4 * (DP / 8) + 4;
}

// E: pool element; Q: q and out element (float, or bf16 with bf16
// pools); DP: D zero-padded (64 or 128).
template <typename E, typename Q, int DP>
__global__ void __launch_bounds__(kThreads) paged_tile_kernel(
    const Q* __restrict__ q, const E* __restrict__ k_pool,
    const E* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ positions, Q* __restrict__ out, int H, int Lq,
    int D, int T, int bs, int pool_rows, int num_blocks, int block_q,
    float scale) {
  constexpr bool kInt8 = std::is_same<E, int8_t>::value;
  constexpr bool kBf16 = std::is_same<E, __nv_bfloat16>::value;
  using S = Stage<E, DP, kTileKeys>;
  constexpr int KSTEPS = kBf16 ? DP / 16 : DP / 8;   // Q K^T k-steps
  constexpr int NO = DP / 8;                         // output n-blocks
  constexpr int kNC = NO < 8 ? NO : 8;               // P.V n-blocks a pass
  // TF32: Q's hi/lo A fragments in registers up to D 64, else in shared
  // memory, each lane's own
  constexpr bool kQSmem = !kBf16 && DP > 64;
  constexpr int kQR = kQSmem ? 1 : KSTEPS;
  constexpr int kPart = tile_part_floats<DP>();
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, Lq - q0);
  const int rbs = nq > 16 ? 2 : 1;       // 16-row blocks of the CTA
  const int rb = warp % rbs;             // the warp's row block
  const int kparts = kWarps / rbs;       // warps that share a row block
  const int kp = warp / rbs;             // the warp's part of each stage
  const int kw = kTileKeys / kparts;     // its keys of a stage: 32 or 16
  const int nbw = kw / 8;                // its 8-key blocks: 4 or 2
  const int kb = kp * kw;                // its first key in a stage
  const int r0 = 16 * rb;                // its first row in the CTA
  const int ofs = positions[b];
  const int row_pos0 = ofs + q0 + r0;    // global position of row r0
  const int n_keys = min(ofs + q0 + nq, T * bs);
  const int warp_keys = min(ofs + q0 + min(r0 + 16, nq), n_keys);
  const int n_stages = (n_keys + kTileKeys - 1) / kTileKeys;
  const E* kh = k_pool + static_cast<size_t>(h) * pool_rows * D;
  const E* vh = v_pool + static_cast<size_t>(h) * pool_rows * D;
  const float* skh = kInt8 ? k_scale + static_cast<size_t>(h) * num_blocks
                           : nullptr;
  const float* svh = kInt8 ? v_scale + static_cast<size_t>(h) * num_blocks
                           : nullptr;
  const int* tbl = tables + static_cast<size_t>(b) * T;

#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {   // as in the decode body
    if (s < n_stages)
      load_stage<E, DP, kTileKeys>(smem + s * S::kBytes, kh, vh, skh, svh,
                                   tbl, s * kTileKeys, n_keys, D, bs);
    else
      cp_async_commit();
  }

  // Q's A fragments, rows r0 + (g, g+8); zero past nq rows and D columns
  const size_t bh = static_cast<size_t>(b) * H + h;
  const Q* qg = q + (bh * Lq + q0) * D;
  uint32_t qhi[kQR][4], qlo[kBf16 ? 1 : kQR][4];
  uint4* qfrag = reinterpret_cast<uint4*>(smem + kTileStages * S::kBytes) +
                 warp * KSTEPS * 64 + lane;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    if constexpr (kBf16) {
      // a0 (g, 16s+2t..), a1 (g+8, ..), a2 (g, 16s+2t+8..), a3 (g+8, ..)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e & 1);
        const int col = 16 * s + 2 * t + 8 * (e >> 1);
        qhi[s][e] = row < nq && col < D
                        ? *reinterpret_cast<const uint32_t*>(qg + row * D + col)
                        : 0u;
      }
    } else {
      // a0 (g, 8s+t), a1 (g+8, 8s+t), a2 (g, 8s+t+4), a3 (g+8, 8s+t+4)
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e & 1);
        const int col = 8 * s + t + 4 * (e >> 1);
        const float x = row < nq && col < D ? qg[row * D + col] : 0.f;
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

  for (int st = 0; st < n_stages; ++st) {
    const int ahead = st + kTileStages - 1;
    if (ahead < n_stages)    // into the buffer stage st - 1 freed
      load_stage<E, DP, kTileKeys>(smem + ahead % kTileStages * S::kBytes, kh,
                                   vh, skh, svh, tbl, ahead * kTileKeys,
                                   n_keys, D, bs);
    else
      cp_async_commit();
    cp_async_wait<kTileStages - 1>();     // stage st has landed
    __syncthreads();         // stage st visible to every warp
    const int k0 = st * kTileKeys + kb;   // position of the warp's key 0
    const int nvis = min(kw, warp_keys - k0);
    if (nvis > 0) {          // uniform across the warp
      const int jn = (nvis + 7) / 8;      // 8-key blocks the warp sees
      const E* stage =
          reinterpret_cast<const E*>(smem + st % kTileStages * S::kBytes);
      const E* ks = stage + kb * S::kRow;
      const E* vs = ks + kTileKeys * S::kRow;
      const float* sks = reinterpret_cast<const float*>(
                             stage + 2 * kTileKeys * S::kRow) + kb;
      const float* svs = sks + kTileKeys;

      // S = Q K^T
      float sc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        if constexpr (kBf16) {
          // B: key 8j + g, columns 16s + 2t.. and 16s + 2t + 8..
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < jn) {
              const uint32_t* kr = reinterpret_cast<const uint32_t*>(
                  ks + (8 * j + g) * S::kRow + 16 * s + 2 * t);
              mma_bf16(sc[j], qhi[s], kr[0], kr[4]);
            }
          }
        } else {
          uint32_t ah[4], al[4];
          if constexpr (kQSmem) {
            const uint4 x = qfrag[64 * s], y = qfrag[64 * s + 32];
            ah[0] = x.x, ah[1] = x.y, ah[2] = x.z, ah[3] = x.w;
            al[0] = y.x, al[1] = y.y, al[2] = y.z, al[3] = y.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ah[e] = qhi[s][e];
              al[e] = qlo[s][e];
            }
          }
          // B: key 8j + g, columns 8s + t and 8s + t + 4
          uint32_t kbh[4][2], kbl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < jn) {
              const E* kr = ks + (8 * j + g) * S::kRow + 8 * s + t;
              if constexpr (kInt8) {
                kbh[j][0] = code_tf32(kr[0]);
                kbh[j][1] = code_tf32(kr[4]);
              } else {
                split_tf32(kr[0], kbh[j][0], kbl[j][0]);
                split_tf32(kr[4], kbh[j][1], kbl[j][1]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < jn) mma_tf32(sc[j], al, kbh[j][0], kbh[j][1]);
          if constexpr (!kInt8) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (j < jn) mma_tf32(sc[j], ah, kbl[j][0], kbl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < jn) mma_tf32(sc[j], ah, kbh[j][0], kbh[j][1]);
        }
      }

      // the keys' scales (int8), the scale; the mask where the warp's
      // slice crosses a row's frontier or the end of the keys (bit 4j +
      // e: score (j, e) visible); the new row max
      const bool edge = k0 + kw - 1 > row_pos0 || k0 + kw > n_keys;
      uint32_t vis = 0xffffu;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nbw) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * j + 2 * t + (e & 1);
            float s = sc[j][e];
            if constexpr (kInt8) s *= sks[key];
            s *= scale;
            if (edge) {
              const int kpos = k0 + key;
              if (kpos > row_pos0 + g + 8 * (e >> 1) || kpos >= n_keys) {
                s = kNeg;
                vis &= ~(1u << (4 * j + e));
              }
            }
            sc[j][e] = s;
            mx[e >> 1] = fmaxf(mx[e >> 1], s);
          }
        }
      }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < nbw) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                (vis >> (4 * j + e)) & 1u ? expf(sc[j][e] - m[e >> 1]) : 0.f;
            sc[j][e] = p;
            rsum[e >> 1] += p;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rsum[r];

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
          for (int jj = 0; jj < 2; ++jj) {
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
                                    8 * ((lane >> 3) & 1)) * S::kRow +
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
          // key 2t of block j is the mma's k = t, key 2t+1 its k = t + 4,
          // in A (P from S's C fragment) and in B (V rows) alike
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < jn) {
              // a0 P(g, 2t), a1 P(g+8, 2t), a2 P(g, 2t+1), a3 P(g+8, 2t+1)
              float p0 = sc[j][0], p1 = sc[j][2], p2 = sc[j][1],
                    p3 = sc[j][3];
              if constexpr (kInt8) {
                const float s0 = svs[8 * j + 2 * t];
                const float s1 = svs[8 * j + 2 * t + 1];
                p0 *= s0;
                p1 *= s0;
                p2 *= s1;
                p3 *= s1;
              }
              uint32_t ph[4], pl[4];
              split_tf32(p0, ph[0], pl[0]);
              split_tf32(p1, ph[1], pl[1]);
              split_tf32(p2, ph[2], pl[2]);
              split_tf32(p3, ph[3], pl[3]);
              // b0 V(8j + 2t, col), b1 V(8j + 2t + 1, col), col 8n + g
              const E* v0 = vs + (8 * j + 2 * t) * S::kRow + g;
              uint32_t vbh[kNC][2], vbl[kNC][2];
#pragma unroll
              for (int c = 0; c < kNC; ++c) {
                if constexpr (kInt8) {
                  vbh[c][0] = code_tf32(v0[8 * (n0 + c)]);
                  vbh[c][1] = code_tf32(v0[S::kRow + 8 * (n0 + c)]);
                } else {
                  split_tf32(v0[8 * (n0 + c)], vbh[c][0], vbl[c][0]);
                  split_tf32(v0[S::kRow + 8 * (n0 + c)], vbh[c][1],
                             vbl[c][1]);
                }
              }
#pragma unroll
              for (int c = 0; c < kNC; ++c)
                mma_tf32(pv[c], pl, vbh[c][0], vbh[c][1]);
              if constexpr (!kInt8) {
#pragma unroll
                for (int c = 0; c < kNC; ++c)
                  mma_tf32(pv[c], ph, vbl[c][0], vbl[c][1]);
              }
#pragma unroll
              for (int c = 0; c < kNC; ++c)
                mma_tf32(pv[c], ph, vbh[c][0], vbh[c][1]);
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
    __syncthreads();         // the buffer free for the next copies
  }

  // the row sums of the 4 lanes of a row, in the same order on each
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  // the warps of parts 1.. leave (o, m, l) in the free stages, each lane
  // its own fragment; the part-0 warp of each row block merges them in
  // part order and writes the rows
  float* part = reinterpret_cast<float*>(smem) + lane;
  if (kp > 0) {
    float* my = part + warp * kPart * 32;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) my[(4 * n + e) * 32] = o[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      my[(4 * NO + r) * 32] = m[r];
      my[(4 * NO + 2 + r) * 32] = l[r];
    }
  }
  __syncthreads();
  if (kp > 0) return;
  float mx[2] = {m[0], m[1]};
  for (int k = 1; k < kparts; ++k) {
    const float* pt = part + (warp + k * rbs) * kPart * 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(mx[r], pt[(4 * NO + r) * 32]);
  }
  float f[2], lsum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    f[r] = expf(m[r] - mx[r]);
    lsum[r] = l[r] * f[r];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= f[e >> 1];
  for (int k = 1; k < kparts; ++k) {
    const float* pt = part + (warp + k * rbs) * kPart * 32;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      f[r] = expf(pt[(4 * NO + r) * 32] - mx[r]);
      lsum[r] += pt[(4 * NO + 2 + r) * 32] * f[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] += pt[(4 * n + e) * 32] * f[e >> 1];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row < nq) {
      const float denom = lsum[r] > 0.f ? lsum[r] : 1.f;
      Q* orow = out + (bh * Lq + q0 + row) * D;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const int col = 8 * n + 2 * t;     // D even: col + 1 < D too
        if (col < D)
          store2(orow + col, o[n][2 * r] / denom, o[n][2 * r + 1] / denom);
      }
    }
  }
}

template <typename E, typename Q, int DP>
int launch_tile(const Q* q, const E* k_pool, const E* v_pool,
                const float* k_scale, const float* v_scale,
                const int* tables, const int* positions, Q* out, int B, int H,
                int Lq, int D, int T, int bs, int pool_rows, int num_blocks,
                int block_q, float scale, cudaStream_t stream) {
  using S = Stage<E, DP, kTileKeys>;
  constexpr bool kQSmem = !std::is_same<E, __nv_bfloat16>::value && DP > 64;
  // the stages (after the loop: the warps' partials); TF32 at D > 64:
  // then Q's fragments
  constexpr int kParts = 4 * kWarps * 32 * tile_part_floats<DP>();
  const size_t smem =
      (kTileStages * S::kBytes > kParts ? kTileStages * S::kBytes
                                        : kParts) +
      (kQSmem ? sizeof(uint4) * 64 * kWarps * (DP / 8) : 0);
  static_assert(kParts <= kTileStages * S::kBytes || !kQSmem,
                "the partials end before Q's fragments");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_tile_kernel<E, Q, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Lq + block_q - 1) / block_q, H, B);
  paged_tile_kernel<E, Q, DP><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, k_scale, v_scale, tables, positions, out, H, Lq, D,
      T, bs, pool_rows, num_blocks, block_q, scale);
  return static_cast<int>(cudaGetLastError());
}

// One launch of `path` with `block_q` query rows a CTA; refuses a pair
// the shape does not allow.
template <typename E, typename Q>
int run(int path, int block_q, const Q* q, const E* k_pool, const E* v_pool,
        const float* k_scale, const float* v_scale, const int* tables,
        const int* positions, Q* out, int B, int H, int Lq, int D, int T,
        int bs, int pool_rows, float scale, cudaStream_t stream) {
  constexpr int kMult = std::is_same<E, float>::value ? 4
                        : std::is_same<E, int8_t>::value ? 16 : 8;
  if (B <= 0 || H <= 0 || Lq <= 0)
    return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % kMult != 0 || T <= 0 || bs <= 0 ||
      pool_rows % bs != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nb = pool_rows / bs;
  if (path == kPathV1 && block_q >= 1 && block_q <= kMaxBlockQ)
    return dispatch_v1<E, Q>(q, k_pool, v_pool, k_scale, v_scale, tables,
                             positions, out, B, H, Lq, D, T, bs, pool_rows,
                             nb, block_q, scale, stream);
  if (path == kPathDecode && D <= 128 && block_q == 1) {
    if (D <= 64)
      return launch_decode<E, Q, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                     tables, positions, out, B, H, Lq, D, T,
                                     bs, pool_rows, nb, scale, stream);
    return launch_decode<E, Q, 128>(q, k_pool, v_pool, k_scale, v_scale,
                                    tables, positions, out, B, H, Lq, D, T,
                                    bs, pool_rows, nb, scale, stream);
  }
  if (path == kPathTile && D <= 128 && (block_q == 16 || block_q == 32)) {
    if (D <= 64)
      return launch_tile<E, Q, 64>(q, k_pool, v_pool, k_scale, v_scale,
                                   tables, positions, out, B, H, Lq, D, T,
                                   bs, pool_rows, nb, block_q, scale, stream);
    return launch_tile<E, Q, 128>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                  positions, out, B, H, Lq, D, T, bs,
                                  pool_rows, nb, block_q, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, H, Lq, D), pools (H, pool_rows, D), tables (B, T) and positions
// (B,) int32, out like q; all contiguous.  path 0 v1, 1 decode, 2 tile.
extern "C" int mxt_paged_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* tables, const int* positions, float* out, int B, int H,
    int Lq, int D, int T, int bs, int pool_rows, float scale, int path,
    int block_q, cudaStream_t stream) {
  return run<float, float>(path, block_q, q, k_pool, v_pool, nullptr,
                           nullptr, tables, positions, out, B, H, Lq, D, T,
                           bs, pool_rows, scale, stream);
}

// bf16 q, pools and out; D % 8 == 0.
extern "C" int mxt_paged_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k_pool,
    const __nv_bfloat16* v_pool, const int* tables, const int* positions,
    __nv_bfloat16* out, int B, int H, int Lq, int D, int T, int bs,
    int pool_rows, float scale, int path, int block_q, cudaStream_t stream) {
  return run<__nv_bfloat16, __nv_bfloat16>(
      path, block_q, q, k_pool, v_pool, nullptr, nullptr, tables, positions,
      out, B, H, Lq, D, T, bs, pool_rows, scale, stream);
}

// The kv_scales variant: k_pool/v_pool int8 codes (H, pool_rows, D),
// k_scale/v_scale (H, pool_rows / bs) fp32; fp32 q and out; D % 16 == 0.
extern "C" int mxt_paged_attention_i8(
    const float* q, const int8_t* k_pool, const int8_t* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* positions, float* out, int B, int H, int Lq, int D, int T,
    int bs, int pool_rows, float scale, int path, int block_q,
    cudaStream_t stream) {
  return run<int8_t, float>(path, block_q, q, k_pool, v_pool, k_scale,
                            v_scale, tables, positions, out, B, H, Lq, D, T,
                            bs, pool_rows, scale, stream);
}
