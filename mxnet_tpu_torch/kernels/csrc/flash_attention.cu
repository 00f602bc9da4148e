// Flash attention forward for Hopper (sm_90a), fp32, over contiguous
// [B, H, L, D] tensors: causal or not, and offset-causal.
//
// Replaces two TPU kernels of mxnet_tpu/pallas_ops/flash_attention.py:
//  * _fa_kernel (the forward of flash_attention; its backward is XLA
//    code there and plain PyTorch in the port).  Query row i attends to
//    key j when the mask allows it (causal: i >= j, top-left aligned as
//    in the TPU kernel);
//  * _fa_offset_kernel (flash_attention_offset, the contiguous serving
//    plane's decode attention).  Query row r of sequence b sits at
//    position offsets[b] + r of a [B, H, Lk, D] cache and attends to key
//    positions up to and including its own.
// Both keep the TPU kernels' semantics: s = (q . k) * scale, the scale
// after the product; masked scores are -1e30 and masked p is forced to
// 0; the online-softmax recurrence runs in fp32; the output is
// acc / (l > 0 ? l : 1).
//
// Two bodies, chosen by D in mxt_flash_attention_f32 alone:
//
// * v2, flash_attention with D <= 128: tensor-core tiles
//   (flash_attention_tc_kernel).  At the training shape (B16 H8 L256
//   D64, causal) the work is about 1.07 GFLOP against 33.5 MB of
//   q/k/v/out: at the TF32 rate, the card's peak for fp32 inputs, the
//   bytes bound it (0.0100 ms).  One TF32 pass keeps 10 mantissa bits
//   and misses the 1e-4 tolerance tenfold, and neither q, k, p nor v is
//   exact in TF32, so both products run in "3xTF32": x = hi + lo with
//   hi = tf32(x) and lo = x - hi (TF32 in the mma, see split_tf32), and
//   a . b ~ lo.hi + hi.lo + hi.hi, three mma.sync.m16n8k8 a k-step into
//   one fp32 accumulator (the lo.lo term is below fp32's rounding).
//   Splitting the operands, not the mma, sets the pace on the card, so
//   split_tf32 takes three full-rate ops an element.
//   - A CTA is 4 warps and 64 query rows, 16 a warp (the mma's M); the
//     grid is (B*H, ceil(Lq/64)), and in causal mode the last q tiles,
//     which see the most keys, launch first, so the causal tail does
//     not become one long last wave.
//   - Each warp splits its Q rows into hi/lo A fragments once and keeps
//     them in registers (D > 64: in shared memory, each lane's own).
//   - 64-key K/V tiles (32 for D > 64) stream through shared memory by
//     16-byte cp.async, double-buffered; rows are D zero-padded to a
//     multiple of 8 (the mma's k) plus 4 floats, which makes the
//     fragment reads free of bank conflicts; keys past the end are
//     zero-filled.  K and V are split into hi/lo as they are read into
//     fragments.
//   - S = Q K^T in 3xTF32, then the scale; the mask runs only on tiles
//     that cross the diagonal or the end of the keys, tiles wholly above
//     the diagonal are never read, and a warp skips the 8-key blocks
//     above its own rows.
//   - Online softmax in registers: a row's max reduces over the 4 lanes
//     that hold it in the C layout (shuffles xor 1 and 2); each lane
//     keeps a partial l, rescaled by the row's alpha, and the 4 partials
//     are added once at the end.
//   - P.V takes P from S's C fragments with no shared-memory round
//     trip.  The C fragment gives lane t (= lane % 4) keys 2t and 2t+1
//     of each 8-key block, the A fragment wants k indices t and t + 4:
//     key 2t is used as the mma's k = t and key 2t+1 as k = t + 4, and
//     V's B fragment is read with the same relabeling (rows 2t and 2t+1
//     of the block).  P.V sums over keys, so only the order of the
//     additions changes.  Each tile's P.V accumulates in fresh registers
//     and joins the output as acc * alpha + pv on the CUDA cores (the
//     TPU kernel's association, and an fp32 add that rounds to nearest).
//   - Fixed order everywhere, no atomics, no split of the keys: the same
//     inputs give the same bits on every launch.
//
// * v1, flash_attention_offset (every D) and flash_attention with D in
//   (128, 256]: CUDA cores (flash_attention_kernel).  No path of the
//   port runs the latter (the LM's D is 64).  At decode (Lq 1 over a
//   cache of up to 1024 keys) each key row read feeds 4*D flops, so the
//   cache's bytes bound it; an m16 tile would waste 15 of its 16 rows:
//   - one 128-thread block per (q-tile, b*h); a q-tile is up to 32 query
//     rows, warp w owning rows w, w+4, ..., w+28;
//   - a loop inside the block over 32-key tiles; in causal and offset
//     mode keys past the tile's last query position are never read,
//     which skips every tile that lies wholly above the (offset)
//     diagonal (the dynamic block skip of the offset kernel, :238, at
//     key granularity);
//   - all four warps stage each K/V tile with 16-byte cp.async copies,
//     double-buffered, K rows padded to D+4 floats;
//   - scores: lane k computes query-row . key-k; the output accumulator
//     is spread over the lanes, D/32 floats each; p is broadcast lane to
//     lane with shuffles for the P.V product.
//   `offsets` is null for flash_attention: the causal case is the one
//   where every offset is 0.
// Requires D % 4 == 0 (16-byte rows) and D <= 256.
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kKeyTile = 32;        // v1: keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kRowsPerWarp * kWarps;
constexpr int kKPad = 4;            // K row stride D + 4 floats

// ---------------------------------------------------------------------------
// v1: CUDA cores (flash_attention_offset; flash_attention with D > 128)
// ---------------------------------------------------------------------------
// DPL: head-dim elements each lane accumulates (D <= 32 * DPL).
template <int DPL>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ offsets,
    float* __restrict__ out, int H, int Lq, int Lk, int D, int causal,
    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int nq = min(kBlockQ, Lq - q0);
  const int D4 = D / 4;
  const int ks_stride = D + kKPad;

  // shared memory: Q [kBlockQ][D], then two stages of K [kKeyTile][D + 4]
  // followed by V [kKeyTile][D]
  float* qs = smem;
  float* stages = qs + kBlockQ * D;
  const int stage = kKeyTile * (ks_stride + D);

  // global position of query row 0: offsets[b] in offset mode (which
  // is causal), 0 otherwise
  const int ofs = offsets != nullptr ? offsets[bh / H] : 0;
  const bool masked = causal || offsets != nullptr;
  const int n_keys = masked ? min(ofs + q0 + nq, Lk) : Lk;
  const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile;
  const float* kh = k + bh * Lk * D;
  const float* vh = v + bh * Lk * D;

  // stage tile t's K and V rows: kKeyTile keys x D4 16-byte chunks each
  auto issue = [&](int t, int buf) {
    const int base = t * kKeyTile;
    const int nk = min(kKeyTile, n_keys - base);
    float* ks = stages + buf * stage;
    for (int i = threadIdx.x; i < nk * D4; i += kThreads) {
      const int kk = i / D4;
      const int c = i - kk * D4;
      const size_t row = static_cast<size_t>(base + kk);
      cp_async16(ks + kk * ks_stride + 4 * c, kh + row * D + 4 * c);
      cp_async16(ks + kKeyTile * ks_stride + kk * D + 4 * c,
                 vh + row * D + 4 * c);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) issue(0, 0);
  const float* qg = q + (bh * Lq + q0) * D;
  for (int i = threadIdx.x; i < nq * D; i += kThreads) qs[i] = qg[i];

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
    const float* ks = stages + buf * stage;
    const float* vs = ks + kKeyTile * ks_stride;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r < nq) {                          // uniform across the warp
        const int qpos = ofs + q0 + r;
        const bool vis = lane < nk && (!masked || qpos >= kpos);
        float s = kNeg;
        if (lane < nk) {
          const float4* q4 = reinterpret_cast<const float4*>(qs + r * D);
          const float4* k4 =
              reinterpret_cast<const float4*>(ks + lane * ks_stride);
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          for (int j = 0; j < D4; ++j) {
            const float4 a = q4[j];
            const float4 c = k4[j];
            d0 += a.x * c.x;
            d1 += a.y * c.y;
            d2 += a.z * c.z;
            d3 += a.w * c.w;
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
          const float* vr = vs + kk * D;
#pragma unroll
          for (int e = 0; e < DPL; ++e) {
            const int d = lane + 32 * e;
            if (d < D) acc[rr][e] += pk * vr[d];
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
      float* orow = out + (bh * Lq + q0 + r) * D;
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) orow[d] = acc[rr][e] / denom;
      }
    }
  }
}

template <int DPL>
int launch(const float* q, const float* k, const float* v,
           const int* offsets, float* out, int BH, int H, int Lq, int Lk,
           int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBlockQ) * D +
                       2 * static_cast<size_t>(kKeyTile) * (D + kKPad) +
                       2 * static_cast<size_t>(kKeyTile) * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Lq + kBlockQ - 1) / kBlockQ, BH);
  flash_attention_kernel<DPL><<<grid, kThreads, smem, stream>>>(
      q, k, v, offsets, out, H, Lq, Lk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* q, const float* k, const float* v,
             const int* offsets, float* out, int BH, int H, int Lq, int Lk,
             int D, int causal, float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<1>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal, scale,
                     stream);
  if (D <= 64)
    return launch<2>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal, scale,
                     stream);
  if (D <= 128)
    return launch<4>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal, scale,
                     stream);
  return launch<8>(q, k, v, offsets, out, BH, H, Lq, Lk, D, causal, scale,
                   stream);
}


// ---------------------------------------------------------------------------
// v2: tensor cores in 3xTF32 (flash_attention with D <= 128)
// ---------------------------------------------------------------------------
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcBlockQ = 16 * kTcWarps;   // 16 query rows a warp (mma M)

// KSTEPS: k-steps of 8 over the zero-padded head dim (D <= 8 * KSTEPS);
// KT: keys a shared-memory tile.
template <int KSTEPS, int KT>
__global__ void __launch_bounds__(kTcThreads) flash_attention_tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Lq, int Lk,
    int D, int causal, float scale) {
  constexpr int DP = 8 * KSTEPS;          // D zero-padded to the mma's k
  constexpr int kStride = DP + 4;         // floats a K/V row in smem
  constexpr int kStage = 2 * KT * kStride;  // K tile, then V tile
  constexpr int NB = KT / 8;              // 8-key blocks a tile
  constexpr int kChunks = DP / 4;         // 16-byte chunks a row
  // Q's hi/lo A fragments: in registers up to D 64, else in shared
  // memory, each lane's own (registers: D 128 spilled)
  constexpr bool kQRegs = KSTEPS <= 8;
  constexpr int kQH = kQRegs ? KSTEPS : 1;
  constexpr int kNC = KSTEPS < 8 ? KSTEPS : 8;  // P.V's n-blocks a pass
  static_assert(KT * kChunks % kTcThreads == 0, "whole copy rounds");
  static_assert(NB * 4 <= 32, "one visibility bit a score");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const size_t bh = blockIdx.x;
  const int qt = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y)
                       : static_cast<int>(blockIdx.y);
  const int q0 = qt * kTcBlockQ;
  const int r0 = q0 + 16 * warp;          // the warp's first query row
  // keys the CTA reads, and keys the warp's rows can see: [0, n)
  const int n_keys = causal ? min(min(q0 + kTcBlockQ, Lq), Lk) : Lk;
  const int warp_keys =
      r0 >= Lq ? 0 : causal ? min(min(r0 + 16, Lq), Lk) : Lk;
  const int n_tiles = (n_keys + KT - 1) / KT;
  const int D4 = D / 4;
  const float* kh = k + bh * Lk * D;
  const float* vh = v + bh * Lk * D;

  // stage tile `tile` in buffer `buf`: K rows, then V rows; keys past
  // n_keys and the columns past D are zero-filled
  auto load_tile = [&](int tile, int buf) {
    const int base = tile * KT;
    float* ks = smem + buf * kStage;
    float* vs = ks + KT * kStride;
#pragma unroll
    for (int it = 0; it < KT * kChunks / kTcThreads; ++it) {
      const int i = threadIdx.x + it * kTcThreads;
      const int r = i / kChunks;
      const int c = i % kChunks;
      const bool ok = base + r < n_keys && c < D4;
      const size_t off = ok ? static_cast<size_t>(base + r) * D + 4 * c : 0;
      cp_async16_zfill(ks + r * kStride + 4 * c, kh + off, ok ? 16 : 0);
      cp_async16_zfill(vs + r * kStride + 4 * c, vh + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  if (n_tiles > 0) load_tile(0, 0);

  // Q's A fragments, rows r0 + (g, g+8), columns 8s + (t, t+4)
  uint32_t qhi[kQH][4], qlo[kQH][4];
  // D > 64: k-step s's hi and lo of this lane at qfrag[64 s], [64 s + 32]
  uint4* qfrag = reinterpret_cast<uint4*>(smem + 2 * kStage) +
                 warp * KSTEPS * 64 + lane;
  const float* qg = q + bh * Lq * D;
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e & 1);
      const int col = 8 * s + t + 4 * (e >> 1);
      const float x =
          row < Lq && col < D ? qg[static_cast<size_t>(row) * D + col] : 0.f;
      split_tf32(x, hi[e], lo[e]);
    }
    if constexpr (kQRegs) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qhi[s][e] = hi[e];
        qlo[s][e] = lo[e];
      }
    } else {
      qfrag[64 * s] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      qfrag[64 * s + 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }

  // rows g and g+8 of the warp: running max, this lane's partial sum;
  // the output's C fragments, one per 8 columns
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float o[KSTEPS][4];
#pragma unroll
  for (int n = 0; n < KSTEPS; ++n)
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
      const float* ks = smem + buf * kStage;
      const float* vs = ks + KT * kStride;

      // S = Q K^T, 3xTF32
      float sc[NB][4];
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KSTEPS; ++s) {
        uint32_t ah[4], al[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qhi[s][e];
            al[e] = qlo[s][e];
          }
        } else {
          const uint4 h = qfrag[64 * s], w = qfrag[64 * s + 32];
          ah[0] = h.x, ah[1] = h.y, ah[2] = h.z, ah[3] = h.w;
          al[0] = w.x, al[1] = w.y, al[2] = w.z, al[3] = w.w;
        }
        // B: key 8j + g, columns 8s + t and 8s + t + 4
        uint32_t kb_hi[NB][2], kb_lo[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (j < jn) {
            const float* kr = ks + (8 * j + g) * kStride + 8 * s + t;
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

      // scale; mask where the tile crosses the diagonal or the end of
      // the keys (bit 4j + e: score (j, e) visible); the new row max
      const bool edge = k0 + KT > n_keys || (causal && k0 + KT - 1 > r0);
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
            if (kpos >= Lk || (causal && kpos > row)) {
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

      // O = O * alpha + P V, 3xTF32, kNC output n-blocks a pass.  Key
      // 2t of block j is the mma's k = t, key 2t+1 its k = t + 4, in A
      // (P from S's C fragment) and in B (V rows) alike.
#pragma unroll
      for (int n0 = 0; n0 < KSTEPS; n0 += kNC) {
        float pv[kNC][4];
#pragma unroll
        for (int c = 0; c < kNC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[c][e] = 0.f;
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
            const float* v0 = vs + (8 * j + 2 * t) * kStride + g;
            uint32_t vhi[kNC][2], vlo[kNC][2];
#pragma unroll
            for (int c = 0; c < kNC; ++c) {
              split_tf32(v0[8 * (n0 + c)], vhi[c][0], vlo[c][0]);
              split_tf32(v0[kStride + 8 * (n0 + c)], vhi[c][1], vlo[c][1]);
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
      float* orow = out + (bh * Lq + row) * D;
#pragma unroll
      for (int n = 0; n < KSTEPS; ++n) {
        const int col = 8 * n + 2 * t;     // D % 4 == 0: col + 1 < D too
        if (col < D)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
      }
    }
  }
}

template <int KSTEPS, int KT>
int launch_tc(const float* q, const float* k, const float* v, float* out,
              int BH, int Lq, int Lk, int D, int causal, float scale,
              cudaStream_t stream) {
  // two stages of K and V tiles; D > 64: the Q fragments
  const size_t smem = sizeof(float) * 2 * 2 * KT * (8 * KSTEPS + 4) +
                      (KSTEPS > 8 ? sizeof(uint4) * 64 * kTcWarps * KSTEPS
                                  : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<KSTEPS, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_qt = (Lq + kTcBlockQ - 1) / kTcBlockQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, n_qt);
  flash_attention_tc_kernel<KSTEPS, KT><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, out, Lq, Lk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B*H, Lq, D); k, v: (B*H, Lk, D); out like q.  All contiguous fp32.
// The one place that picks the body by D: v2 up to 128, v1 above.
extern "C" int mxt_flash_attention_f32(const float* q, const float* k,
                                       const float* v, float* out, int BH,
                                       int Lq, int Lk, int D, int causal,
                                       float scale, cudaStream_t stream) {
  if (BH <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % 4 != 0 || Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 16)
    return launch_tc<2, 64>(q, k, v, out, BH, Lq, Lk, D, causal, scale,
                            stream);
  if (D <= 32)
    return launch_tc<4, 64>(q, k, v, out, BH, Lq, Lk, D, causal, scale,
                            stream);
  if (D <= 64)
    return launch_tc<8, 64>(q, k, v, out, BH, Lq, Lk, D, causal, scale,
                            stream);
  if (D <= 128)
    return launch_tc<16, 32>(q, k, v, out, BH, Lq, Lk, D, causal, scale,
                             stream);
  return dispatch(q, k, v, nullptr, out, BH, 1, Lq, Lk, D, causal, scale,
                  stream);
}

// flash_attention_offset: q (B*H, Lq, D); k, v (B*H, Lk, D); offsets (B,)
// int32; out like q.  All contiguous (fp32 but the offsets).  v1 body.
extern "C" int mxt_flash_attention_offset_f32(
    const float* q, const float* k, const float* v, const int* offsets,
    float* out, int B, int H, int Lq, int Lk, int D, float scale,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % 4 != 0 || Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(q, k, v, offsets, out, B * H, H, Lq, Lk, D, 1, scale,
                  stream);
}
