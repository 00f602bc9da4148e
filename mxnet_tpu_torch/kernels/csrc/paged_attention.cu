// Paged flash attention forward for Hopper (sm_90a): fp32 pools, bf16
// pools (with bf16 q and output), and int8 code pools with per-(head,
// physical block) fp32 scales.
//
// Replaces the TPU kernel _paged_kernel of
// mxnet_tpu/pallas_ops/paged_attention.py, both of its variants
// (int8=False and int8=True).  Query row r of sequence b sits at global
// position positions[b] + r and attends, offset-causally, to every key
// position <= its own.  Logical key position p of sequence b lives at
// pool row tables[b, p / bs] * bs + p % bs of the per-head
// (H, pool_rows, D) K and V pools.
//
// Bound: bytes.  At decode (one query row) each key row read from the
// pool feeds 4*D flops, far below the card's flops-per-byte balance; at
// a 32-row prefill chunk the fp32 CUDA-core arithmetic comes closer but
// the pool reads still dominate.  So the design is about keeping pool
// reads in flight:
//  * one 128-thread block per (q-tile, head, sequence); a q-tile is up to
//    16 query rows, warp w owning rows w, w+4, w+8, w+12;
//  * the TPU's sequential grid axis over logical blocks becomes a loop
//    inside the block (on Hopper, blocks share no state), here over
//    32-key tiles of logical key positions.  Each key's pool row comes
//    from the block table (read by the block itself), so a tile may span
//    physical blocks and any block size works;
//  * all four warps stage each K/V tile with 16-byte cp.async copies,
//    double-buffered: tile t+1's copies are in flight while tile t is
//    computed.  K rows are padded by 16 bytes (4 floats, 8 bf16 values
//    or 16 int8 codes) so that lane k's 16-byte reads of key k are free
//    of bank conflicts;
//  * scores: lane k computes query-row . key-k; the online softmax keeps
//    m, l in fp32 registers per row and the output accumulator spread
//    over the lanes, D/32 floats each; p is broadcast lane to lane with
//    shuffles for the P.V product;
//  * int8 pools (the kv_scales variant) stage the codes, a quarter of
//    the fp32 bytes, and dequantize on the tile before any product, as
//    the TPU kernel does (:82-86): lane k looks up its key's scales
//    scale[h, tables[b, p / bs]] (per key, not per tile: a tile may span
//    two physical blocks), K codes become codes * scale_k before the dot
//    with q, and in the P.V loop each V code becomes code * scale_v of
//    its key, the scale shuffled from the key's lane;
//  * bf16 pools (the TPU kernel's tiles in bf16, widened at :79-81)
//    stage half the fp32 bytes with the same 16-byte copies, 8 values
//    each, and widen each key and value element to fp32 at its product
//    (a bf16 is the top half of an fp32, so widening is a shift); q is
//    widened into the fp32 Q tile once.  Scores, the online softmax
//    and the accumulator stay fp32, and the output is rounded to bf16
//    to nearest even (__float2bfloat16_rn), the TPU kernel's
//    astype(o_ref.dtype) at :108-109;
//  * semantics kept from the TPU kernel: keys past the tile's last query
//    position are never read (the dynamic block skip of
//    paged_attention.py:75, at key granularity: skipped keys would have
//    been masked); masked scores are -1e30 and masked p is forced to 0
//    (:93-98); the output is acc / (l > 0 ? l : 1) (:108-109).  Table
//    entries past the frontier point at the trash block 0; their keys are
//    always masked, so nothing from them leaks.
// Requires D <= 256 and a 16-byte row: D % 4 == 0 (fp32), D % 8 == 0
// (bf16) or D % 16 == 0 (int8).  No tensor cores and no split of one
// sequence's keys over several blocks: later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKeyTile = 32;        // keys per shared-memory tile: one a lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxBlockQ = kMaxRowsPerWarp * kWarps;
constexpr int kKPadBytes = 16;      // K row stride D * sizeof(E) + 16 bytes
constexpr float kNeg = -1e30f;      // the TPU kernel's mask constant
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// element loads widened to fp32, and the output narrowed to its type
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// bf16 element e (0: low half) of a little-endian word, widened
__device__ __forceinline__ float bf16_at(uint32_t word, int e) {
  return __uint_as_float(e == 0 ? word << 16 : word & 0xffff0000u);
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
int launch(const Q* q, const E* k_pool, const E* v_pool,
           const float* k_scale, const float* v_scale, const int* tables,
           const int* positions, Q* out, int B, int H, int Lq, int D,
           int T, int bs, int pool_rows, int num_blocks, float scale,
           cudaStream_t stream) {
  const int block_q = Lq < kMaxBlockQ ? Lq : kMaxBlockQ;
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
int dispatch(const Q* q, const E* k_pool, const E* v_pool,
             const float* k_scale, const float* v_scale, const int* tables,
             const int* positions, Q* out, int B, int H, int Lq, int D,
             int T, int bs, int pool_rows, int num_blocks, float scale,
             cudaStream_t stream) {
  if (D <= 32)
    return launch<E, Q, 1>(q, k_pool, v_pool, k_scale, v_scale, tables,
                           positions, out, B, H, Lq, D, T, bs, pool_rows,
                           num_blocks, scale, stream);
  if (D <= 64)
    return launch<E, Q, 2>(q, k_pool, v_pool, k_scale, v_scale, tables,
                           positions, out, B, H, Lq, D, T, bs, pool_rows,
                           num_blocks, scale, stream);
  if (D <= 128)
    return launch<E, Q, 4>(q, k_pool, v_pool, k_scale, v_scale, tables,
                           positions, out, B, H, Lq, D, T, bs, pool_rows,
                           num_blocks, scale, stream);
  return launch<E, Q, 8>(q, k_pool, v_pool, k_scale, v_scale, tables,
                         positions, out, B, H, Lq, D, T, bs, pool_rows,
                         num_blocks, scale, stream);
}

}  // namespace

extern "C" int mxt_paged_attention_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* tables, const int* positions, float* out, int B, int H,
    int Lq, int D, int T, int bs, int pool_rows, float scale,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Lq <= 0)
    return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % 4 != 0 || T <= 0 || bs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<float, float>(q, k_pool, v_pool, nullptr, nullptr,
                                tables, positions, out, B, H, Lq, D, T, bs,
                                pool_rows, pool_rows / bs, scale, stream);
}

// bf16 q, pools and out; D % 8 == 0.
extern "C" int mxt_paged_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k_pool,
    const __nv_bfloat16* v_pool, const int* tables, const int* positions,
    __nv_bfloat16* out, int B, int H, int Lq, int D, int T, int bs,
    int pool_rows, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Lq <= 0)
    return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % 8 != 0 || T <= 0 || bs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<__nv_bfloat16, __nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, tables, positions, out, B, H, Lq,
      D, T, bs, pool_rows, pool_rows / bs, scale, stream);
}

// The kv_scales variant: k_pool/v_pool int8 codes (H, pool_rows, D),
// k_scale/v_scale (H, pool_rows / bs) fp32; D % 16 == 0.
extern "C" int mxt_paged_attention_i8(
    const float* q, const int8_t* k_pool, const int8_t* v_pool,
    const float* k_scale, const float* v_scale, const int* tables,
    const int* positions, float* out, int B, int H, int Lq, int D, int T,
    int bs, int pool_rows, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Lq <= 0)
    return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % 16 != 0 || T <= 0 || bs <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t, float>(q, k_pool, v_pool, k_scale, v_scale,
                                 tables, positions, out, B, H, Lq, D, T, bs,
                                 pool_rows, pool_rows / bs, scale, stream);
}
