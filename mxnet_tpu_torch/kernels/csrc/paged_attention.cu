// Paged flash attention forward for Hopper (sm_90a), fp32 pools.
//
// Replaces the TPU kernel _paged_kernel (int8=False) of
// mxnet_tpu/pallas_ops/paged_attention.py.  Query row r of sequence b
// sits at global position positions[b] + r and attends, offset-causally,
// to every key position <= its own.  Logical key position p of sequence
// b lives at pool row tables[b, p / bs] * bs + p % bs of the per-head
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
//    computed.  K rows are padded to D+4 floats so that lane k's 16-byte
//    reads of key k are free of bank conflicts;
//  * scores: lane k computes query-row . key-k; the online softmax keeps
//    m, l in fp32 registers per row and the output accumulator spread
//    over the lanes, D/32 floats each; p is broadcast lane to lane with
//    shuffles for the P.V product;
//  * semantics kept from the TPU kernel: keys past the tile's last query
//    position are never read (the dynamic block skip of
//    paged_attention.py:75, at key granularity: skipped keys would have
//    been masked); masked scores are -1e30 and masked p is forced to 0
//    (:93-98); the output is acc / (l > 0 ? l : 1) (:108-109).  Table
//    entries past the frontier point at the trash block 0; their keys are
//    always masked, so nothing from them leaks.
// Requires D % 4 == 0 (16-byte rows) and D <= 256.  No tensor cores and
// no split of one sequence's keys over several blocks: later work.
#include <cuda_runtime.h>

namespace {

constexpr int kKeyTile = 32;        // keys per shared-memory tile: one a lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowsPerWarp = 4;
constexpr int kMaxBlockQ = kMaxRowsPerWarp * kWarps;
constexpr int kKPad = 4;            // K row stride D + 4 floats
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

// DPL: head-dim elements each lane accumulates (D <= 32 * DPL).
template <int DPL>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ tables,
    const int* __restrict__ positions, float* __restrict__ out, int H,
    int Lq, int D, int T, int bs, int pool_rows, int block_q,
    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * block_q;
  const int nq = min(block_q, Lq - q0);
  const int D4 = D / 4;
  const int ks_stride = D + kKPad;

  // shared memory: Q [block_q][D], then two stages of K [kKeyTile][D + 4]
  // followed by V [kKeyTile][D]
  float* qs = smem;
  float* stages = qs + block_q * D;
  const int stage = kKeyTile * (ks_stride + D);

  const int ofs = positions[b];
  const int q_last = ofs + q0 + nq - 1;   // global position, last row
  const int n_keys = min(q_last + 1, T * bs);
  const int n_tiles = (n_keys + kKeyTile - 1) / kKeyTile;
  const float* kh = k_pool + static_cast<size_t>(h) * pool_rows * D;
  const float* vh = v_pool + static_cast<size_t>(h) * pool_rows * D;
  const int* tbl = tables + static_cast<size_t>(b) * T;

  // stage tile t's K and V rows: kKeyTile keys x D4 16-byte chunks each
  auto issue = [&](int t, int buf) {
    const int base = t * kKeyTile;
    const int nk = min(kKeyTile, n_keys - base);
    for (int i = threadIdx.x; i < nk * D4; i += kThreads) {
      const int k = i / D4;
      const int c = i - k * D4;
      const int p = base + k;
      const size_t row =
          static_cast<size_t>(tbl[p / bs]) * bs + static_cast<size_t>(p % bs);
      float* ks = stages + buf * stage;
      cp_async16(ks + k * ks_stride + 4 * c, kh + row * D + 4 * c);
      cp_async16(ks + kKeyTile * ks_stride + k * D + 4 * c,
                 vh + row * D + 4 * c);
    }
    cp_async_commit();
  };

  issue(0, 0);
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* qg = q + (bh * Lq + q0) * D;
  for (int i = threadIdx.x; i < nq * D; i += kThreads) qs[i] = qg[i];

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
    const float* ks = stages + buf * stage;
    const float* vs = ks + kKeyTile * ks_stride;
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r < nq) {                          // uniform across the warp
        const int qpos = ofs + q0 + r;
        const bool vis = lane < nk && qpos >= kpos;
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
        for (int k = 0; k < nk; ++k) {
          const float pk = __shfl_sync(kFull, p, k);
          const float* vr = vs + k * D;
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
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
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
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int* tables, const int* positions, float* out, int B,
           int H, int Lq, int D, int T, int bs, int pool_rows, float scale,
           cudaStream_t stream) {
  const int block_q = Lq < kMaxBlockQ ? Lq : kMaxBlockQ;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(block_q) * D +
                       2 * static_cast<size_t>(kKeyTile) * (D + kKPad) +
                       2 * static_cast<size_t>(kKeyTile) * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Lq + block_q - 1) / block_q, H, B);
  paged_attention_kernel<DPL><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, tables, positions, out, H, Lq, D, T, bs,
      pool_rows, block_q, scale);
  return static_cast<int>(cudaGetLastError());
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
  if (D <= 32)
    return launch<1>(q, k_pool, v_pool, tables, positions, out, B, H, Lq,
                     D, T, bs, pool_rows, scale, stream);
  if (D <= 64)
    return launch<2>(q, k_pool, v_pool, tables, positions, out, B, H, Lq,
                     D, T, bs, pool_rows, scale, stream);
  if (D <= 128)
    return launch<4>(q, k_pool, v_pool, tables, positions, out, B, H, Lq,
                     D, T, bs, pool_rows, scale, stream);
  return launch<8>(q, k_pool, v_pool, tables, positions, out, B, H, Lq, D,
                   T, bs, pool_rows, scale, stream);
}
