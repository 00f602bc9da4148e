// Flash attention forward for Hopper (sm_90a), fp32, over contiguous
// [B, H, L, D] tensors, causal or not.
//
// Replaces the TPU kernel _fa_kernel of
// mxnet_tpu/pallas_ops/flash_attention.py (the forward of
// flash_attention; its backward is XLA code there and plain PyTorch in
// the port).  Query row i attends to key j when the mask allows it
// (causal: i >= j, top-left aligned as in the TPU kernel), with the
// online-softmax recurrence in fp32.
//
// Bound: at the training shape (B16 H8 L256 D64, causal) the work is
// about 1.07 GFLOP against 33.5 MB of q/k/v/out, so operations bound it
// on the fp32 CUDA cores.  This first version is written to be right
// and simple, in the layout of the port's paged kernel:
//  * one 128-thread block per (q-tile, b*h); a q-tile is up to 32 query
//    rows, warp w owning rows w, w+4, ..., w+28;
//  * the TPU's sequential k-block grid axis becomes a loop inside the
//    block over 32-key tiles; in causal mode keys past the tile's last
//    query row are never read, which skips every tile that lies wholly
//    above the diagonal (and the masked tail of the last one);
//  * all four warps stage each K/V tile with 16-byte cp.async copies,
//    double-buffered: tile t+1's copies are in flight while tile t is
//    computed.  K rows are padded to D+4 floats so lane k's 16-byte
//    reads of key k are free of bank conflicts;
//  * scores: lane k computes query-row . key-k; m and l live in fp32
//    registers per row and the output accumulator is spread over the
//    lanes, D/32 floats each; p is broadcast lane to lane with shuffles
//    for the P.V product;
//  * the TPU kernel's semantics are kept: masked scores are -1e30 and
//    masked p is forced to 0; the output is acc / (l > 0 ? l : 1).
// Requires D % 4 == 0 (16-byte rows) and D <= 256.  No tensor cores:
// TF32 would not hold the fp32 tolerance; faster tiles are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kKeyTile = 32;        // keys per shared-memory tile: one a lane
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kRowsPerWarp * kWarps;
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
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Lq, int Lk,
    int D, int causal, float scale) {
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

  const int n_keys = causal ? min(q0 + nq, Lk) : Lk;
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
        const int qpos = q0 + r;
        const bool vis = lane < nk && (!causal || qpos >= kpos);
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
int launch(const float* q, const float* k, const float* v, float* out,
           int BH, int Lq, int Lk, int D, int causal, float scale,
           cudaStream_t stream) {
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
      q, k, v, out, Lq, Lk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B*H, Lq, D); k, v: (B*H, Lk, D); out like q.  All contiguous fp32.
extern "C" int mxt_flash_attention_f32(const float* q, const float* k,
                                       const float* v, float* out, int BH,
                                       int Lq, int Lk, int D, int causal,
                                       float scale, cudaStream_t stream) {
  if (BH <= 0 || Lq <= 0) return static_cast<int>(cudaGetLastError());
  if (D <= 0 || D > 256 || D % 4 != 0 || Lk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32)
    return launch<1>(q, k, v, out, BH, Lq, Lk, D, causal, scale, stream);
  if (D <= 64)
    return launch<2>(q, k, v, out, BH, Lq, Lk, D, causal, scale, stream);
  if (D <= 128)
    return launch<4>(q, k, v, out, BH, Lq, Lk, D, causal, scale, stream);
  return launch<8>(q, k, v, out, BH, Lq, Lk, D, causal, scale, stream);
}
