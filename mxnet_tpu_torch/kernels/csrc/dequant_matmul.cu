// Int8 weight-only dequant-matmul for Hopper (sm_90a):
//   out[m, n] = (sum_k x[m, k] * float(codes[n, k])) * scales[n]
// with x (M, K) fp32, codes (N, K) int8, scales (N,) fp32, out (M, N)
// fp32, all contiguous.
//
// Replaces the TPU kernel _dqmm_kernel of
// mxnet_tpu/pallas_ops/dequant_matmul.py: the int8 codes are widened to
// fp32 on the tile, the products accumulate in fp32 over K, and the
// per-row scale multiplies the finished sum once, after the K loop (the
// association of dequant_matmul_dense).  The activations are not
// quantized.
//
// One entry point, two regimes; the wrapper's planner
// (kernels/dequant_matmul.py::_plan) picks one and passes its split:
//
// * decode, M <= 32 (every decode bucket): a split-K GEMV on CUDA cores,
//   templated on the bucket (M <= 1, 2, 4, 8, 16, 32).  The codes' bytes
//   and the launch set the pace, so the grid has to fill the card: a CTA
//   takes 16 output columns and one K slice, and the planner cuts K into
//   up to 8 slices, enough for at least one full wave.  Each lane reads
//   its column's codes 16 at a time (ld.global.nc.v4; the two halves of
//   a warp read the two halves of a 32-byte sector) and widens each code
//   once; the 16 half-warps take the slice's 16-wide chunks.  x[:M,
//   slice] is staged in shared memory with 16-byte cp.async, 32 KB at a
//   time, and every x read is a broadcast.  Each row has its own FMA
//   chain, so the rows interleave.  The half-warps' sums meet in shared
//   memory in a fixed order; the slices of a column slab run as one
//   thread-block cluster (of one CTA when K is not split), whose CTAs
//   write their sums into rank 0's shared memory (distributed shared
//   memory), and rank 0 adds them in slice order, scales and writes out.
//   No workspace, no atomics, and the order of every sum is fixed, so
//   the same inputs give the same bits on every launch.
//
// * prefill, M > 32: a 64 x 64 tile on tensor cores in "2xTF32".  Each
//   code is exact in TF32 (8 significant bits of 11), so only x is
//   split, x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), and
//   mma.sync.m16n8k8 TF32 runs twice a k-step (A = hi, then A = lo;
//   B = the widened codes): each product hi*c and lo*c is exact in
//   fp32, which keeps fp32 accuracy at two MMAs, not three.  x (fp32)
//   and the raw int8 codes go to shared memory by 16-byte cp.async in a
//   3-stage pipeline, rows padded so the fragment loads are free of
//   bank conflicts; codes are widened when the B fragments are loaded.
//   Within each 32-wide k tile the MMA's k index t takes physical k
//   4t + s at step s (t + 4: 16 + 4t + s), so a thread reads its A
//   values as float4s and its codes as whole words.  The tensor cores'
//   fp32 sum does not round to nearest, so each k tile accumulates in a
//   fresh register tile that is added to a CUDA-core fp32 accumulator
//   ("promotion").  The row scale multiplies after the K loop.
//
// Both regimes zero-fill the M and N edges and a K tail (K % 32 == 16),
// so they add nothing.  Requires K % 16 == 0 and 16-byte aligned x and
// codes.  Bounds on an H100 SXM: codes' bytes at decode (3.35 TB/s);
// at M 1024 the 2 x 2MNK tensor-core operations (494.7 TFLOP/s TF32).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// shared helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the code in byte e of a word whose bytes were XORed with 0x80, widened
// to fp32 without an int -> float conversion: 2^23 + (c + 128) as float
// bits, minus 2^23 + 128 (exact)
__device__ __forceinline__ float widen(uint32_t biased, int e) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + e)) -
         8388736.0f;
}

__device__ __forceinline__ uint4 ld_nc_v4(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// ---------------------------------------------------------------------------
// decode: split-K GEMV
// ---------------------------------------------------------------------------
constexpr int kGvThreads = 256;
constexpr int kGvCols = 16;                    // output columns of a CTA
constexpr int kGvSubs = kGvThreads / kGvCols;  // half-warps
constexpr int kGvMaxSplits = 8;                // the portable cluster size
constexpr int kGvStage = 8192;                 // floats of x staged at once

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// M <= MB rows; a lane takes one output column
template <int MB>
__global__ void __launch_bounds__(kGvThreads) dequant_gemv_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, float* __restrict__ out, int M, int N,
    int K, int k_slice, int splits) {
  // k staged at a time: 32 KB of x, and at most 4 chunks of 16 a lane
  constexpr int kPiece = kGvStage / MB < 1024 ? kGvStage / MB : 1024;
  constexpr int kChunks = kPiece / 16 / kGvSubs;
  // a piece of x[:M, slice] while the products run, then the half-warps'
  // sums; part: the cluster's sums, slice by slice (rank 0's is read)
  __shared__ __align__(16) float sm[MB * kPiece];
  __shared__ float part[kGvMaxSplits * MB * kGvCols];
  const int tid = threadIdx.x;
  const int col = tid % kGvCols;
  const int sub = tid / kGvCols;   // lanes 0-15 and 16-31 of a warp
  const int n = blockIdx.x * kGvCols + col;
  const int k0 = blockIdx.y * k_slice;
  const int ks = min(k_slice, K - k0);   // a multiple of 16
  // the first cluster barrier phase: every CTA has started, so rank 0's
  // shared memory exists when the others write to it (waited on below)
  cluster_arrive_relaxed();

  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;
  for (int p = 0; p < ks; p += kPiece) {
    const int pl = min(kPiece, ks - p);
    const int kp = k0 + p;
    const int q_row = pl / 4;
    for (int i = tid; i < M * q_row; i += kGvThreads) {
      const int m = i / q_row;
      const int q = i % q_row;
      cp_async16(&sm[m * pl + 4 * q],
                 x + static_cast<size_t>(m) * K + kp + 4 * q, 16);
    }
    cp_async_commit();
    // chunks sub, sub + 16, ... of the piece: the two halves of a warp
    // read the two 16-byte halves of each code row's 32-byte sector
    uint4 cw[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = sub + kGvSubs * j;
      cw[j] = (16 * c < pl && n < N)
                  ? ld_nc_v4(codes + static_cast<size_t>(n) * K + kp + 16 * c)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int c = sub + kGvSubs * j;
      if (16 * c >= pl) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) {   // k 16c + 4i .. 16c + 4i + 3
        const uint32_t word = (i == 0   ? cw[j].x
                               : i == 1 ? cw[j].y
                               : i == 2 ? cw[j].z
                                        : cw[j].w) ^
                              0x80808080u;
        float w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = widen(word, e);
        // every row of the bucket, so the rows' FMA chains interleave;
        // rows >= M work on stale values and are never stored
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          // a broadcast within each half-warp
          const float4 v =
              *reinterpret_cast<const float4*>(&sm[m * pl + 16 * c + 4 * i]);
          float a = acc[m];
          a = fmaf(v.x, w[0], a);
          a = fmaf(v.y, w[1], a);
          a = fmaf(v.z, w[2], a);
          a = fmaf(v.w, w[3], a);
          acc[m] = a;
        }
      }
    }
    __syncthreads();   // the piece is read
  }
#pragma unroll
  for (int m = 0; m < MB; ++m)
    if (m < M) sm[(sub * MB + m) * kGvCols + col] = acc[m];
  __syncthreads();

  // the half-warps' sums, added in half-warp order, go to rank 0's shared
  // memory (distributed shared memory); rank 0 adds the slices in slice
  // order, scales and writes out
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float* dst = cluster.map_shared_rank(part, 0) + rank * MB * kGvCols;
  const int outs = M * kGvCols;
  cluster_wait();
  for (int o = tid; o < outs; o += kGvThreads) {
    const int m = o / kGvCols;
    const int c = o % kGvCols;
    float v = 0.f;
#pragma unroll
    for (int s = 0; s < kGvSubs; ++s) v += sm[(s * MB + m) * kGvCols + c];
    dst[o] = v;
  }
  cluster_arrive_release();
  if (rank != 0) return;
  cluster_wait();
  for (int o = tid; o < outs; o += kGvThreads) {
    float v = part[o];
#pragma unroll
    for (int r = 1; r < kGvMaxSplits; ++r)
      if (r < splits) v += part[r * MB * kGvCols + o];
    const int m = o / kGvCols;
    const int nn = blockIdx.x * kGvCols + o % kGvCols;
    if (nn < N) out[static_cast<size_t>(m) * N + nn] = v * scales[nn];
  }
}

// ---------------------------------------------------------------------------
// prefill: 2xTF32 tensor-core tile
// ---------------------------------------------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kTcThreads = 128;     // 4 warps, 2 x 2, each 32 x 32
constexpr int kXStride = kBK + 16;  // floats: row g+1 lands 16 banks on
constexpr int kCStride = kBK + 16;  // bytes: 12 words, 8 rows hit 8 banks

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// component s of v (s is a constant after unrolling)
__device__ __forceinline__ float lane_of(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kTcThreads) dequant_tile_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, float* __restrict__ out, int M, int N,
    int K) {
  __shared__ __align__(16) float xs[kStages][kBM][kXStride];
  __shared__ __align__(16) int8_t cs[kStages][kBN][kCStride];
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;      // fragment group
  const int t = lane % 4;      // thread in group
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int n_tiles = (K + kBK - 1) / kBK;

  auto load = [&](int tile, int st) {
    const int k0 = tile * kBK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 4 / kTcThreads; ++i) {
      const int idx = tid + kTcThreads * i;
      const int r = idx / (kBK / 4);
      const int q = idx % (kBK / 4);
      const int m = m0 + r;
      const int k = k0 + 4 * q;
      const bool ok = m < M && k < K;
      cp_async16(&xs[st][r][4 * q],
                 ok ? x + static_cast<size_t>(m) * K + k : x, ok ? 16 : 0);
    }
    {
      const int r = tid / 2;
      const int q = tid % 2;
      const int nn = n0 + r;
      const int k = k0 + 16 * q;
      const bool ok = nn < N && k < K;
      cp_async16(&cs[st][r][16 * q],
                 ok ? codes + static_cast<size_t>(nn) * K + k : codes,
                 ok ? 16 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s, s);
    cp_async_commit();
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile's stage landed; tile-1's stage is free
    {
      const int nxt = tile + kStages - 1;
      if (nxt < n_tiles) load(nxt, nxt % kStages);
      cp_async_commit();
    }
    const int st = tile % kStages;
    // A: rows (g, g+8) of each 16-row m tile, k 4t.. and 16+4t..
    float4 xa[2][2], xb[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* row = xs[st][wm + 16 * mi + g + 8 * h];
        xa[mi][h] = *reinterpret_cast<const float4*>(row + 4 * t);
        xb[mi][h] = *reinterpret_cast<const float4*>(row + 16 + 4 * t);
      }
    // B: column g of each 8-wide n tile, words t and t + 4 (biased)
    uint32_t w0[4], w1[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint32_t* col =
          reinterpret_cast<const uint32_t*>(cs[st][wn + 8 * ni + g]);
      w0[ni] = col[t] ^ 0x80808080u;
      w1[ni] = col[t + 4] ^ 0x80808080u;
    }
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        const float av[4] = {lane_of(xa[mi][0], s), lane_of(xa[mi][1], s),
                             lane_of(xb[mi][0], s), lane_of(xb[mi][1], s)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = av[r];
          hi[mi][r] = tf32_rna(v);
          lo[mi][r] = tf32_rna(v - __uint_as_float(hi[mi][r]));
        }
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint32_t b0 = __float_as_uint(widen(w0[ni], s));
        const uint32_t b1 = __float_as_uint(widen(w1[ni], s));
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_tf32(part[mi][ni], hi[mi], b0, b1);
          mma_tf32(part[mi][ni], lo[mi], b0, b1);
        }
      }
    }
    // promotion: the k tile's sum joins the fp32 accumulator
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // C fragment: (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nn = n0 + wn + 8 * ni + 2 * t + e;
      if (nn >= N) continue;
      const float sc = scales[nn];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + 16 * mi + g + 8 * h;
          if (m < M)
            out[static_cast<size_t>(m) * N + nn] = acc[mi][ni][2 * h + e] * sc;
        }
    }
  }
}

// the slices of a column slab form one cluster of `splits` CTAs
template <int MB>
cudaError_t launch_gemv(const float* x, const int8_t* codes,
                        const float* scales, float* out, int M, int N, int K,
                        int k_slice, int splits, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kGvCols - 1) / kGvCols, splits);
  cfg.blockDim = dim3(kGvThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, dequant_gemv_kernel<MB>, x, codes, scales, out,
                         M, N, K, k_slice, splits);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// k_slice > 0: the decode GEMV (M <= 32), K cut into `splits` <= 8
// slices of k_slice (the last may be shorter), one cluster a 16-column
// slab.  k_slice == 0: the prefill tensor-core tile.
extern "C" int mxt_dequant_matmul_f32(const float* x, const int8_t* codes,
                                      const float* scales, float* out,
                                      int M, int N, int K, int k_slice,
                                      int splits, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (k_slice == 0) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    dequant_tile_kernel<<<grid, kTcThreads, 0, stream>>>(x, codes, scales,
                                                         out, M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (M > 32 || k_slice % 16 != 0 || splits < 1 || splits > kGvMaxSplits ||
      splits != (K + k_slice - 1) / k_slice)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (M <= 1)
    err = launch_gemv<1>(x, codes, scales, out, M, N, K, k_slice, splits,
                         stream);
  else if (M <= 2)
    err = launch_gemv<2>(x, codes, scales, out, M, N, K, k_slice, splits,
                         stream);
  else if (M <= 4)
    err = launch_gemv<4>(x, codes, scales, out, M, N, K, k_slice, splits,
                         stream);
  else if (M <= 8)
    err = launch_gemv<8>(x, codes, scales, out, M, N, K, k_slice, splits,
                         stream);
  else if (M <= 16)
    err = launch_gemv<16>(x, codes, scales, out, M, N, K, k_slice, splits,
                          stream);
  else
    err = launch_gemv<32>(x, codes, scales, out, M, N, K, k_slice, splits,
                          stream);
  return static_cast<int>(err);
}
