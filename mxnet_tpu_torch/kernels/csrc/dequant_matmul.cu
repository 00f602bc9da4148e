// Int8 weight-only dequant-matmul for Hopper (sm_90a):
//   out[m, n] = (sum_k x[m, k] * float(codes[n, k])) * scales[n]
// with x (M, K) fp32, codes (N, K) int8, scales (N,) fp32, out (M, N)
// fp32, all contiguous.
//
// Replaces the TPU kernel _dqmm_kernel of
// mxnet_tpu/pallas_ops/dequant_matmul.py: the int8 code tile is widened
// to fp32 on the tile, the products accumulate in fp32 over K, and the
// per-row scale multiplies the finished accumulator once, after the K
// loop (the association of dequant_matmul_dense).  The activations are
// not quantized: int8 tensor cores would change the numbers.
//
// Bound: at a prefill chunk (M up to 1024) the fp32 CUDA-core products
// bound it; at decode (M <= 32) the bytes of the codes do, a quarter of
// an fp32 weight's.  This first version is a plain tiled SGEMM:
//  * one 256-thread block per 64 x 64 output tile, each thread a 4 x 4
//    micro-tile (rows 4*ty.., columns 4*tx..);
//  * K advances in 32-wide tiles.  Each thread loads its share of the
//    next tile into registers (two float4 of x, eight codes as one
//    8-byte word) while the current tile is computed, then widens the
//    codes to fp32 and stores both tiles TRANSPOSED into the other
//    shared-memory buffer ([k][m] and [k][n]), so the inner loop reads
//    one float4 of x rows and one float4 of widened codes per k: the
//    int8 -> fp32 conversion happens once per code, not once per
//    product;
//  * out-of-range rows (M, N edges) and the K tail (K % 32 == 16) are
//    zero-filled, so they add nothing.
// Requires K % 16 == 0 and 16-byte aligned x and codes.  No tensor
// cores, no split-K: decode shapes leave most of the 64-row tile and
// most SMs idle, which a GEMV-shaped variant would fix (later work).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kPad = 4;   // row stride kBM + 4 floats of the [k][m] tiles

__device__ __forceinline__ float code_at(uint32_t word, int e) {
  // byte e of a little-endian word, sign-extended
  return static_cast<float>(static_cast<int32_t>(word << (24 - 8 * e)) >>
                            24);
}

__global__ void __launch_bounds__(kThreads) dequant_matmul_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ codes,
    const float* __restrict__ scales, float* __restrict__ out, int M,
    int N, int K) {
  __shared__ __align__(16) float xs[2][kBK][kBM + kPad];
  __shared__ __align__(16) float cs[2][kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // x tile: 64 rows x 8 float4 chunks, chunks tid and tid + 256
  const int xr = tid / 8;          // rows xr and xr + 32
  const int xq = tid % 8;          // k offset 4 * xq
  // code tile: 64 rows x 4 chunks of 8 codes, chunk tid
  const int cr = tid / 4;
  const int cq = tid % 4;          // k offset 8 * cq

  float4 xa[2];
  uint2 cw;
  auto load = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + xr + 32 * h;
      const int k = k0 + 4 * xq;
      xa[h] = (m < M && k < K)
                  ? *reinterpret_cast<const float4*>(
                        x + static_cast<size_t>(m) * K + k)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int n = n0 + cr;
    const int k = k0 + 8 * cq;
    cw = (n < N && k < K) ? *reinterpret_cast<const uint2*>(
                                codes + static_cast<size_t>(n) * K + k)
                          : make_uint2(0u, 0u);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = xr + 32 * h;
      xs[buf][4 * xq + 0][m] = xa[h].x;
      xs[buf][4 * xq + 1][m] = xa[h].y;
      xs[buf][4 * xq + 2][m] = xa[h].z;
      xs[buf][4 * xq + 3][m] = xa[h].w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cs[buf][8 * cq + e][cr] = code_at(cw.x, e);
      cs[buf][8 * cq + 4 + e][cr] = code_at(cw.y, e);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_tiles = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const bool more = t + 1 < n_tiles;
    if (more) load((t + 1) * kBK);   // global loads in flight
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[buf][k][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&cs[buf][k][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // the other buffer was last read in iteration t - 1, before its
    // closing barrier
    if (more) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * tx + j;
    if (n >= N) continue;
    const float s = scales[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m < M) out[static_cast<size_t>(m) * N + n] = acc[i][j] * s;
    }
  }
}

}  // namespace

extern "C" int mxt_dequant_matmul_f32(const float* x, const int8_t* codes,
                                      const float* scales, float* out,
                                      int M, int N, int K,
                                      cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  dequant_matmul_kernel<<<grid, kThreads, 0, stream>>>(x, codes, scales,
                                                       out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
