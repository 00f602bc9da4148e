// Row-wise RMSNorm and LayerNorm forward for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels _rms_fwd_kernel and _ln_fwd_kernel of
// mxnet_tpu/pallas_ops/norm.py.  Both normalise each row of a
// (rows, width) matrix over its last axis with fp32 statistics:
//   rms:  y = x * rsqrt(mean(x^2) + eps) * gamma
//   ln:   y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * gamma + beta
// (the variance as mean((x - mu)^2), as the TPU kernel computes it, not
// E[x^2] - mu^2).
//
// Bound: bytes.  A norm does a handful of flops per element and moves
// each element in and out once, so the card's memory rate is the limit.
// Design: one warp per row, four rows per 128-thread block, any width.
// Lanes stride the row 32 floats apart, so each warp load is one
// coalesced 128-byte transaction; the row reduction is a butterfly of
// warp shuffles, with no shared memory and no block-wide barrier.  The
// re-reads of the row for the second (and, for LayerNorm, third) pass
// hit L1/L2: at width 512 a row is 2 KB.  The TPU's width % 128 rule and
// VMEM row-block budget do not apply here.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void rms_norm_kernel(const float* __restrict__ x,
                                const float* __restrict__ gamma,
                                float* __restrict__ y, int rows, int width,
                                float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * width;
  float* yr = y + static_cast<size_t>(row) * width;
  float ss = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float v = xr[c];
    ss += v * v;
  }
  const float r = rsqrtf(warp_sum(ss) / width + eps);
  for (int c = lane; c < width; c += 32) yr[c] = xr[c] * r * gamma[c];
}

__global__ void layer_norm_kernel(const float* __restrict__ x,
                                  const float* __restrict__ gamma,
                                  const float* __restrict__ beta,
                                  float* __restrict__ y, int rows, int width,
                                  float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * width;
  float* yr = y + static_cast<size_t>(row) * width;
  float s = 0.f;
  for (int c = lane; c < width; c += 32) s += xr[c];
  const float mu = warp_sum(s) / width;
  float sq = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float d = xr[c] - mu;
    sq += d * d;
  }
  const float r = rsqrtf(warp_sum(sq) / width + eps);
  for (int c = lane; c < width; c += 32)
    yr[c] = (xr[c] - mu) * r * gamma[c] + beta[c];
}

int blocks_for(int rows) {
  return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

}  // namespace

extern "C" int mxt_rms_norm_f32(const float* x, const float* gamma,
                                float* y, int rows, int width, float eps,
                                cudaStream_t stream) {
  if (rows > 0 && width > 0) {
    rms_norm_kernel<<<blocks_for(rows), 32 * kWarpsPerBlock, 0, stream>>>(
        x, gamma, y, rows, width, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_layer_norm_f32(const float* x, const float* gamma,
                                  const float* beta, float* y, int rows,
                                  int width, float eps,
                                  cudaStream_t stream) {
  if (rows > 0 && width > 0) {
    layer_norm_kernel<<<blocks_for(rows), 32 * kWarpsPerBlock, 0,
                        stream>>>(x, gamma, beta, y, rows, width, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
