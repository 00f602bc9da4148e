// Row-wise RMSNorm and LayerNorm, forward and backward, for Hopper
// (sm_90a), fp32.
//
// Replaces the TPU kernels _rms_fwd_kernel, _rms_bwd_kernel,
// _ln_fwd_kernel and _ln_bwd_kernel of mxnet_tpu/pallas_ops/norm.py.
// All normalise each row of a (rows, width) matrix over its last axis
// with fp32 statistics:
//   rms:  y = x * rsqrt(mean(x^2) + eps) * gamma
//   ln:   y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * gamma + beta
// (the variance as mean((x - mu)^2), as the TPU kernel computes it, not
// E[x^2] - mu^2).  The backwards, with w = dy * gamma:
//   rms:  dx = r*w - r^3 * x * mean(w*x);     dgamma = sum_rows dy*x*r
//   ln:   dx = r * (w - mean(w) - xhat * mean(w*xhat));
//         dgamma = sum_rows dy*xhat;           dbeta = sum_rows dy
//
// Bound: bytes.  A norm does a handful of flops per element and moves
// each element in and out once, so the card's memory rate is the limit.
// Design: one warp per row, four warps per 128-thread block, any width.
// Lanes stride the row 32 floats apart, so each warp load is one
// coalesced 128-byte transaction; the row reduction is a butterfly of
// warp shuffles, with no block-wide barrier in the forward.  The
// re-reads of the row for the later passes hit L1/L2: at width 512 a
// row is 2 KB.  The TPU's width % 128 rule and VMEM row-block budget do
// not apply here.
//
// The backward's weight gradients are per-block partial sums, one
// (width,) row per block of kBwdRowsPerBlock rows, which the caller sums
// (as the TPU caller sums its per-row-block partials): each warp adds
// its rows' contributions into its own shared-memory row, then the block
// adds the four warp rows in a fixed order.  No atomics, so the result
// is the same on every run.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBwdRowsPerWarp = 4;
constexpr int kBwdRowsPerBlock = kWarpsPerBlock * kBwdRowsPerWarp;
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

// dgamma (and dbeta) partials: the block's kWarpsPerBlock warp rows of
// shared memory, summed in warp order into row blockIdx.x of `out`
__device__ __forceinline__ void write_partial(const float* part, float* out,
                                              int width) {
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += 32 * kWarpsPerBlock) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsPerBlock; ++w) s += part[w * width + c];
    out[static_cast<size_t>(blockIdx.x) * width + c] = s;
  }
}

__global__ void rms_norm_bwd_kernel(const float* __restrict__ x,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ dy,
                                    float* __restrict__ dx,
                                    float* __restrict__ dg_part, int rows,
                                    int width, float eps) {
  extern __shared__ float part[];     // [kWarpsPerBlock][width]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* wpart = part + warp * width;
  for (int c = lane; c < width; c += 32) wpart[c] = 0.f;
  const int row0 = blockIdx.x * kBwdRowsPerBlock + warp * kBwdRowsPerWarp;
  for (int i = 0; i < kBwdRowsPerWarp && row0 + i < rows; ++i) {
    const size_t off = static_cast<size_t>(row0 + i) * width;
    const float* xr = x + off;
    const float* dyr = dy + off;
    float* dxr = dx + off;
    float ss = 0.f, swx = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float v = xr[c];
      ss += v * v;
      swx += dyr[c] * gamma[c] * v;
    }
    const float r = rsqrtf(warp_sum(ss) / width + eps);
    const float mwx = warp_sum(swx) / width;
    const float r3 = r * r * r;
    for (int c = lane; c < width; c += 32) {
      const float v = xr[c];
      const float d = dyr[c];
      const float w = d * gamma[c];
      dxr[c] = r * w - r3 * v * mwx;
      wpart[c] += d * v * r;
    }
  }
  write_partial(part, dg_part, width);
}

__global__ void layer_norm_bwd_kernel(const float* __restrict__ x,
                                      const float* __restrict__ gamma,
                                      const float* __restrict__ dy,
                                      float* __restrict__ dx,
                                      float* __restrict__ dg_part,
                                      float* __restrict__ db_part, int rows,
                                      int width, float eps) {
  extern __shared__ float part[];     // dgamma then dbeta warp rows
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* gpart = part + warp * width;
  float* bpart = part + (kWarpsPerBlock + warp) * width;
  for (int c = lane; c < width; c += 32) {
    gpart[c] = 0.f;
    bpart[c] = 0.f;
  }
  const int row0 = blockIdx.x * kBwdRowsPerBlock + warp * kBwdRowsPerWarp;
  for (int i = 0; i < kBwdRowsPerWarp && row0 + i < rows; ++i) {
    const size_t off = static_cast<size_t>(row0 + i) * width;
    const float* xr = x + off;
    const float* dyr = dy + off;
    float* dxr = dx + off;
    float s = 0.f;
    for (int c = lane; c < width; c += 32) s += xr[c];
    const float mu = warp_sum(s) / width;
    float sq = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float d = xr[c] - mu;
      sq += d * d;
    }
    const float r = rsqrtf(warp_sum(sq) / width + eps);
    float sw = 0.f, swx = 0.f;
    for (int c = lane; c < width; c += 32) {
      const float w = dyr[c] * gamma[c];
      sw += w;
      swx += w * ((xr[c] - mu) * r);
    }
    const float mw = warp_sum(sw) / width;
    const float mwx = warp_sum(swx) / width;
    for (int c = lane; c < width; c += 32) {
      const float d = dyr[c];
      const float xhat = (xr[c] - mu) * r;
      dxr[c] = r * (d * gamma[c] - mw - xhat * mwx);
      gpart[c] += d * xhat;
      bpart[c] += d;
    }
  }
  write_partial(part, dg_part, width);
  write_partial(part + kWarpsPerBlock * width, db_part, width);
}

int blocks_for(int rows) {
  return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

int bwd_blocks_for(int rows) {
  return (rows + kBwdRowsPerBlock - 1) / kBwdRowsPerBlock;
}

// dynamic shared memory above the default 48 KB needs an opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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

// dg_part: (ceil(rows / 16), width) per-block partial sums of dgamma
extern "C" int mxt_rms_norm_bwd_f32(const float* x, const float* gamma,
                                    const float* dy, float* dx,
                                    float* dg_part, int rows, int width,
                                    float eps, cudaStream_t stream) {
  if (rows > 0 && width > 0) {
    const size_t smem = sizeof(float) * kWarpsPerBlock * width;
    const cudaError_t err = allow_smem(rms_norm_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rms_norm_bwd_kernel<<<bwd_blocks_for(rows), 32 * kWarpsPerBlock, smem,
                          stream>>>(x, gamma, dy, dx, dg_part, rows, width,
                                    eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// dg_part, db_part: (ceil(rows / 16), width) partial sums
extern "C" int mxt_layer_norm_bwd_f32(const float* x, const float* gamma,
                                      const float* dy, float* dx,
                                      float* dg_part, float* db_part,
                                      int rows, int width, float eps,
                                      cudaStream_t stream) {
  if (rows > 0 && width > 0) {
    const size_t smem = sizeof(float) * 2 * kWarpsPerBlock * width;
    const cudaError_t err = allow_smem(layer_norm_bwd_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    layer_norm_bwd_kernel<<<bwd_blocks_for(rows), 32 * kWarpsPerBlock, smem,
                            stream>>>(x, gamma, dy, dx, dg_part, db_part,
                                      rows, width, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
