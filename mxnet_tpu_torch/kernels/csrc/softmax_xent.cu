// The SoftmaxOutput loss head for Hopper (sm_90a), fp32: row softmax
// forward and the implicit-loss gradient (p - onehot(label)) * scale.
//
// Replaces the TPU kernels _softmax_fwd_kernel and
// _xent_grad_from_probs_kernel of mxnet_tpu/pallas_ops/softmax_xent.py
// (the pair behind softmax_output_head):
//   softmax:  m = max(x); e = exp(x - m); p = e / sum(e)     per row
//   grad:     g = (p - (col == int(label))) * scale           per row
// The label arrives as float32 and is truncated to int32, as the TPU
// kernel's astype(int32) does.
//
// Bound: bytes.  Both read and write every element once with a few
// flops each.  At the training head (4096 rows x 8192 classes) a row is
// 32 KB, so each row gets a whole 256-thread block: consecutive threads
// read consecutive floats (coalesced), the row max and sum are block
// reductions (warp shuffles, then one shared-memory round across the
// eight warps).  The softmax reads its row three times (max, sum,
// write); the second and third reads hit L1/L2, since the block's 32 KB
// row was just read.  The TPU kernel's (block_rows, classes) VMEM tile
// has no counterpart here: one block is one row.
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// block-wide reduction; every thread gets the result.  `scratch` holds
// kWarps floats and is free again when this returns.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < kWarps ? scratch[lane] : (kMax ? -INFINITY : 0.f);
  r = kMax ? warp_max(r) : warp_sum(r);
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
    softmax_rows_kernel(const float* __restrict__ x, float* __restrict__ p,
                        int cols) {
  __shared__ float scratch[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const float* xr = x + off;
  float* pr = p + off;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < cols; c += kThreads) m = fmaxf(m, xr[c]);
  m = block_reduce<true>(m, scratch);
  float s = 0.f;
  for (int c = threadIdx.x; c < cols; c += kThreads) s += expf(xr[c] - m);
  s = block_reduce<false>(s, scratch);
  for (int c = threadIdx.x; c < cols; c += kThreads)
    pr[c] = expf(xr[c] - m) / s;
}

__global__ void __launch_bounds__(kThreads)
    xent_grad_kernel(const float* __restrict__ p,
                     const float* __restrict__ label,
                     float* __restrict__ grad, int cols, float scale) {
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const int lbl = static_cast<int>(label[blockIdx.x]);   // truncates
  const float* prow = p + off;
  float* grow = grad + off;
  for (int c = threadIdx.x; c < cols; c += kThreads)
    grow[c] = (prow[c] - (c == lbl ? 1.f : 0.f)) * scale;
}

}  // namespace

extern "C" int mxt_softmax_rows_f32(const float* x, float* p, int rows,
                                    int cols, cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    softmax_rows_kernel<<<rows, kThreads, 0, stream>>>(x, p, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_xent_grad_from_probs_f32(const float* p,
                                            const float* label, float* grad,
                                            int rows, int cols, float scale,
                                            cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    xent_grad_kernel<<<rows, kThreads, 0, stream>>>(p, label, grad, cols,
                                                    scale);
  return static_cast<int>(cudaGetLastError());
}
