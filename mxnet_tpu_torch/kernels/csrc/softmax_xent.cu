// The softmax / cross-entropy row kernels for Hopper (sm_90a), fp32;
// SoftmaxOutput's head (the first two below) and softmax_xent_loss
// (the last two) in bf16 as well.
//
// Replaces the TPU kernels of mxnet_tpu/pallas_ops/softmax_xent.py:
//   _softmax_fwd_kernel            p = exp(x - max(x)) / sum(...)  per row
//   _xent_grad_from_probs_kernel   (p - onehot(label)) * scale       per row
//   _softmax_bwd_kernel            dx = p * (dy - sum(dy * p))       per row
//   _xent_loss_kernel              logsumexp(x) - x[label]           per row
//   _xent_loss_grad_kernel         (softmax(x) - onehot(label)) * g  per row
// The first two are SoftmaxOutput's head, the third is fused_softmax's
// vjp, the last two softmax_xent_loss's forward and gradient.  Labels
// arrive as float32 and are truncated to int32, as the TPU kernels'
// astype(int32) does; a label outside [0, cols) matches no column
// (loss lse - 0, gradient p * g).
//
// Bound: bytes.  Every kernel reads and writes each element once with a
// few flops.  At the training head (4096 rows x 8192 classes) a row is
// 32 KB, so each row gets a whole 256-thread block: consecutive threads
// read consecutive floats (the last three kernels as 16-byte float4
// loads when every row start is 16-byte aligned), and the row
// reductions are block reductions (warp shuffles, then one
// shared-memory round across the eight warps).  The loss
// kernels keep a running (max, sum of exp) pair per thread, rescaled
// when the max grows (one pass over the row instead of a max pass and a
// sum pass), and merge the pairs across the block; the loss forward
// never writes the probabilities.  The other kernels read their row a
// second time to write it.  The TPU kernels' (block_rows, classes) VMEM
// tile has no counterpart here: one block is one row.
//
// The softmax forward (softmax_rows) has two bodies, picked on the host
// by kernels/softmax_xent.py::_plan and passed as `path` and `loads`.
// The registers body holds an fp32 row of up to 16384 classes (width a
// multiple of 4, rows 16-byte aligned) in registers, 4 values a float4
// and up to 16 a thread, and reads it from device memory once.  A row
// read again goes back to L2 or device memory: at the LSTM LM's head
// (1024 rows of 10000 classes, 40 KB a row, 82 MB of logits and
// probabilities against a 50 MB L2) the earlier three-pass body took
// 1.9 x the registers body's time (PERF.md row 10).  Other rows take
// the two-pass body: the loss kernels' running (max, sum of exp) pass,
// then a read that writes.
//
// bf16 (SoftmaxOutput's head under Module(compute_dtype='bfloat16'):
// _softmax_fwd_kernel and _xent_grad_from_probs_kernel on bf16 tiles,
// softmax_xent.py:162 softmax_output_head): every element widens to
// fp32, the max, the sum of exp and the division are fp32, and the
// output is rounded to nearest even once, as the TPU kernels cast
// their fp32 tile to o_ref.dtype; the labels stay float32.  A bf16 row
// of the training head is 16 KB (8192 classes), so where the width is
// a multiple of 8, at most 8192, and the rows 16-byte aligned, the
// softmax holds its row in registers (8 values a 16-byte load, up to 4
// loads a thread) and reads it from device memory once; the gradient
// reads p and writes the gradient 16 bytes at a time.  Other rows take
// the two-pass body and the scalar loops of the fp32 kernels, widening
// each element.
//
// bf16 softmax_xent_loss (the imperative plane's mx.nd.softmax_cross_
// entropy on bf16 logits: _xent_loss_kernel and _xent_loss_grad_kernel
// on bf16 tiles, softmax_xent.py:194): the same fp32 arithmetic; the
// loss is written as fp32 (one float a row), the gradient
// (p - onehot) * g rounded to bf16 once; labels and g stay float32.
// Both hold their row in registers under the head's softmax conditions
// (width a multiple of 8, at most 8192, rows 16-byte aligned), so each
// reads the row from device memory once: a max pass and a sum-of-exp
// pass over the registers with plain block reductions, then the loss
// writes one float a row and the gradient writes its row 16 bytes at a
// time.  At 4096 x 8192 the loss took 0.030496 ms this way, against
// 0.038592 ms for the fp32 kernel's one running (max, sum of exp) pass
// over 16-byte loads, whose merges cost two exps a shuffle step
// (chip_smoke.py phase 5 on an H100 80GB HBM3 at 700 W, PERF.md).
// Other rows take the scalar loops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 8 bf16 values a 16-byte access: widen on load (a bf16 is the top half
// of an fp32), round to nearest even on store
constexpr int kVec = 8;
constexpr int kMaxVecLoads = 4;   // the registers row: cols <= 8192

__device__ __forceinline__ void load8(const uint4& u, float (&v)[kVec]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 store8(const float (&v)[kVec]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return u;
}

// fp32 rows of cols % 4 == 0, cols <= 4 * kThreads * NL, 16-byte
// aligned, held in registers: thread t issues all of its float4 loads
// (chunks t, t + kThreads, ..., NL of them) before the first reduction,
// so the CTA has its whole row in flight at once; the max, exp(v - m)
// in place, the sum, then v / s written as float4.  Each element is
// read from device memory once and written once.  Chunks past the row
// (the tail lanes) are skipped by every pass, so they enter neither
// reduction.  Two CTAs an SM at least (NL 16: 64 floats of row a
// thread).
template <int NL>
__global__ void __launch_bounds__(kThreads, 2)
    softmax_rows_f32_regs_kernel(const float* __restrict__ x,
                                 float* __restrict__ p, int cols) {
  __shared__ float scratch[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const float4* x4 = reinterpret_cast<const float4*>(x + off);
  float4* p4 = reinterpret_cast<float4*>(p + off);
  const int n4 = cols / 4;
  float4 v[NL];
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < n4) v[j] = x4[c];
  }
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NL; ++j)
    if (threadIdx.x + j * kThreads < n4)
      m = fmaxf(m, fmaxf(fmaxf(v[j].x, v[j].y), fmaxf(v[j].z, v[j].w)));
  m = block_reduce<true>(m, scratch);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    if (threadIdx.x + j * kThreads < n4) {
      v[j].x = expf(v[j].x - m);
      v[j].y = expf(v[j].y - m);
      v[j].z = expf(v[j].z - m);
      v[j].w = expf(v[j].w - m);
      s += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
  }
  s = block_reduce<false>(s, scratch);
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < n4)
      p4[c] = make_float4(v[j].x / s, v[j].y / s, v[j].z / s, v[j].w / s);
  }
}

// one bf16 row of n8 8-value chunks at x8, read once: thread t loads
// the chunks t, t + kThreads, ... (NL of them) into v; every thread gets
// the row's max m and sum of exp s, and v holds exp(x - m)
template <int NL>
__device__ __forceinline__ void regs_row_exp_sum(
    const uint4* __restrict__ x8, int n8, float (&v)[NL][kVec],
    float* scratch, float& m, float& s) {
  m = -INFINITY;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < n8) {
      load8(x8[c], v[j]);
#pragma unroll
      for (int i = 0; i < kVec; ++i) m = fmaxf(m, v[j][i]);
    }
  }
  m = block_reduce<true>(m, scratch);
  s = 0.f;
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    if (threadIdx.x + j * kThreads < n8) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        v[j][i] = expf(v[j][i] - m);
        s += v[j][i];
      }
    }
  }
  s = block_reduce<false>(s, scratch);
}

// bf16 rows of cols % 8 == 0, cols <= 8 * kThreads * NL, 16-byte
// aligned, each held in registers by regs_row_exp_sum
template <int NL>
__global__ void __launch_bounds__(kThreads)
    softmax_rows_bf16_regs_kernel(const __nv_bfloat16* __restrict__ x,
                                  __nv_bfloat16* __restrict__ p, int cols) {
  __shared__ float scratch[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const uint4* x8 = reinterpret_cast<const uint4*>(x + off);
  uint4* p8 = reinterpret_cast<uint4*>(p + off);
  const int n8 = cols / kVec;
  float v[NL][kVec];
  float m, s;
  regs_row_exp_sum<NL>(x8, n8, v, scratch, m, s);
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < n8) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[j][i] = v[j][i] / s;
      p8[c] = store8(v[j]);
    }
  }
}

// (p - onehot(label)) * scale; vec: bf16 rows read and written 16 bytes
// at a time (cols % 8 == 0, 16-byte aligned)
template <typename E>
__global__ void __launch_bounds__(kThreads)
    xent_grad_kernel(const E* __restrict__ p,
                     const float* __restrict__ label,
                     E* __restrict__ grad, int cols, float scale,
                     bool vec) {
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const int lbl = static_cast<int>(label[blockIdx.x]);   // truncates
  const E* prow = p + off;
  E* grow = grad + off;
  if constexpr (sizeof(E) == 2) {
    if (vec) {
      const uint4* p8 = reinterpret_cast<const uint4*>(prow);
      uint4* g8 = reinterpret_cast<uint4*>(grow);
      for (int c = threadIdx.x; c < cols / kVec; c += kThreads) {
        float v[kVec];
        load8(p8[c], v);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          v[i] = (v[i] - (c * kVec + i == lbl ? 1.f : 0.f)) * scale;
        g8[c] = store8(v);
      }
      return;
    }
  }
  for (int c = threadIdx.x; c < cols; c += kThreads)
    narrow(grow + c, (widen(prow[c]) - (c == lbl ? 1.f : 0.f)) * scale);
}

// ---------------------------------------------------------------------------
// running (max, sum of exp) pairs: s is the sum of exp(v - m) over the
// values seen; m == -inf means none seen yet (s == 0)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void ms_merge(float& m, float& s, float m2,
                                         float s2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;   // both empty
  s = s * expf(m - mm) + s2 * expf(m2 - mm);
  m = mm;
}

__device__ __forceinline__ void ms_add4(float& m, float& s, float4 v) {
  const float cm = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
  if (cm > m) {
    s *= expf(m - cm);
    m = cm;
  }
  if (m > -INFINITY)
    s += expf(v.x - m) + expf(v.y - m) + expf(v.z - m) + expf(v.w - m);
}

__device__ __forceinline__ void ms_add(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;
    m = v;
  } else if (m > -INFINITY) {
    s += expf(v - m);
  }
}

// every thread gets the row's (max, sum of exp); `sm`, `ss` hold kWarps
// floats each and are free again when this returns
__device__ __forceinline__ void block_reduce_ms(float& m, float& s,
                                                float* sm, float* ss) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    ms_merge(m, s, __shfl_xor_sync(kFull, m, o),
             __shfl_xor_sync(kFull, s, o));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = lane < kWarps ? sm[lane] : -INFINITY;
  s = lane < kWarps ? ss[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    ms_merge(m, s, __shfl_xor_sync(kFull, m, o),
             __shfl_xor_sync(kFull, s, o));
  __syncthreads();
}

// (max, sum of exp) of one row of `cols` elements at `xr`; vec: fp32
// rows as float4, every row start 16-byte aligned (bf16 rows that allow
// 16-byte access take the registers kernels instead)
template <typename E>
__device__ __forceinline__ void row_max_sum(const E* __restrict__ xr,
                                            int cols, bool vec, float* sm,
                                            float* ss, float& m, float& s) {
  m = -INFINITY;
  s = 0.f;
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int c = threadIdx.x; c < cols / 4; c += kThreads)
      ms_add4(m, s, x4[c]);
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads)
      ms_add(m, s, widen(xr[c]));
  }
  block_reduce_ms(m, s, sm, ss);
}

// softmax rows that no registers body takes (unaligned views, widths
// not a multiple of the 16-byte chunk, rows wider than the registers
// bodies): one running (max, sum of exp) pass, then a second read that
// writes exp(x - m) / s; vec: fp32 rows as float4 (every row start
// 16-byte aligned), else one element at a time
template <typename E>
__global__ void __launch_bounds__(kThreads)
    softmax_rows_two_pass_kernel(const E* __restrict__ x,
                                 E* __restrict__ p, int cols, bool vec) {
  __shared__ float sm[kWarps], ss[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const E* xr = x + off;
  E* pr = p + off;
  float m, s;
  row_max_sum(xr, cols, vec, sm, ss, m, s);
  if constexpr (sizeof(E) == 4) {
    if (vec) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      float4* p4 = reinterpret_cast<float4*>(pr);
      for (int c = threadIdx.x; c < cols / 4; c += kThreads) {
        const float4 v = x4[c];
        p4[c] = make_float4(expf(v.x - m) / s, expf(v.y - m) / s,
                            expf(v.z - m) / s, expf(v.w - m) / s);
      }
      return;
    }
  }
  for (int c = threadIdx.x; c < cols; c += kThreads)
    narrow(pr + c, expf(widen(xr[c]) - m) / s);
}

template <typename E>
__global__ void __launch_bounds__(kThreads)
    xent_loss_kernel(const E* __restrict__ x,
                     const float* __restrict__ label,
                     float* __restrict__ loss, int cols, bool vec) {
  __shared__ float sm[kWarps], ss[kWarps];
  const E* xr = x + static_cast<size_t>(blockIdx.x) * cols;
  float m, s;
  row_max_sum(xr, cols, vec, sm, ss, m, s);
  if (threadIdx.x == 0) {
    const int lbl = static_cast<int>(label[blockIdx.x]);   // truncates
    const float tgt = (lbl >= 0 && lbl < cols) ? widen(xr[lbl]) : 0.f;
    loss[blockIdx.x] = logf(s) + m - tgt;
  }
}

// vec: fp32 rows read and written as float4
template <typename E>
__global__ void __launch_bounds__(kThreads)
    xent_loss_grad_kernel(const E* __restrict__ x,
                          const float* __restrict__ label,
                          const float* __restrict__ g,
                          E* __restrict__ grad, int cols, bool vec) {
  __shared__ float sm[kWarps], ss[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const E* xr = x + off;
  E* gr = grad + off;
  float m, s;
  row_max_sum(xr, cols, vec, sm, ss, m, s);
  const int lbl = static_cast<int>(label[blockIdx.x]);     // truncates
  const float gv = g[blockIdx.x];
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    float4* g4 = reinterpret_cast<float4*>(gr);
    for (int c = threadIdx.x; c < cols / 4; c += kThreads) {
      const float4 v = x4[c];
      const int c0 = 4 * c;
      float4 o;
      o.x = (expf(v.x - m) / s - (c0 == lbl ? 1.f : 0.f)) * gv;
      o.y = (expf(v.y - m) / s - (c0 + 1 == lbl ? 1.f : 0.f)) * gv;
      o.z = (expf(v.z - m) / s - (c0 + 2 == lbl ? 1.f : 0.f)) * gv;
      o.w = (expf(v.w - m) / s - (c0 + 3 == lbl ? 1.f : 0.f)) * gv;
      g4[c] = o;
    }
    return;
  }
  for (int c = threadIdx.x; c < cols; c += kThreads)
    narrow(gr + c,
           (expf(widen(xr[c]) - m) / s - (c == lbl ? 1.f : 0.f)) * gv);
}

// the same rows: logsumexp(x) - x[label]
template <int NL>
__global__ void __launch_bounds__(kThreads)
    xent_loss_bf16_regs_kernel(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ label,
                               float* __restrict__ loss, int cols) {
  __shared__ float scratch[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const uint4* x8 = reinterpret_cast<const uint4*>(x + off);
  const int n8 = cols / kVec;
  float v[NL][kVec];
  float m, s;
  regs_row_exp_sum<NL>(x8, n8, v, scratch, m, s);
  if (threadIdx.x == 0) {
    const int lbl = static_cast<int>(label[blockIdx.x]);   // truncates
    const float tgt = (lbl >= 0 && lbl < cols) ? widen(x[off + lbl]) : 0.f;
    loss[blockIdx.x] = logf(s) + m - tgt;
  }
}

// the same rows: (softmax(x) - onehot(label)) * g, rounded once, written
// 16 bytes at a time
template <int NL>
__global__ void __launch_bounds__(kThreads)
    xent_loss_grad_bf16_regs_kernel(const __nv_bfloat16* __restrict__ x,
                                    const float* __restrict__ label,
                                    const float* __restrict__ g,
                                    __nv_bfloat16* __restrict__ grad,
                                    int cols) {
  __shared__ float scratch[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const uint4* x8 = reinterpret_cast<const uint4*>(x + off);
  uint4* g8 = reinterpret_cast<uint4*>(grad + off);
  const int n8 = cols / kVec;
  const int lbl = static_cast<int>(label[blockIdx.x]);     // truncates
  const float gv = g[blockIdx.x];
  float v[NL][kVec];
  float m, s;
  regs_row_exp_sum<NL>(x8, n8, v, scratch, m, s);
#pragma unroll
  for (int j = 0; j < NL; ++j) {
    const int c = threadIdx.x + j * kThreads;
    if (c < n8) {
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        v[j][i] = (v[j][i] / s - (c * kVec + i == lbl ? 1.f : 0.f)) * gv;
      g8[c] = store8(v[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    softmax_bwd_kernel(const float* __restrict__ p,
                       const float* __restrict__ dy, float* __restrict__ dx,
                       int cols, bool vec) {
  __shared__ float scratch[kWarps];
  const size_t off = static_cast<size_t>(blockIdx.x) * cols;
  const float* pr = p + off;
  const float* dyr = dy + off;
  float* dxr = dx + off;
  float dot = 0.f;
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(pr);
    const float4* d4 = reinterpret_cast<const float4*>(dyr);
    for (int c = threadIdx.x; c < cols / 4; c += kThreads) {
      const float4 a = p4[c], b = d4[c];
      dot += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads) dot += pr[c] * dyr[c];
  }
  dot = block_reduce<false>(dot, scratch);
  if (vec) {
    const float4* p4 = reinterpret_cast<const float4*>(pr);
    const float4* d4 = reinterpret_cast<const float4*>(dyr);
    float4* o4 = reinterpret_cast<float4*>(dxr);
    for (int c = threadIdx.x; c < cols / 4; c += kThreads) {
      const float4 a = p4[c], b = d4[c];
      o4[c] = make_float4(a.x * (b.x - dot), a.y * (b.y - dot),
                          a.z * (b.z - dot), a.w * (b.w - dot));
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads)
      dxr[c] = pr[c] * (dyr[c] - dot);
  }
}

// float4 access needs every row start 16-byte aligned
__host__ bool rows_vectorizable(int cols, const void* a, const void* b,
                                const void* c) {
  return cols % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// the 16-byte loads a thread makes when a bf16 registers kernel takes
// the rows at `a` and `b` (cols % 8 == 0, at most 8192, 16-byte
// aligned); 0 when it does not
__host__ int bf16_row_loads(int cols, const void* a, const void* b) {
  const int loads = (cols / kVec + kThreads - 1) / kThreads;
  return cols % kVec == 0 && loads <= kMaxVecLoads &&
                 rows_vectorizable(cols, a, b, b)
             ? loads
             : 0;
}

// softmax_rows' bodies, the entry points' `path`
// (kernels/softmax_xent.py::_ROWS_PATH)
constexpr int kTwoPass = 0;
constexpr int kRegs = 1;

}  // namespace

// fp32 x and p on the body kernels/softmax_xent.py::_plan names: path
// kRegs with `loads` float4 loads a thread, or kTwoPass with float4
// accesses (loads 1) or scalar ones (loads 0); a pair the row does not
// allow is refused
extern "C" int mxt_softmax_rows_f32(const float* x, float* p, int rows,
                                    int cols, int path, int loads,
                                    cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = rows_vectorizable(cols, x, p, p);
  if (path == kRegs && vec && cols <= 4 * kThreads * loads) {
    switch (loads) {
      case 1:
        softmax_rows_f32_regs_kernel<1><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      case 2:
        softmax_rows_f32_regs_kernel<2><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      case 4:
        softmax_rows_f32_regs_kernel<4><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      case 8:
        softmax_rows_f32_regs_kernel<8><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      case 10:
        softmax_rows_f32_regs_kernel<10><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      case 16:
        softmax_rows_f32_regs_kernel<16><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (path == kTwoPass && (loads == 0 || (loads == 1 && vec))) {
    softmax_rows_two_pass_kernel<float><<<rows, kThreads, 0, stream>>>(
        x, p, cols, loads == 1);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_xent_grad_from_probs_f32(const float* p,
                                            const float* label, float* grad,
                                            int rows, int cols, float scale,
                                            cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    xent_grad_kernel<float><<<rows, kThreads, 0, stream>>>(
        p, label, grad, cols, scale, false);
  return static_cast<int>(cudaGetLastError());
}

// bf16 x and p on the body _plan names: kRegs with `loads` 16-byte
// loads a thread (8 values each), or kTwoPass (loads 0, one element at
// a time); a pair the row does not allow is refused
extern "C" int mxt_softmax_rows_bf16(const __nv_bfloat16* x,
                                     __nv_bfloat16* p, int rows, int cols,
                                     int path, int loads,
                                     cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  if (path == kRegs && cols % kVec == 0 && rows_vectorizable(cols, x, p, p) &&
      cols <= kVec * kThreads * loads) {
    switch (loads) {
      case 1:
        softmax_rows_bf16_regs_kernel<1><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      case 2:
        softmax_rows_bf16_regs_kernel<2><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      case 4:
        softmax_rows_bf16_regs_kernel<4><<<rows, kThreads, 0, stream>>>(
            x, p, cols);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (path == kTwoPass && loads == 0) {
    softmax_rows_two_pass_kernel<__nv_bfloat16>
        <<<rows, kThreads, 0, stream>>>(x, p, cols, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 p and grad, float32 labels
extern "C" int mxt_xent_grad_from_probs_bf16(const __nv_bfloat16* p,
                                             const float* label,
                                             __nv_bfloat16* grad, int rows,
                                             int cols, float scale,
                                             cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    xent_grad_kernel<__nv_bfloat16><<<rows, kThreads, 0, stream>>>(
        p, label, grad, cols, scale,
        cols % kVec == 0 && rows_vectorizable(cols, p, grad, grad));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_softmax_xent_loss_f32(const float* x, const float* label,
                                         float* loss, int rows, int cols,
                                         cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    xent_loss_kernel<float><<<rows, kThreads, 0, stream>>>(
        x, label, loss, cols, rows_vectorizable(cols, x, x, x));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_softmax_xent_loss_grad_f32(const float* x,
                                              const float* label,
                                              const float* g, float* grad,
                                              int rows, int cols,
                                              cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    xent_loss_grad_kernel<float><<<rows, kThreads, 0, stream>>>(
        x, label, g, grad, cols, rows_vectorizable(cols, x, grad, grad));
  return static_cast<int>(cudaGetLastError());
}

// bf16 x, float32 label and loss; the registers kernel where the row
// fits it
extern "C" int mxt_softmax_xent_loss_bf16(const __nv_bfloat16* x,
                                          const float* label, float* loss,
                                          int rows, int cols,
                                          cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  const int loads = bf16_row_loads(cols, x, x);
  if (loads == 1)
    xent_loss_bf16_regs_kernel<1><<<rows, kThreads, 0, stream>>>(
        x, label, loss, cols);
  else if (loads == 2)
    xent_loss_bf16_regs_kernel<2><<<rows, kThreads, 0, stream>>>(
        x, label, loss, cols);
  else if (loads > 2)
    xent_loss_bf16_regs_kernel<4><<<rows, kThreads, 0, stream>>>(
        x, label, loss, cols);
  else
    xent_loss_kernel<__nv_bfloat16><<<rows, kThreads, 0, stream>>>(
        x, label, loss, cols, false);
  return static_cast<int>(cudaGetLastError());
}

// bf16 x and grad, float32 label and g; the registers kernel where the
// row fits it
extern "C" int mxt_softmax_xent_loss_grad_bf16(const __nv_bfloat16* x,
                                               const float* label,
                                               const float* g,
                                               __nv_bfloat16* grad, int rows,
                                               int cols,
                                               cudaStream_t stream) {
  if (rows <= 0 || cols <= 0) return static_cast<int>(cudaGetLastError());
  const int loads = bf16_row_loads(cols, x, grad);
  if (loads == 1)
    xent_loss_grad_bf16_regs_kernel<1><<<rows, kThreads, 0, stream>>>(
        x, label, g, grad, cols);
  else if (loads == 2)
    xent_loss_grad_bf16_regs_kernel<2><<<rows, kThreads, 0, stream>>>(
        x, label, g, grad, cols);
  else if (loads > 2)
    xent_loss_grad_bf16_regs_kernel<4><<<rows, kThreads, 0, stream>>>(
        x, label, g, grad, cols);
  else
    xent_loss_grad_kernel<__nv_bfloat16><<<rows, kThreads, 0, stream>>>(
        x, label, g, grad, cols, false);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_softmax_rows_bwd_f32(const float* p, const float* dy,
                                        float* dx, int rows, int cols,
                                        cudaStream_t stream) {
  if (rows > 0 && cols > 0)
    softmax_bwd_kernel<<<rows, kThreads, 0, stream>>>(
        p, dy, dx, cols, rows_vectorizable(cols, p, dy, dx));
  return static_cast<int>(cudaGetLastError());
}
