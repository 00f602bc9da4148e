// Row-wise RMSNorm and LayerNorm, forward and backward, for Hopper
// (sm_90a), in fp32 and bf16.
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
// The forwards are templated on the element type E (float or
// __nv_bfloat16; x, gamma, beta and y share it).  Every element is
// widened to fp32 on load, the statistics and the affine map are fp32,
// and a bf16 output is rounded to nearest even (__float2bfloat16_rn,
// astype(bfloat16)'s rounding), as the TPU kernel casts its fp32 tile
// to o_ref.dtype (norm.py:51).  bf16 rows whose width is a multiple of
// 8 and whose pointers are 16-byte aligned are read and written 16
// bytes (8 values) a lane at a time, so a warp moves 512 contiguous
// bytes per access; other bf16 rows, and every fp32 row, go one
// element a lane (the fp32 access pattern of PR 1, unchanged).  bf16
// halves the bytes, so its bound halves with them.
//
// The backwards are bound by bytes too: x and dy read once, dx written
// once.  Three paths, which the wrapper's planner picks
// (kernels/norm.py::_bwd_plan) and the entry point checks: v3 (below)
// for bf16 rows on 16-byte chunks, and
//   v2, for rows of width <= 1024, width % 4 == 0 and every pointer on
//     a 4-element chunk (16 bytes fp32, 8 bytes bf16): a warp holds its
//     row of x and dy in registers as fp32, loaded a 4-column chunk at a
//     time (float4, or 8 bytes of bf16 widened in registers; lane l owns
//     the chunks l, l + 32, ...),
//     issues all of a row's loads before its first reduction and the
//     next row's before the current row's reductions, and computes the
//     statistics, mean(w) and mean(w*xhat) from registers; gamma is
//     loaded once a warp.  A warp takes rows_per_warp rows, kV2Warps
//     apart, so at each step a CTA's warps read neighbouring rows.
//   v1, any other row: a warp per row, lanes 32 floats apart with scalar
//     loads, rows_per_warp consecutive rows a warp, the row re-read from
//     L1/L2 for each pass.
// The weight gradients stay out of device memory until a CTA's end: each
// lane sums dgamma (and dbeta) over its rows for its own columns, the
// CTA adds its warps' rows in warp order through shared memory and
// writes one partial row, and sum_partials_kernel, launched by the same
// entry point, adds the CTAs' rows column by column in a fixed order.
// No floating-point atomics, so the same inputs give the same bits on
// every launch.
//
// The backwards are templated on the element type E of x, gamma, dy, dx
// and the weight gradients, as the forwards are.  bf16 (the TPU kernels
// _rms_bwd_kernel / _ln_bwd_kernel on bf16 tiles, norm.py:85 _rms_bwd
// and :158 _ln_bwd) widens every element to fp32 on load and runs the
// fp32 body's arithmetic in the same order; dx is rounded to nearest
// even once, the per-CTA partials stay fp32, and sum_partials_kernel
// rounds dgamma and dbeta once after the fp32 sum, as the reference
// takes jnp.sum(partials).astype(gamma.dtype).  v2's row held in
// registers is the widened fp32 row, so its register budget is fp32's.
//
// v3, the bf16 backward (the TPU kernels _rms_bwd_kernel and
// _ln_bwd_kernel on bf16 tiles), for bf16 rows of width <= 1024, width
// % 8 == 0 and x, gamma, dy and dx 16-byte aligned.  Bound: bytes, 2
// an element: x and dy read once, dx written once (at 4096 x 512, 12.6
// MB, 3.8 us at 3.35 TB/s).  v2 widened a bf16 row into fp32's
// registers, so an SM held one 8-warp CTA, each warp one row ahead:
// about 16 KB of loads in flight an SM, where keeping HBM busy takes
// about 25 KB.  v3 holds the rows packed instead:
//   * each lane moves 16 bytes (8 values) an access (uint4), chunk c =
//     lane + 32 j of the row's width / 8;
//   * x and dy stay bf16 bits in registers (a 512-wide row of both: 16
//     registers a lane, against 32 widened) and are widened, a shift,
//     at each use; the passes read the registers, never memory again;
//   * a warp keeps a ring of v3_depth rows in registers: every ring
//     row's loads are issued before the first row's reductions, and a
//     row's slot is refilled as soon as the row is done;
//   * RMSNorm fits two 8-warp CTAs an SM under a 128-register cap
//     (__launch_bounds__(256, 2), width <= 512): at 4096 x 512, 16
//     warps an SM with both their rows in flight, 64 KB of loads an SM.
//     LayerNorm spills under that cap and takes one CTA an SM (157
//     registers), 4 rows a warp, 2 in flight; it folds the variance and
//     mean(w * xhat) = r * mean(w * (x - mu)) into one pass, so a row
//     takes two rounds of shuffles, not three.  Width 1024 takes one
//     CTA an SM for both.
// The weight gradients leave the CTA as v2's do: each lane's fp32
// column sums, the warps added in warp order through shared memory, one
// partial row a CTA, sum_partials_kernel, one rounding.  At the
// training shape the call sits about 2.5 (RMSNorm) and 3.5 (LayerNorm)
// us above the floor of its two dependent launches (PERF.md, section 6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 4;   // forwards and the v1 backward
constexpr int kV2Warps = 8;         // the v2 backward's CTA
constexpr int kV2MaxChunks = 8;     // float4 chunks a lane: width <= 1024
constexpr int kV3Warps = 8;         // the v3 backward's CTA
constexpr int kV3MaxChunks = 4;     // 16-byte chunks a lane: width <= 1024
constexpr int kSumWarps = 16;       // sum_partials_kernel's CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of bf16 (8 values): widen on load, round to nearest even on
// store.  A bf16 is the top half of an fp32, so widening is a shift.
constexpr int kVec = 8;

__device__ __forceinline__ void unpack8(const uint4& u, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return u;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  unpack8(*reinterpret_cast<const uint4*>(p), v);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = pack8(v);
}

// y = x * r * gamma with r = rsqrt(mean(x^2) + eps); vec: 16-byte
// chunks (bf16 only, width % 8 == 0, aligned rows)
template <typename E>
__global__ void rms_norm_kernel(const E* __restrict__ x,
                                const E* __restrict__ gamma,
                                E* __restrict__ y, int rows, int width,
                                float eps, bool vec) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const E* xr = x + static_cast<size_t>(row) * width;
  E* yr = y + static_cast<size_t>(row) * width;
  float ss = 0.f;
  if constexpr (sizeof(E) == 2) {
    if (vec) {
      for (int c = lane * kVec; c < width; c += 32 * kVec) {
        float v[kVec];
        load8(xr + c, v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) ss += v[i] * v[i];
      }
      const float r = rsqrtf(warp_sum(ss) / width + eps);
      for (int c = lane * kVec; c < width; c += 32 * kVec) {
        float v[kVec], g[kVec];
        load8(xr + c, v);
        load8(gamma + c, g);
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[i] = v[i] * r * g[i];
        store8(yr + c, v);
      }
      return;
    }
  }
  for (int c = lane; c < width; c += 32) {
    const float v = widen(xr[c]);
    ss += v * v;
  }
  const float r = rsqrtf(warp_sum(ss) / width + eps);
  for (int c = lane; c < width; c += 32)
    narrow(yr + c, widen(xr[c]) * r * widen(gamma[c]));
}

// y = (x - mu) * rsqrt(mean((x - mu)^2) + eps) * gamma + beta
template <typename E>
__global__ void layer_norm_kernel(const E* __restrict__ x,
                                  const E* __restrict__ gamma,
                                  const E* __restrict__ beta,
                                  E* __restrict__ y, int rows, int width,
                                  float eps, bool vec) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const E* xr = x + static_cast<size_t>(row) * width;
  E* yr = y + static_cast<size_t>(row) * width;
  if constexpr (sizeof(E) == 2) {
    if (vec) {
      float s = 0.f;
      for (int c = lane * kVec; c < width; c += 32 * kVec) {
        float v[kVec];
        load8(xr + c, v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) s += v[i];
      }
      const float mu = warp_sum(s) / width;
      float sq = 0.f;
      for (int c = lane * kVec; c < width; c += 32 * kVec) {
        float v[kVec];
        load8(xr + c, v);
#pragma unroll
        for (int i = 0; i < kVec; ++i) sq += (v[i] - mu) * (v[i] - mu);
      }
      const float r = rsqrtf(warp_sum(sq) / width + eps);
      for (int c = lane * kVec; c < width; c += 32 * kVec) {
        float v[kVec], g[kVec], b[kVec];
        load8(xr + c, v);
        load8(gamma + c, g);
        load8(beta + c, b);
#pragma unroll
        for (int i = 0; i < kVec; ++i) v[i] = (v[i] - mu) * r * g[i] + b[i];
        store8(yr + c, v);
      }
      return;
    }
  }
  float s = 0.f;
  for (int c = lane; c < width; c += 32) s += widen(xr[c]);
  const float mu = warp_sum(s) / width;
  float sq = 0.f;
  for (int c = lane; c < width; c += 32) {
    const float d = widen(xr[c]) - mu;
    sq += d * d;
  }
  const float r = rsqrtf(warp_sum(sq) / width + eps);
  for (int c = lane; c < width; c += 32)
    narrow(yr + c,
           (widen(xr[c]) - mu) * r * widen(gamma[c]) + widen(beta[c]));
}

// ---- backward ----------------------------------------------------------

// the two sums of a row reduced side by side: two independent shuffle
// chains, one round of latency
__device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
}

// three sums side by side
__device__ __forceinline__ void warp_sum3(float& a, float& b, float& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
    c += __shfl_xor_sync(kFull, c, o);
  }
}

// let the entry point's sum_partials_kernel launch now (programmatic
// dependent launch); it waits for this grid to finish before reading
__device__ __forceinline__ void release_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// a 4-element chunk of a row: a float4, or 8 bytes of bf16
template <typename E>
using chunk_t = std::conditional_t<sizeof(E) == 4, float4, uint2>;

__device__ __forceinline__ void unpack(const float4& a, float (&v)[4]) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
// a bf16 is the top half of an fp32: widening is a shift
__device__ __forceinline__ void unpack(const uint2& a, float (&v)[4]) {
  v[0] = __uint_as_float(a.x << 16);
  v[1] = __uint_as_float(a.x & 0xffff0000u);
  v[2] = __uint_as_float(a.y << 16);
  v[3] = __uint_as_float(a.y & 0xffff0000u);
}
__device__ __forceinline__ void pack(const float (&v)[4], float4& a) {
  a = make_float4(v[0], v[1], v[2], v[3]);
}
// round to nearest even, as astype(bfloat16)
__device__ __forceinline__ void pack(const float (&v)[4], uint2& a) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  a.x = *reinterpret_cast<const uint32_t*>(&lo);
  a.y = *reinterpret_cast<const uint32_t*>(&hi);
}

// a lane's NV 4-element chunks of a row (chunk c = lane + 32 j of n4),
// widened to fp32; chunks past the row read as 0
template <int NV, typename C>
__device__ __forceinline__ void load_chunks(const C* __restrict__ src,
                                            int n4, int lane,
                                            float (&v)[NV][4]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    C a = {};
    if (c < n4) a = src[c];
    unpack(a, v[j]);
  }
}

template <int NV, typename C>
__device__ __forceinline__ void store_chunks(C* dst, int n4, int lane,
                                             const float (&v)[NV][4]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c < n4) {
      C a;
      pack(v[j], a);
      dst[c] = a;   // one 16- or 8-byte store
    }
  }
}

// v2: one row of dx from the row held in registers (xv, dv; gamma g),
// adding the row's dgamma (ag) and dbeta (ab, LayerNorm) contributions
// to the lane's column sums.  Chunks past the row hold x = dy = 0, which
// add nothing to any sum but (x - mu)^2, where they are masked.
template <int NV, bool LN, typename C>
__device__ __forceinline__ void bwd_row_v2(const float (&xv)[NV][4],
                                           const float (&dv)[NV][4],
                                           const float (&g)[NV][4],
                                           float (&ag)[NV][4],
                                           float (&ab)[NV][4], C* dxr,
                                           int n4, int lane, int width,
                                           float eps) {
  float o[NV][4];
  if constexpr (LN) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) s += xv[j][k];
    const float mu = warp_sum(s) / width;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (lane + 32 * j < n4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float d = xv[j][k] - mu;
          sq += d * d;
        }
      }
    const float r = rsqrtf(warp_sum(sq) / width + eps);
    float sw = 0.f, swx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float w = dv[j][k] * g[j][k];
        sw += w;
        swx += w * ((xv[j][k] - mu) * r);
      }
    warp_sum2(sw, swx);
    const float mw = sw / width;
    const float mwx = swx / width;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = dv[j][k];
        const float xhat = (xv[j][k] - mu) * r;
        o[j][k] = r * (d * g[j][k] - mw - xhat * mwx);
        ag[j][k] += d * xhat;
        ab[j][k] += d;
      }
  } else {
    float ss = 0.f, swx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = xv[j][k];
        ss += v * v;
        swx += dv[j][k] * g[j][k] * v;
      }
    warp_sum2(ss, swx);
    const float r = rsqrtf(ss / width + eps);
    const float mwx = swx / width;
    const float r3 = r * r * r;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float v = xv[j][k];
        const float d = dv[j][k];
        o[j][k] = r * (d * g[j][k]) - r3 * v * mwx;
        ag[j][k] += d * v * r;
      }
  }
  store_chunks<NV>(dxr, n4, lane, o);
}

// the CTA's partial weight-gradient rows, from each warp's column sums in
// wrows ([LN ? 2 : 1][W][n4] float4s): thread t adds the W warps' rows
// of its columns in warp order and writes partial row blockIdx.x
template <int W, bool LN>
__device__ __forceinline__ void write_partials(const float4* wrows, int n4,
                                               float* __restrict__ dg_part,
                                               float* __restrict__ db_part) {
  for (int c = threadIdx.x; c < n4; c += 32 * W) {
#pragma unroll
    for (int t = 0; t < (LN ? 2 : 1); ++t) {
      const float4* src = wrows + t * W * n4 + c;
      float4 s = src[0];
#pragma unroll
      for (int w = 1; w < W; ++w) {
        const float4 a = src[w * n4];
        s.x += a.x;
        s.y += a.y;
        s.z += a.z;
        s.w += a.w;
      }
      reinterpret_cast<float4*>(t ? db_part : dg_part)
          [static_cast<size_t>(blockIdx.x) * n4 + c] = s;
    }
  }
}

// v2 (see the head of the file).  Warp w of CTA b takes rows
// b * kV2Warps * rows_per_warp + w + i * kV2Warps, i < rows_per_warp;
// the CTA writes partial row b of dg_part (and db_part).  NV: 4-element
// chunks a lane, a power of two with 128 NV >= width.
template <int NV, bool LN, typename E>
__global__ void __launch_bounds__(32 * kV2Warps)
norm_bwd_v2_kernel(const E* __restrict__ x, const E* __restrict__ gamma,
                   const E* __restrict__ dy, E* __restrict__ dx,
                   float* __restrict__ dg_part, float* __restrict__ db_part,
                   int rows, int width, float eps, int rows_per_warp) {
  using C = chunk_t<E>;
  extern __shared__ float4 wrows[];   // [LN ? 2 : 1][kV2Warps][width / 4]
  release_dependents();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n4 = width / 4;
  const C* x4 = reinterpret_cast<const C*>(x);
  const C* dy4 = reinterpret_cast<const C*>(dy);
  float g[NV][4], ag[NV][4], ab[NV][4], xv[NV][4], dv[NV][4];
  load_chunks<NV>(reinterpret_cast<const C*>(gamma), n4, lane, g);
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) ag[j][k] = ab[j][k] = 0.f;
  int row = blockIdx.x * kV2Warps * rows_per_warp + warp;
  if (row < rows) {
    load_chunks<NV>(x4 + static_cast<size_t>(row) * n4, n4, lane, xv);
    load_chunks<NV>(dy4 + static_cast<size_t>(row) * n4, n4, lane, dv);
  }
  for (int i = 0; i < rows_per_warp && row < rows; ++i, row += kV2Warps) {
    const int next = row + kV2Warps;
    const bool more = i + 1 < rows_per_warp && next < rows;
    float xn[NV][4], dn[NV][4];
    if (more) {   // in flight while this row reduces
      load_chunks<NV>(x4 + static_cast<size_t>(next) * n4, n4, lane, xn);
      load_chunks<NV>(dy4 + static_cast<size_t>(next) * n4, n4, lane, dn);
    }
    bwd_row_v2<NV, LN>(xv, dv, g, ag, ab,
                       reinterpret_cast<C*>(dx) +
                           static_cast<size_t>(row) * n4,
                       n4, lane, width, eps);
    if (more) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          xv[j][k] = xn[j][k];
          dv[j][k] = dn[j][k];
        }
    }
  }
  store_chunks<NV>(wrows + warp * n4, n4, lane, ag);
  if constexpr (LN) store_chunks<NV>(wrows + (kV2Warps + warp) * n4, n4,
                                     lane, ab);
  __syncthreads();
  write_partials<kV2Warps, LN>(wrows, n4, dg_part, db_part);
}

// ---- v3: bf16 rows held packed (see the head of the file) --------------

// rows a warp holds in registers (32 registers of ring at every width),
// and CTAs an SM: two under a 128-register cap for RMSNorm to width 512;
// one for LayerNorm, whose extra column sums and statistics spill under
// that cap, and for width 1024
template <int NV>
__host__ __device__ constexpr int v3_depth() { return NV == 1 ? 4 : 2; }
template <int NV, bool LN>
__host__ __device__ constexpr int v3_ctas_per_sm() {
  return !LN && NV <= 2 ? 2 : 1;
}

// a lane's NV 16-byte chunks of a row (chunk c = lane + 32 j of n8),
// packed; chunks past the row read as 0
template <int NV>
__device__ __forceinline__ void load_packed(const uint4* __restrict__ src,
                                            int n8, int lane,
                                            uint4 (&v)[NV]) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < n8 ? src[c] : make_uint4(0u, 0u, 0u, 0u);
  }
}

// one row of dx from the packed row (xs, ds; gamma g widened), adding
// the row's dgamma (ag) and dbeta (ab, LayerNorm) contributions to the
// lane's column sums: v2's arithmetic in v2's order, 8 columns a chunk,
// but for LayerNorm's mean(w * xhat), taken as r * mean(w * (x - mu)) in
// the variance's pass.  Chunks past the row hold x = dy = gamma = 0,
// which add nothing to any sum but (x - mu)^2, where they are masked.
template <int NV, bool LN>
__device__ __forceinline__ void bwd_row_v3(const uint4 (&xs)[NV],
                                           const uint4 (&ds)[NV],
                                           const float (&g)[NV][kVec],
                                           float (&ag)[NV][kVec],
                                           float (&ab)[NV][kVec],
                                           uint4* __restrict__ dxr, int n8,
                                           int lane, int width, float eps) {
  float v[kVec], d[kVec], o[kVec];
  if constexpr (LN) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack8(xs[j], v);
#pragma unroll
      for (int k = 0; k < kVec; ++k) s += v[k];
    }
    const float mu = warp_sum(s) / width;
    // the variance and both means of dx's formula in one pass and one
    // round of shuffles: mean(w * xhat) = r * mean(w * (x - mu))
    float sq = 0.f, sw = 0.f, swe = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bool in = lane + 32 * j < n8;
      unpack8(xs[j], v);
      unpack8(ds[j], d);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float e = v[k] - mu;
        const float w = d[k] * g[j][k];
        if (in) sq += e * e;
        sw += w;
        swe += w * e;
      }
    }
    warp_sum3(sq, sw, swe);
    const float r = rsqrtf(sq / width + eps);
    const float mw = sw / width;
    const float mwx = r * swe / width;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack8(xs[j], v);
      unpack8(ds[j], d);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float xhat = (v[k] - mu) * r;
        o[k] = r * (d[k] * g[j][k] - mw - xhat * mwx);
        ag[j][k] += d[k] * xhat;
        ab[j][k] += d[k];
      }
      if (lane + 32 * j < n8) dxr[lane + 32 * j] = pack8(o);
    }
  } else {
    float ss = 0.f, swx = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack8(xs[j], v);
      unpack8(ds[j], d);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        ss += v[k] * v[k];
        swx += d[k] * g[j][k] * v[k];
      }
    }
    warp_sum2(ss, swx);
    const float r = rsqrtf(ss / width + eps);
    const float mwx = swx / width;
    const float r3 = r * r * r;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      unpack8(xs[j], v);
      unpack8(ds[j], d);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        o[k] = r * (d[k] * g[j][k]) - r3 * v[k] * mwx;
        ag[j][k] += d[k] * v[k] * r;
      }
      if (lane + 32 * j < n8) dxr[lane + 32 * j] = pack8(o);
    }
  }
}

// v3.  Warp w of CTA b takes rows b * kV3Warps * rows_per_warp + w + i *
// kV3Warps, i < rows_per_warp, as v2; the CTA writes partial row b of
// dg_part (and db_part).  NV: 16-byte chunks a lane, a power of two with
// 256 NV >= width.
template <int NV, bool LN>
__global__ void __launch_bounds__(32 * kV3Warps, v3_ctas_per_sm<NV, LN>())
norm_bwd_v3_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ gamma,
                   const __nv_bfloat16* __restrict__ dy,
                   __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ dg_part, float* __restrict__ db_part,
                   int rows, int width, float eps, int rows_per_warp) {
  constexpr int D = v3_depth<NV>();
  extern __shared__ float4 wrows[];   // [LN ? 2 : 1][kV3Warps][width / 4]
  release_dependents();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n8 = width / kVec;
  const int n4 = width / 4;
  const uint4* x8 = reinterpret_cast<const uint4*>(x);
  const uint4* dy8 = reinterpret_cast<const uint4*>(dy);
  uint4* dx8 = reinterpret_cast<uint4*>(dx);
  const int first = blockIdx.x * kV3Warps * rows_per_warp + warp;
  // this warp's rows: first + i * kV3Warps < rows, i < rows_per_warp
  const int n = first < rows
      ? min(rows_per_warp, (rows - first + kV3Warps - 1) / kV3Warps) : 0;
  uint4 xs[D][NV], ds[D][NV];
#pragma unroll
  for (int s = 0; s < D; ++s)
    if (s < n) {
      const size_t off = static_cast<size_t>(first + s * kV3Warps) * n8;
      load_packed<NV>(x8 + off, n8, lane, xs[s]);
      load_packed<NV>(dy8 + off, n8, lane, ds[s]);
    }
  float g[NV][kVec], ag[NV][kVec], ab[NV][kVec];
  uint4 gp[NV];
  load_packed<NV>(reinterpret_cast<const uint4*>(gamma), n8, lane, gp);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    unpack8(gp[j], g[j]);
#pragma unroll
    for (int k = 0; k < kVec; ++k) ag[j][k] = ab[j][k] = 0.f;
  }
  for (int i = 0; i < n; i += D) {
#pragma unroll
    for (int s = 0; s < D; ++s) {
      if (i + s < n) {
        const size_t row = first + (i + s) * kV3Warps;
        bwd_row_v3<NV, LN>(xs[s], ds[s], g, ag, ab, dx8 + row * n8, n8,
                           lane, width, eps);
        if (i + s + D < n) {   // refill the slot: D - 1 rows stay ahead
          const size_t off = (row + D * kV3Warps) * n8;
          load_packed<NV>(x8 + off, n8, lane, xs[s]);
          load_packed<NV>(dy8 + off, n8, lane, ds[s]);
        }
      }
    }
  }
  // the lane's column sums as float4 pairs: chunk c is float4s 2c, 2c+1
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c < n8) {
#pragma unroll
      for (int t = 0; t < (LN ? 2 : 1); ++t) {
        const float* a = t ? ab[j] : ag[j];
        float4* dst = wrows + (t * kV3Warps + warp) * n4 + 2 * c;
        dst[0] = make_float4(a[0], a[1], a[2], a[3]);
        dst[1] = make_float4(a[4], a[5], a[6], a[7]);
      }
    }
  }
  __syncthreads();
  write_partials<kV3Warps, LN>(wrows, n4, dg_part, db_part);
}

// v1 (see the head of the file): warp w of CTA b takes rows
// (b * kWarpsPerBlock + w) * rows_per_warp + i, i < rows_per_warp; the
// CTA writes partial row b of dg_part (and db_part)
template <bool LN, typename E>
__global__ void norm_bwd_v1_kernel(const E* __restrict__ x,
                                   const E* __restrict__ gamma,
                                   const E* __restrict__ dy,
                                   E* __restrict__ dx,
                                   float* __restrict__ dg_part,
                                   float* __restrict__ db_part, int rows,
                                   int width, float eps, int rows_per_warp) {
  extern __shared__ float part[];   // dgamma, then dbeta, warp rows
  release_dependents();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* gpart = part + warp * width;
  float* bpart = part + (kWarpsPerBlock + warp) * width;
  for (int c = lane; c < width; c += 32) {
    gpart[c] = 0.f;
    if constexpr (LN) bpart[c] = 0.f;
  }
  const int row0 = (blockIdx.x * kWarpsPerBlock + warp) * rows_per_warp;
  for (int i = 0; i < rows_per_warp && row0 + i < rows; ++i) {
    const size_t off = static_cast<size_t>(row0 + i) * width;
    const E* xr = x + off;
    const E* dyr = dy + off;
    E* dxr = dx + off;
    if constexpr (LN) {
      float s = 0.f;
      for (int c = lane; c < width; c += 32) s += widen(xr[c]);
      const float mu = warp_sum(s) / width;
      float sq = 0.f;
      for (int c = lane; c < width; c += 32) {
        const float d = widen(xr[c]) - mu;
        sq += d * d;
      }
      const float r = rsqrtf(warp_sum(sq) / width + eps);
      float sw = 0.f, swx = 0.f;
      for (int c = lane; c < width; c += 32) {
        const float w = widen(dyr[c]) * widen(gamma[c]);
        sw += w;
        swx += w * ((widen(xr[c]) - mu) * r);
      }
      warp_sum2(sw, swx);
      const float mw = sw / width;
      const float mwx = swx / width;
      for (int c = lane; c < width; c += 32) {
        const float d = widen(dyr[c]);
        const float xhat = (widen(xr[c]) - mu) * r;
        narrow(dxr + c, r * (d * widen(gamma[c]) - mw - xhat * mwx));
        gpart[c] += d * xhat;
        bpart[c] += d;
      }
    } else {
      float ss = 0.f, swx = 0.f;
      for (int c = lane; c < width; c += 32) {
        const float v = widen(xr[c]);
        ss += v * v;
        swx += widen(dyr[c]) * widen(gamma[c]) * v;
      }
      warp_sum2(ss, swx);
      const float r = rsqrtf(ss / width + eps);
      const float mwx = swx / width;
      const float r3 = r * r * r;
      for (int c = lane; c < width; c += 32) {
        const float v = widen(xr[c]);
        const float d = widen(dyr[c]);
        narrow(dxr + c, r * (d * widen(gamma[c])) - r3 * v * mwx);
        gpart[c] += d * v * r;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += 32 * kWarpsPerBlock) {
#pragma unroll
    for (int t = 0; t < (LN ? 2 : 1); ++t) {
      const float* src = part + t * kWarpsPerBlock * width + c;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsPerBlock; ++w) s += src[w * width];
      (t ? db_part : dg_part)[static_cast<size_t>(blockIdx.x) * width + c] =
          s;
    }
  }
}

// out_t[c] = sum over p < parts of part_t[p][c], added in a fixed order:
// warp w adds rows w, w + kSumWarps, ... in turn, then warp 0 adds the
// warps' sums in warp order, and rounds the fp32 sum once to E.
// blockIdx.x: 32 columns; blockIdx.y: t, the dgamma (0) or dbeta (1)
// pair.  parts == 0 writes zeros.
template <typename E>
__global__ void __launch_bounds__(32 * kSumWarps)
sum_partials_kernel(const float* __restrict__ part0, E* __restrict__ out0,
                    const float* __restrict__ part1, E* __restrict__ out1,
                    int parts, int width) {
  __shared__ float sums[kSumWarps][32];
  wait_for_primary();
  const float* part = blockIdx.y ? part1 : part0;
  E* out = blockIdx.y ? out1 : out0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < width) {
#pragma unroll 8
    for (int p = warp; p < parts; p += kSumWarps)
      s += part[static_cast<size_t>(p) * width + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < width) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) t += sums[w][lane];
    narrow(out + c, t);
  }
}

int blocks_for(int rows) {
  return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// dynamic shared memory above the default 48 KB needs an opt-in
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool aligned(std::initializer_list<const void*> ptrs, uintptr_t bytes) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % bytes != 0) return false;
  return true;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  return aligned(ptrs, 16);
}

// 16-byte chunks for a bf16 row: the width a multiple of 8 and every
// pointer 16-byte aligned (then every row start is too)
bool vec_rows(int width, std::initializer_list<const void*> ptrs) {
  return width % kVec == 0 && aligned16(ptrs);
}

template <typename E>
int rms_norm(const E* x, const E* gamma, E* y, int rows, int width,
             float eps, bool vec, cudaStream_t stream) {
  if (rows > 0 && width > 0) {
    rms_norm_kernel<E><<<blocks_for(rows), 32 * kWarpsPerBlock, 0,
                         stream>>>(x, gamma, y, rows, width, eps, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int layer_norm(const E* x, const E* gamma, const E* beta, E* y, int rows,
               int width, float eps, bool vec, cudaStream_t stream) {
  if (rows > 0 && width > 0) {
    layer_norm_kernel<E><<<blocks_for(rows), 32 * kWarpsPerBlock, 0,
                           stream>>>(x, gamma, beta, y, rows, width, eps,
                                     vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// v2 takes rows of width <= 1024, width % 4 == 0 and the row tensors
// (x, gamma, dy, dx) on 4-element chunks, 16 bytes fp32 and 8 bytes
// bf16 (then every row start is too); the fp32 partials 16 bytes
template <typename E>
bool v2_rows(int width, std::initializer_list<const void*> row_ptrs,
             std::initializer_list<const void*> part_ptrs) {
  return width <= 32 * 4 * kV2MaxChunks && width % 4 == 0 &&
         aligned(row_ptrs, 4 * sizeof(E)) && aligned16(part_ptrs);
}

template <int NV, bool LN, typename E>
cudaError_t launch_v2(const E* x, const E* gamma, const E* dy, E* dx,
                      float* dg_part, float* db_part, int rows, int width,
                      float eps, int rows_per_warp, int ctas,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (LN ? 2 : 1) * kV2Warps * width;
  const cudaError_t err = allow_smem(norm_bwd_v2_kernel<NV, LN, E>, smem);
  if (err != cudaSuccess) return err;
  norm_bwd_v2_kernel<NV, LN, E><<<ctas, 32 * kV2Warps, smem, stream>>>(
      x, gamma, dy, dx, dg_part, db_part, rows, width, eps, rows_per_warp);
  return cudaGetLastError();
}

// v3 takes bf16 rows of width <= 1024, width % 8 == 0 and the row
// tensors (x, gamma, dy, dx) and the fp32 partials 16-byte aligned
template <typename E>
bool v3_rows(int width, std::initializer_list<const void*> row_ptrs,
             std::initializer_list<const void*> part_ptrs) {
  return sizeof(E) == 2 && width <= 32 * kVec * kV3MaxChunks &&
         width % kVec == 0 && aligned16(row_ptrs) && aligned16(part_ptrs);
}

template <int NV, bool LN>
cudaError_t launch_v3(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                      const __nv_bfloat16* dy, __nv_bfloat16* dx,
                      float* dg_part, float* db_part, int rows, int width,
                      float eps, int rows_per_warp, int ctas,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (LN ? 2 : 1) * kV3Warps * width;
  const cudaError_t err = allow_smem(norm_bwd_v3_kernel<NV, LN>, smem);
  if (err != cudaSuccess) return err;
  norm_bwd_v3_kernel<NV, LN><<<ctas, 32 * kV3Warps, smem, stream>>>(
      x, gamma, dy, dx, dg_part, db_part, rows, width, eps, rows_per_warp);
  return cudaGetLastError();
}

// dx, and the (width,) weight gradients dg (and db, LayerNorm): the
// path's kernel writes one fp32 partial row a CTA into dg_part
// (db_part), then sum_partials_kernel adds them and rounds once to E.
// path 0: v1, 1: v2, 2: v3 (bf16 only); the partial buffers hold
// ceil(rows / (warps * rows_per_warp)) rows, warps 4 (v1) or 8 (v2, v3).
template <bool LN, typename E>
int norm_bwd(const E* x, const E* gamma, const E* dy, E* dx, E* dg, E* db,
             float* dg_part, float* db_part, int rows, int width, float eps,
             int path, int rows_per_warp, cudaStream_t stream) {
  if (rows < 0 || width < 0 || rows_per_warp < 1 || path < 0 || path > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 1 &&
      !v2_rows<E>(width, {x, gamma, dy, dx}, {dg_part, db_part}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 2 &&
      !v3_rows<E>(width, {x, gamma, dy, dx}, {dg_part, db_part}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (width == 0) return static_cast<int>(cudaGetLastError());
  const int warps = path == 0 ? kWarpsPerBlock : path == 1 ? kV2Warps
                                                           : kV3Warps;
  const int per_cta = warps * rows_per_warp;
  const int ctas = static_cast<int>((static_cast<long long>(rows) + per_cta -
                                     1) / per_cta);
  cudaError_t err = cudaSuccess;
  if (ctas > 0 && path == 2) {
    if constexpr (sizeof(E) == 2) {   // v3_rows refused fp32 above
      const int chunks = (width / kVec + 31) / 32;
#define MXT_V3(NV)                                                         \
  launch_v3<NV, LN>(x, gamma, dy, dx, dg_part, db_part, rows, width, eps,  \
                    rows_per_warp, ctas, stream)
      err = chunks <= 1 ? MXT_V3(1) : chunks <= 2 ? MXT_V3(2) : MXT_V3(4);
#undef MXT_V3
    }
  } else if (ctas > 0 && path == 1) {
    const int chunks = (width / 4 + 31) / 32;
#define MXT_V2(NV)                                                         \
  launch_v2<NV, LN, E>(x, gamma, dy, dx, dg_part, db_part, rows, width,    \
                       eps, rows_per_warp, ctas, stream)
    err = chunks <= 1 ? MXT_V2(1) : chunks <= 2 ? MXT_V2(2)
        : chunks <= 4 ? MXT_V2(4) : MXT_V2(8);
#undef MXT_V2
  } else if (ctas > 0 && path == 0) {
    const size_t smem =
        sizeof(float) * (LN ? 2 : 1) * kWarpsPerBlock * width;
    err = allow_smem(norm_bwd_v1_kernel<LN, E>, smem);
    if (err == cudaSuccess) {
      norm_bwd_v1_kernel<LN, E><<<ctas, 32 * kWarpsPerBlock, smem,
                                  stream>>>(x, gamma, dy, dx, dg_part,
                                            db_part, rows, width, eps,
                                            rows_per_warp);
      err = cudaGetLastError();
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // the sums launch early and wait on the grid above (programmatic
  // dependent launch): no gap between the two
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((width + 31) / 32, LN ? 2 : 1);
  cfg.blockDim = dim3(32 * kSumWarps);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sum_partials_kernel<E>,
                           static_cast<const float*>(dg_part), dg,
                           static_cast<const float*>(db_part), db, ctas,
                           width);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int mxt_rms_norm_f32(const float* x, const float* gamma,
                                float* y, int rows, int width, float eps,
                                cudaStream_t stream) {
  return rms_norm(x, gamma, y, rows, width, eps, false, stream);
}

extern "C" int mxt_layer_norm_f32(const float* x, const float* gamma,
                                  const float* beta, float* y, int rows,
                                  int width, float eps,
                                  cudaStream_t stream) {
  return layer_norm(x, gamma, beta, y, rows, width, eps, false, stream);
}

extern "C" int mxt_rms_norm_bf16(const __nv_bfloat16* x,
                                 const __nv_bfloat16* gamma,
                                 __nv_bfloat16* y, int rows, int width,
                                 float eps, cudaStream_t stream) {
  return rms_norm(x, gamma, y, rows, width, eps,
                  vec_rows(width, {x, gamma, y}), stream);
}

extern "C" int mxt_layer_norm_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* gamma,
                                   const __nv_bfloat16* beta,
                                   __nv_bfloat16* y, int rows, int width,
                                   float eps, cudaStream_t stream) {
  return layer_norm(x, gamma, beta, y, rows, width, eps,
                    vec_rows(width, {x, gamma, beta, y}), stream);
}

// dx and dgamma of rms_norm; dg_part: (ctas, width) scratch, ctas as
// norm_bwd says
extern "C" int mxt_rms_norm_bwd_f32(const float* x, const float* gamma,
                                    const float* dy, float* dx, float* dg,
                                    float* dg_part, int rows, int width,
                                    float eps, int path, int rows_per_warp,
                                    cudaStream_t stream) {
  return norm_bwd<false, float>(x, gamma, dy, dx, dg, nullptr, dg_part,
                                nullptr, rows, width, eps, path,
                                rows_per_warp, stream);
}

// dx, dgamma and dbeta of layer_norm; dg_part, db_part: (ctas, width)
extern "C" int mxt_layer_norm_bwd_f32(const float* x, const float* gamma,
                                      const float* dy, float* dx, float* dg,
                                      float* db, float* dg_part,
                                      float* db_part, int rows, int width,
                                      float eps, int path, int rows_per_warp,
                                      cudaStream_t stream) {
  return norm_bwd<true, float>(x, gamma, dy, dx, dg, db, dg_part, db_part,
                               rows, width, eps, path, rows_per_warp, stream);
}

// the same in bf16: x, gamma, dy, dx and the weight gradients bf16, the
// partials fp32 (v2 takes x, gamma, dy and dx 8-byte aligned, v3
// 16-byte)
extern "C" int mxt_rms_norm_bwd_bf16(const __nv_bfloat16* x,
                                     const __nv_bfloat16* gamma,
                                     const __nv_bfloat16* dy,
                                     __nv_bfloat16* dx, __nv_bfloat16* dg,
                                     float* dg_part, int rows, int width,
                                     float eps, int path, int rows_per_warp,
                                     cudaStream_t stream) {
  return norm_bwd<false, __nv_bfloat16>(x, gamma, dy, dx, dg, nullptr,
                                        dg_part, nullptr, rows, width, eps,
                                        path, rows_per_warp, stream);
}

extern "C" int mxt_layer_norm_bwd_bf16(const __nv_bfloat16* x,
                                       const __nv_bfloat16* gamma,
                                       const __nv_bfloat16* dy,
                                       __nv_bfloat16* dx, __nv_bfloat16* dg,
                                       __nv_bfloat16* db, float* dg_part,
                                       float* db_part, int rows, int width,
                                       float eps, int path,
                                       int rows_per_warp,
                                       cudaStream_t stream) {
  return norm_bwd<true, __nv_bfloat16>(x, gamma, dy, dx, dg, db, dg_part,
                                       db_part, rows, width, eps, path,
                                       rows_per_warp, stream);
}
