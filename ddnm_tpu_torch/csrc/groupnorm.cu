// GroupNorm (+ optional FiLM, + optional SiLU) over NHWC activations.
//
// Replaces the Pallas kernels of ddnm_tpu/ops/groupnorm.py:
//   gn_stats_kernel    <- _stats_kernel / _pallas_stats (per-(B, C) fp32
//                         sum and sum of squares over H*W);
//   gn_finalize_kernel <- the XLA glue _effective_affine (per-group mean and
//                         rstd by the fast variance E[x^2] - mean^2 clamped
//                         at 0, folded into a per-(B, C) affine a, b, FiLM
//                         included);
//   gn_apply_kernel    <- _apply_kernel / _pallas_group_norm
//                         (y = x * a + b in fp32, cast, optional SiLU).
//
// What bounds it on an H100: memory. Each element costs a handful of
// flops, far below the ~295 flops per byte where the card turns compute
// bound, so the least time is the bytes moved (x read twice, y written
// once) over 3.35 TB/s. The design keeps every pass a single streaming
// read with coalesced loads: 32 neighbouring threads read 32 neighbouring
// channels of one pixel. On the TPU the stats pass carried its sums across
// a sequential grid; here blocks run in parallel and in no order, so each
// (batch, channel block, row block) writes its own fp32 partial sums to a
// scratch buffer and a second small kernel reduces them in a fixed order.
// No fp32 atomics anywhere: every launch gives the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's cast
}

constexpr int kStatsLanes = 8;  // pixel lanes per stats block (threadIdx.y)

// grid (ceil(C / 32), R, B), block (32, kStatsLanes).
// partial layout: (B, R, 2, C) fp32, [.., 0, c] = sum x, [.., 1, c] = sum x^2.
template <typename T>
__global__ void gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                                int hw, int c_total, int rows_per_block) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const int p0 = r * rows_per_block;
  const int p1 = min(hw, p0 + rows_per_block);
  float s1 = 0.f, s2 = 0.f;
  if (c < c_total) {
    const T* xb = x + (size_t)b * hw * c_total + c;
    for (int p = p0 + threadIdx.y; p < p1; p += kStatsLanes) {
      const float v = to_f(xb[(size_t)p * c_total]);
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ float sh1[kStatsLanes][33];
  __shared__ float sh2[kStatsLanes][33];
  sh1[threadIdx.y][threadIdx.x] = s1;
  sh2[threadIdx.y][threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.y == 0 && c < c_total) {
    float t1 = 0.f, t2 = 0.f;
    for (int i = 0; i < kStatsLanes; ++i) {
      t1 += sh1[i][threadIdx.x];
      t2 += sh2[i][threadIdx.x];
    }
    float* out = partial + ((size_t)b * gridDim.y + r) * 2 * c_total;
    out[c] = t1;
    out[c_total + c] = t2;
  }
}

// grid (G, B), block 32: one warp per (batch, group). Lane l sums elements
// l, l + 32, ... of the group's R * (C / G) partials, then a fixed xor tree
// combines the lanes; the order never changes between launches.
__global__ void gn_finalize_kernel(const float* __restrict__ partial,
                                   const float* __restrict__ gamma,
                                   const float* __restrict__ beta,
                                   const float* __restrict__ film_scale,
                                   const float* __restrict__ film_shift,
                                   float* __restrict__ a_out, float* __restrict__ b_out,
                                   int rows, int c_total, float n_per_group, float eps) {
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int cpg = c_total / gridDim.x;
  const int lane = threadIdx.x;
  const float* pb = partial + (size_t)b * rows * 2 * c_total + (size_t)g * cpg;
  float s1 = 0.f, s2 = 0.f;
  const int n = rows * cpg;
  for (int i = lane; i < n; i += 32) {
    const int r = i / cpg;
    const int j = i - r * cpg;
    const float* pr = pb + (size_t)r * 2 * c_total;
    s1 += pr[j];
    s2 += pr[c_total + j];
  }
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean = s1 / n_per_group;
  const float var = fmaxf(s2 / n_per_group - mean * mean, 0.f);
  const float rstd = 1.f / sqrtf(var + eps);
  for (int j = lane; j < cpg; j += 32) {
    const int c = g * cpg + j;
    float a = rstd * gamma[c];
    float bb = beta[c] - mean * a;
    if (film_scale != nullptr) {
      const float fs = 1.f + film_scale[(size_t)b * c_total + c];
      a = a * fs;
      bb = bb * fs + film_shift[(size_t)b * c_total + c];
    }
    a_out[(size_t)b * c_total + c] = a;
    b_out[(size_t)b * c_total + c] = bb;
  }
}

// grid (blocks, B), block 256; grid-stride over the H*W*C elements of one
// image. hwc < 2^31 (checked by the wrapper).
template <typename T>
__global__ void gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                                const float* __restrict__ bias, T* __restrict__ y,
                                int hwc, int c_total, int swish) {
  const int b = blockIdx.y;
  const T* xb = x + (size_t)b * hwc;
  T* yb = y + (size_t)b * hwc;
  const float* ab = a + (size_t)b * c_total;
  const float* bb = bias + (size_t)b * c_total;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < hwc; i += gridDim.x * blockDim.x) {
    const int c = i % c_total;
    T out = from_f<T>(to_f(xb[i]) * ab[c] + bb[c]);
    if (swish) {
      const float f = to_f(out);
      out = from_f<T>(f * (1.f / (1.f + expf(-f))));
    }
    yb[i] = out;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Every entry returns cudaGetLastError().
int ddnm_gn_stats(const void* x, void* partial, int batch, int hw, int c_total,
                  int rows_per_block, int dtype, void* stream) {
  const int rows = (hw + rows_per_block - 1) / rows_per_block;
  dim3 grid((c_total + 31) / 32, rows, batch);
  dim3 block(32, kStatsLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gn_stats_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(partial), hw, c_total,
        rows_per_block);
  } else {
    gn_stats_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(partial), hw,
        c_total, rows_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

int ddnm_gn_finalize(const void* partial, const void* gamma, const void* beta,
                     const void* film_scale, const void* film_shift, void* a_out,
                     void* b_out, int batch, int rows, int c_total, int groups,
                     float n_per_group, float eps, void* stream) {
  dim3 grid(groups, batch);
  gn_finalize_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(film_scale),
      static_cast<const float*>(film_shift), static_cast<float*>(a_out),
      static_cast<float*>(b_out), rows, c_total, n_per_group, eps);
  return static_cast<int>(cudaGetLastError());
}

int ddnm_gn_apply(const void* x, const void* a, const void* b, void* y, int batch,
                  int hwc, int c_total, int swish, int dtype, void* stream) {
  int blocks = (hwc + 255) / 256;
  if (blocks > 2048) blocks = 2048;
  dim3 grid(blocks, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    gn_apply_kernel<float><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(y), hwc, c_total, swish);
  } else {
    gn_apply_kernel<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), hwc, c_total,
        swish);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ddnm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
