// Single-head attention over (B*, T, C) token grids: O = softmax(Q K^T * scale) V.
//
// Replaces the Pallas kernel ddnm_tpu/ops/attention.py (_attn_kernel /
// _pallas_attention): S = Q K^T * scale accumulated in fp32, a fp32 softmax,
// P cast to the type of V, then P V accumulated in fp32.
//
// The TPU kernel held a whole (T, T) score block and the whole (T, C) slabs
// in VMEM. That does not carry over: an H100 block has at most 227 KB of
// shared memory and registers are the scarce resource. So this is a
// flash-style online softmax. One block owns kBQ query rows of one slab and
// walks the keys in tiles of kBK, keeping a running row max m and row sum l
// and rescaling its fp32 output accumulator by exp(m_old - m_new) as each
// key tile arrives; the (T, T) scores never exist in memory. The head
// dimension of the DDPM UNet is C = 512, far more than a thread can hold,
// so it is tiled too: Q's tile sits in shared memory as fp32, K and V are
// streamed through shared memory kDC columns at a time, and each thread
// keeps its share of the (kBQ, C) accumulator in registers.
//
// Arithmetic is fp32 FMA on the CUDA cores, not TF32 tensor cores: TF32
// keeps about three decimal digits and would break the fp32 gate against
// the plain version. For bf16 inputs the unnormalised probabilities
// exp(s - m) are rounded to bf16 before the P V product (the Pallas kernel
// rounds the normalised softmax; the two roundings differ by at most one
// bf16 ulp of each probability), while l sums the unrounded values.
//
// What bounds it on an H100: at the main path's shapes (T = 256 or 64,
// C = 512) the work is 4 B T^2 C flops against 4 B T C elements moved, i.e.
// T flops per element; with fp32 FMA (67 TFLOP/s) that is compute bound.
// This simple version is bound in practice by shared-memory reads (two per
// FMA) and leaves the tensor cores idle; wgmma tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kBQ = 16;     // query rows per block
constexpr int kBK = 64;     // keys per tile
constexpr int kDC = 32;     // head-dimension columns per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kMaxC = 512;  // largest head dimension (C % kDC == 0)
constexpr int kMaxChunks = kMaxC / kDC;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (ceil(T / kBQ), B), block kThreads. Static shared memory: 45.4 KB.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int t_len, int c_dim, float scale) {
  __shared__ float qs[kBQ][kMaxC + 1];   // +1: rows of one warp hit other banks
  __shared__ float kv[kBK][kDC + 1];     // K chunk, then V chunk
  __shared__ float ps[kBQ][kBK];         // probabilities of the current tile
  __shared__ float alpha_s[kBQ];
  __shared__ float l_s[kBQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)blockIdx.y * t_len * c_dim;
  const T* qb = q + base;
  const T* kb = k + base;
  const T* vb = v + base;
  T* ob = o + base;
  const int nchunks = c_dim / kDC;

  for (int e = tid; e < kBQ * c_dim; e += kThreads) {
    const int r = e / c_dim;
    const int d = e - r * c_dim;
    const int qi = q0 + r;
    qs[r][d] = qi < t_len ? to_f(qb[(size_t)qi * c_dim + d]) : 0.f;
  }

  // score mapping: row sq, keys sk + 16 j (the 16 threads of a row are one
  // half-warp, so row reductions are xor shuffles over offsets 8..1)
  const int sq = tid >> 4;
  const int sk = tid & 15;
  // P V mapping: column pd of each chunk, rows pq and pq + 8
  const int pd = tid & 31;
  const int pq = tid >> 5;

  float m_run = -INFINITY;
  float l_run = 0.f;
  float acc0[kMaxChunks];
  float acc1[kMaxChunks];
#pragma unroll
  for (int ch = 0; ch < kMaxChunks; ++ch) {
    acc0[ch] = 0.f;
    acc1[ch] = 0.f;
  }
  __syncthreads();

  for (int kt = 0; kt < t_len; kt += kBK) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < nchunks; ++ch) {
      for (int e = tid; e < kBK * kDC; e += kThreads) {
        const int r = e / kDC;
        const int d = e - r * kDC;
        const int ki = kt + r;
        kv[r][d] = ki < t_len ? to_f(kb[(size_t)ki * c_dim + ch * kDC + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < kDC; ++d) {
        const float qv = qs[sq][ch * kDC + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) s[j] = fmaf(qv, kv[sk + 16 * j][d], s[j]);
      }
      __syncthreads();
    }

    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = kt + sk + 16 * j < t_len ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m_run, mx);  // finite: tile 0 holds a real key
    const float alpha = expf(m_run - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[j] - m_new);
      rs += p;
      ps[sq][sk + 16 * j] = to_f(from_f<T>(p));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    l_run = l_run * alpha + rs;
    m_run = m_new;
    if (sk == 0) alpha_s[sq] = alpha;
    __syncthreads();

    const float al0 = alpha_s[pq];
    const float al1 = alpha_s[pq + 8];
#pragma unroll
    for (int ch = 0; ch < kMaxChunks; ++ch) {
      if (ch < nchunks) {  // uniform across the block
        for (int e = tid; e < kBK * kDC; e += kThreads) {
          const int r = e / kDC;
          const int d = e - r * kDC;
          const int ki = kt + r;
          kv[r][d] = ki < t_len ? to_f(vb[(size_t)ki * c_dim + ch * kDC + d]) : 0.f;
        }
        __syncthreads();
        float a0 = acc0[ch] * al0;
        float a1 = acc1[ch] * al1;
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          const float vv = kv[kk][pd];
          a0 = fmaf(ps[pq][kk], vv, a0);
          a1 = fmaf(ps[pq + 8][kk], vv, a1);
        }
        acc0[ch] = a0;
        acc1[ch] = a1;
        __syncthreads();
      }
    }
  }

  if (sk == 0) l_s[sq] = l_run;
  __syncthreads();
  const int r0 = q0 + pq;
  const int r1 = q0 + pq + 8;
  const float inv0 = 1.f / l_s[pq];
  const float inv1 = 1.f / l_s[pq + 8];
#pragma unroll
  for (int ch = 0; ch < kMaxChunks; ++ch) {
    if (ch < nchunks) {
      const int d = ch * kDC + pd;
      if (r0 < t_len) ob[(size_t)r0 * c_dim + d] = from_f<T>(acc0[ch] * inv0);
      if (r1 < t_len) ob[(size_t)r1 * c_dim + d] = from_f<T>(acc1[ch] * inv1);
    }
  }
}

}  // namespace

extern "C" {

// q, k, v, o: (batch, t_len, c_dim) contiguous; dtype 0 = float32,
// 1 = bfloat16; c_dim % 32 == 0 and c_dim <= 512 (checked by the wrapper).
// Returns cudaGetLastError().
int ddnm_attention(const void* q, const void* k, const void* v, void* o, int batch,
                   int t_len, int c_dim, float scale, int dtype, void* stream) {
  dim3 grid((t_len + kBQ - 1) / kBQ, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    attn_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), t_len, c_dim, scale);
  } else {
    attn_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), t_len,
        c_dim, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
