// GroupNorm (+ optional FiLM, + optional SiLU) over NHWC activations.
//
// Replaces the Pallas kernels of ddnm_tpu/ops/groupnorm.py:
//   gn_stats_affine_kernel <- _stats_kernel / _pallas_stats (per-(B, C) fp32
//                             sum and sum of squares over H*W) together with
//                             its XLA glue _effective_affine (per-group mean
//                             and rstd by the fast variance E[x^2] - mean^2
//                             clamped at 0, folded into a per-(B, C) affine
//                             a, b, FiLM included), in one launch;
//   gn_apply_kernel        <- _apply_kernel / _pallas_group_norm
//                             (y = x * a + b in fp32, cast, optional SiLU).
//
// What bounds it on an H100: memory. Each element costs a handful of
// flops, far below the ~295 flops per byte where the card turns compute
// bound, so the least time is the bytes moved (x read twice, y written
// once) over 3.35 TB/s.
//
// Stats. On the TPU the stats pass carried its sums across a sequential
// grid; here blocks run in parallel and in no order, and the port's earlier
// design paid for that with a second launch and a scratch round trip.
// Now one launch does it all. A block sums a contiguous run of pixels of
// one image over a channel span of whole groups (a multiple of C / G), each
// thread loading VEC channels of one pixel as one 16-byte load (8 bf16 or 4
// fp32; 1 where C or the pointer does not allow it) with kStatsUnroll loads
// in flight, and reduces its pixel lanes through shared memory in a fixed
// order. The plan (ops/groupnorm.py `_stats_plan`) reads a big map in whole
// pixel rows (contiguous streams) with up to 32 blocks an image; a small
// map with one block per (image, 64-byte span), so that its grid still
// spreads over the SMs. Where an image has several blocks, each writes its
// sums to scratch and the last to finish, picked by an integer counter,
// adds them in block order and finalises; it resets the counter, so the
// counters stay zero between launches of one stream. No fp32 atomics:
// every launch gives the same bits.
//
// Spatial shards (a map's rows split over processes, parallel/spatial.py):
// the statistics are the whole image's, so the stats kernel has a partial
// mode that stops after the block combine and writes one shard's
// per-channel sums, the shards' sums are added in rank order outside the
// kernel (one all_gather), and gn_finalize_kernel folds them into a, b
// with the stats kernel's own arithmetic: one tiny launch per norm.
// Their gradient (classifier guidance under spatial shards) needs the whole
// map's sums too: gn_bwd_reduce_kernel's partial mode writes one shard's
// per-channel sums of x, x^2, dy' and dy' x, the shards' are added in rank
// order outside the kernel, and gn_bwd_finalize_kernel folds them into the
// coefficients of dx with the reduce kernel's own arithmetic; gn_bwd_dx_kernel
// then runs unchanged on the shard.
//
// Apply (gn_apply_kernel): a bytes-bound elementwise pass, y = x * a + b
// in fp32, cast, optional SiLU in fp32 on the cast value and one more cast
// (the Pallas _apply_kernel's arithmetic). Each thread moves VEC channels of
// one pixel as one 16-byte load and one 16-byte store (8 bf16 or 4 fp32; 1
// where the pointer or C does not allow it). The grid is sized to the card
// (whole blocks per SM x SMs over the batch, ops/groupnorm.py
// `_apply_plan`): a row of blocks per image strides over its H W C / VEC
// vectors, with a thread count that is a multiple of C / VEC, so a thread's
// image and channels never change along its stride and its VEC values of a
// and b are loaded once into registers (no per-element modulo, no
// per-element loads of a and b).
//
// Backward (dx only: the classifier-guidance gradient grad_x log p(y|x),
// where x requires grad and the affine, FiLM included, is frozen). With
// u = a x + b the forward's pre-activation, f = u as the output type holds
// it, and dy the incoming gradient, the SiLU (when it ran) takes dy to
// dy' = dy sigma(f) (1 + f (1 - sigma(f))) (the rounding to the output type
// passes the gradient through, as JAX's gradient of astype does). With
// g = gamma (1 + film_scale) per (B, C) and x^ = (x - mean) rstd, per
// (image, group):
//   dx = rstd (g dy' - mean_g(g dy') - x^ mean_g(g dy' x^)).
// gn_bwd_reduce_kernel: one pass over x and dy for the per-(B, G) sums of
// x, x^2, g dy' and g dy' x, from which it recomputes mean and rstd (not
// from a, which cannot give rstd back where gamma (1 + s) = 0) and folds
// the formula into a per-(B, C) affine of dy' and x: dx = A dy' + Bx x +
// Cx. It is bound by the bytes of x and dy, but its SiLU' costs about as
// many issue slots per element as the bytes take, and the classifier's
// maps are small at batch 1. So: a grid of its own (ops/groupnorm.py
// `_bwd_reduce_plan`: whole pixel rows, each image's pixels cut into runs
// so that the grid fills the card where the map has the work, blocks of
// 256 threads, two an SM), 16 unpredicated 16-byte loads in flight a
// thread, the bf16 SiLU' on the MUFU's fast exp and reciprocal with the
// sums as FMAs, and a combine with no serial tail: warp shuffles, then the
// blocks of a run of pixels as a thread-block cluster that adds its ranks'
// sums through distributed shared memory, then (where an image has several
// clusters) the clusters' sums through scratch, added by the last to
// arrive with its columns split over the cluster's CTAs. Fixed order
// throughout and no fp32 atomics: the same bits every launch.
// gn_bwd_dx_kernel: the elementwise pass (the apply kernel's layout:
// 16-byte loads and stores, a thread's channels and coefficients fixed in
// registers), the SiLU factor recomputed from x, a and b.
// Training (the scale, bias or FiLM require grad): the reduce kernel's
// partial mode writes the whole map's four sums, gn_bwd_finalize_kernel
// folds them into dx's coefficients and, beside them, the parameter
// gradients (d gamma, d beta, d film_scale, d film_shift), and
// gn_bwd_dx_kernel runs as above: three launches a norm.

#include <cstdint>

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

// Loads of VEC channels of one pixel as one unit (16 bytes when VEC > 1).
template <typename T, int VEC> struct VecLoad;
template <> struct VecLoad<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float (&f)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = __bfloat1622float2(h[i]);
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
};
template <> struct VecLoad<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void to_float(const Raw& r, float (&f)[4]) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};
template <typename T> struct VecLoad<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return *p; }
  static __device__ __forceinline__ void to_float(const Raw& r, float (&f)[1]) { f[0] = to_f(r); }
};

constexpr int kStatsUnroll = 8;  // pixel loads in flight per thread

// One launch: per-(B, C) fp32 affine (a, b) of the normalize pass.
// grid (n_blk, C / span, B), block lanes_c * lanes_p threads, dynamic shared
// memory 4 * (2 span + 2 blockDim.x VEC + 2 span / cpg) + 16 bytes. Block
// (j, s, b) sums pixels [j * chunk, (j + 1) * chunk) of channels
// [s span, (s + 1) span) of image b, each thread VEC channels of one pixel
// at a time, and reduces its pixel lanes through shared memory in a fixed
// order. With n_blk > 1 it writes its sums to scratch[b][s][j] (2 span fp32)
// and the last block of (b, s) to arrive, as counted by counters[b * spans
// + s], adds the n_blk partials in order j = 0 .. n_blk - 1, resets the
// counter to 0 for the next launch, and finalises. The counter is an
// integer: the fp32 sums never meet an atomic, so every launch gives the
// same bits. The counters assume the launches that share them run one after
// another (one stream), as the port's do.
// out: (2, B, C) fp32, out[0] = a, out[1] = b. With `partial` the kernel
// stops before the group fold and writes the per-channel sums instead,
// out[0] = sum x and out[1] = sum x^2 over this launch's pixels (one spatial
// shard's rows: gn_finalize_kernel folds the shards' added sums).
template <typename T, int VEC>
__global__ void gn_stats_affine_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ film_scale,
                                       const float* __restrict__ film_shift,
                                       float* __restrict__ out, float* __restrict__ scratch,
                                       unsigned* __restrict__ counters, int batch, int hw,
                                       int c_total, int cpg, int span, int lanes_c, float eps,
                                       int partial) {
  extern __shared__ float sm[];
  const int nthreads = blockDim.x;
  const int lanes_p = nthreads / lanes_c;
  const int tc = threadIdx.x % lanes_c;  // channel lane
  const int tp = threadIdx.x / lanes_c;  // pixel lane
  const int n_blk = gridDim.x, blk = blockIdx.x;
  const int b = blockIdx.z;
  const int c0 = blockIdx.y * span;
  const int width = lanes_c * VEC;          // channels of one slot
  float* part = sm;                         // [2][span]: this block's sums
  float* red = part + 2 * span;             // [2][lanes_p][width]
  float* gstat = red + 2 * nthreads * VEC;  // [2][span / cpg]: group mean, rstd
  unsigned* last = reinterpret_cast<unsigned*>(gstat + 2 * (span / cpg));

  const int chunk = (hw + n_blk - 1) / n_blk;
  const int p_begin = blk * chunk, p_end = min(hw, p_begin + chunk);
  const T* xb = x + (size_t)b * hw * c_total + c0;
  // a span wider than lanes_c vectors is walked in slots of lanes_c vectors
  for (int slot = 0; slot * width < span; ++slot) {
    const int cv = slot * lanes_c + tc;  // channel vector of this thread
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
    if (cv * VEC < span) {
      const T* xc = xb + cv * VEC;
      int p = p_begin + tp;
      for (; p + (kStatsUnroll - 1) * lanes_p < p_end; p += kStatsUnroll * lanes_p) {
        typename VecLoad<T, VEC>::Raw raw[kStatsUnroll];
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u)
          raw[u] = VecLoad<T, VEC>::load(xc + (size_t)(p + u * lanes_p) * c_total);
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u) {
          float f[VEC];
          VecLoad<T, VEC>::to_float(raw[u], f);
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            s1[j] += f[j];
            s2[j] += f[j] * f[j];
          }
        }
      }
      for (; p < p_end; p += lanes_p) {
        float f[VEC];
        VecLoad<T, VEC>::to_float(VecLoad<T, VEC>::load(xc + (size_t)p * c_total), f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1[j] += f[j];
          s2[j] += f[j] * f[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[tp * width + tc * VEC + j] = s1[j];
      red[(lanes_p + tp) * width + tc * VEC + j] = s2[j];
    }
    __syncthreads();
    // sum the pixel lanes of each channel in a fixed order
    for (int col = threadIdx.x; col < 2 * width; col += nthreads) {
      const int which = col / width, cc = col - which * width;
      if (slot * width + cc < span) {
        const float* r = red + which * lanes_p * width + cc;
        float acc = 0.f;
        for (int i = 0; i < lanes_p; ++i) acc += r[i * width];
        part[which * span + slot * width + cc] = acc;
      }
    }
    __syncthreads();
  }

  if (n_blk > 1) {
    // publish this block's sums; the last block of (b, s) adds them all
    const size_t bs = (size_t)b * gridDim.y + blockIdx.y;
    float* mine = scratch + (bs * n_blk + blk) * 2 * span;
    for (int col = threadIdx.x; col < 2 * span; col += nthreads) mine[col] = part[col];
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) *last = atomicAdd(counters + bs, 1u) == (unsigned)(n_blk - 1);
    __syncthreads();
    if (!*last) return;
    __threadfence();
    const float* all = scratch + bs * n_blk * 2 * span;
    for (int col = threadIdx.x; col < 2 * span; col += nthreads) {
      float acc = 0.f;
      for (int j = 0; j < n_blk; ++j) acc += __ldcg(all + (size_t)j * 2 * span + col);
      part[col] = acc;
    }
    if (threadIdx.x == 0) counters[bs] = 0;  // ready for the next launch
    __syncthreads();
  }

  if (partial) {  // the shard's per-channel sums; the finalize folds them
    for (int j = threadIdx.x; j < span; j += nthreads) {
      out[(size_t)b * c_total + c0 + j] = part[j];
      out[((size_t)batch + b) * c_total + c0 + j] = part[span + j];
    }
    return;
  }

  // fixed-order group sums -> mean and rstd (the fast variance E[x^2] -
  // mean^2, clamped at 0), then the per-channel affine with FiLM folded in
  const int ng = span / cpg;
  const float n = static_cast<float>(static_cast<double>(hw) * cpg);
  for (int gi = threadIdx.x; gi < ng; gi += nthreads) {
    float g1 = 0.f, g2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      g1 += part[gi * cpg + j];
      g2 += part[span + gi * cpg + j];
    }
    const float mean = g1 / n;
    const float var = fmaxf(g2 / n - mean * mean, 0.f);
    gstat[gi] = mean;
    gstat[ng + gi] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  float* a_out = out + (size_t)b * c_total;
  float* b_out = out + ((size_t)batch + b) * c_total;
  for (int j = threadIdx.x; j < span; j += nthreads) {
    const int c = c0 + j;
    const int gi = j / cpg;
    float a = gstat[ng + gi] * gamma[c];
    float bb = beta[c] - gstat[gi] * a;
    if (film_scale != nullptr) {
      const float fs = 1.f + film_scale[(size_t)b * c_total + c];
      a = a * fs;
      bb = bb * fs + film_shift[(size_t)b * c_total + c];
    }
    a_out[c] = a;
    b_out[c] = bb;
  }
}

template <typename T, int VEC>
cudaError_t launch_stats_affine(const void* x, const float* gamma, const float* beta,
                                const float* film_scale, const float* film_shift, float* out,
                                float* scratch, unsigned* counters, int batch, int hw,
                                int c_total, int cpg, float eps, int span, int n_blk,
                                int threads, int lanes_c, int smem_bytes, int partial,
                                cudaStream_t stream) {
  auto kernel = gn_stats_affine_kernel<T, VEC>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_blk, c_total / span, batch);
  kernel<<<grid, threads, smem_bytes, stream>>>(static_cast<const T*>(x), gamma, beta,
                                                film_scale, film_shift, out, scratch, counters,
                                                batch, hw, c_total, cpg, span, lanes_c, eps,
                                                partial);
  return cudaGetLastError();
}

// The fold of gn_stats_affine_kernel on given sums: the spatial shards'
// partial sums (2, B, C), added in rank order by the caller, of a map of
// `hw` pixels in all. grid (B), block kFinalizeThreads, dynamic shared
// memory 8 * groups bytes. The same arithmetic as the end of the stats
// kernel: fixed-order group sums, mean, rstd from E[x^2] - mean^2 clamped
// at 0, the per-channel affine with FiLM folded in. out: (2, B, C) fp32,
// out[0] = a, out[1] = b. A few hundred floats a launch: it costs its launch.
constexpr int kFinalizeThreads = 256;

__global__ void __launch_bounds__(kFinalizeThreads)
gn_finalize_kernel(const float* __restrict__ sums, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const float* __restrict__ film_scale,
                   const float* __restrict__ film_shift, float* __restrict__ out, int batch,
                   int hw, int c_total, int cpg, float eps) {
  extern __shared__ float gstat[];  // [2][groups]: mean, rstd
  const int b = blockIdx.x;
  const int ng = c_total / cpg;
  const float n = static_cast<float>(static_cast<double>(hw) * cpg);
  const float* s1 = sums + (size_t)b * c_total;
  const float* s2 = sums + ((size_t)batch + b) * c_total;
  for (int gi = threadIdx.x; gi < ng; gi += blockDim.x) {
    float g1 = 0.f, g2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      g1 += s1[gi * cpg + j];
      g2 += s2[gi * cpg + j];
    }
    const float mean = g1 / n;
    const float var = fmaxf(g2 / n - mean * mean, 0.f);
    gstat[gi] = mean;
    gstat[ng + gi] = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  float* a_out = out + (size_t)b * c_total;
  float* b_out = out + ((size_t)batch + b) * c_total;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    const int gi = c / cpg;
    float a = gstat[ng + gi] * gamma[c];
    float bb = beta[c] - gstat[gi] * a;
    if (film_scale != nullptr) {
      const float fs = 1.f + film_scale[(size_t)b * c_total + c];
      a = a * fs;
      bb = bb * fs + film_shift[(size_t)b * c_total + c];
    }
    a_out[c] = a;
    b_out[c] = bb;
  }
}

// Stores of VEC channels of one pixel as one unit (16 bytes when VEC > 1).
template <typename T, int VEC> struct VecStore;
template <> struct VecStore<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[8]) {
    uint4 out;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = out;
  }
};
template <> struct VecStore<float, 4> {
  static __device__ __forceinline__ void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <typename T> struct VecStore<T, 1> {
  static __device__ __forceinline__ void store(T* p, const float (&f)[1]) { *p = from_f<T>(f[0]); }
};

// SiLU of the cast value: fp32 as the plain version computes it (f *
// sigmoid(f), accurate exp and division); bf16 with the fast exp and divide
// (a few fp32 ulp, far below the bf16 rounding that follows), since the
// accurate pair made the swish pass visibly slower than the plain one on
// the big maps.
template <typename T> __device__ __forceinline__ float silu_of(float f);
template <> __device__ __forceinline__ float silu_of<float>(float f) {
  return f * (1.f / (1.f + expf(-f)));
}
template <> __device__ __forceinline__ float silu_of<__nv_bfloat16>(float f) {
  return __fdividef(f, 1.f + __expf(-f));
}

// The value as the output type holds it (the cast the Pallas kernel makes
// before the SiLU), back in fp32.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// grid (blocks, B), block threads; (blocks * threads) % cv == 0, cv =
// c_total / VEC. Block row b strides over the img_vec vectors (VEC channels
// of one pixel each) of image b; a thread's channel vector i % cv is fixed
// along its stride, so its a and b are loaded once. H W C < 2^31 (checked by
// the wrapper): 32-bit indices within an image.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bias, T* __restrict__ y, int img_vec, int cv,
                int c_total, int swish) {
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= img_vec) return;
  const size_t img = blockIdx.y;
  const int ch = (i % cv) * VEC;
  float av[VEC], bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    av[j] = __ldg(a + img * c_total + ch + j);
    bv[j] = __ldg(bias + img * c_total + ch + j);
  }
  const T* xb = x + img * img_vec * VEC;
  T* yb = y + img * img_vec * VEC;
  for (; i < img_vec; i += stride) {
    float f[VEC];
    VecLoad<T, VEC>::to_float(VecLoad<T, VEC>::load(xb + (size_t)i * VEC), f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      f[j] = round_to<T>(f[j] * av[j] + bv[j]);
      if (swish) f[j] = silu_of<T>(f[j]);
    }
    VecStore<T, VEC>::store(yb + (size_t)i * VEC, f);
  }
}

template <typename T, int VEC>
cudaError_t launch_apply(const void* x, const void* a, const void* b, void* y, int batch,
                         int hwc, int c_total, int swish, int threads, int blocks,
                         cudaStream_t stream) {
  dim3 grid(blocks, batch);
  gn_apply_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<T*>(y), hwc / VEC, c_total / VEC, c_total, swish);
  return cudaGetLastError();
}

// SiLU'(f) = sigma(f) (1 + f (1 - sigma(f))) at the value the forward
// applied the SiLU to (u rounded to the output type), in fp32.
template <typename T> __device__ __forceinline__ float silu_grad(float u) {
  const float f = round_to<T>(u);
  const float s = 1.f / (1.f + expf(-f));
  return s * (1.f + f * (1.f - s));
}

// ---- gn_bwd_reduce_kernel: one pass over x and dy, one launch

constexpr int kBwdThreads = 256;    // threads a block
constexpr int kBwdUnroll = 4;       // pixels a thread copies a stage: 4 of x and 4 of dy
constexpr int kBwdStages = 3;       // its ring: two stages in flight while one is summed
constexpr int kBwdMaxCluster = 8;   // CTAs a cluster (the portable limit)
// shared-memory ring of the 16-byte path: stages x pixels x (x, dy) x threads
constexpr int kBwdRingBytes = kBwdStages * kBwdUnroll * 2 * 16 * kBwdThreads;

// SiLU'(f) of the reduce pass at f = u rounded to the output type, in fp32.
// fp32: silu_grad (the accurate exp and division, which the fp32 gates
// need). bf16: the forward's fast pair (silu_of<__nv_bfloat16>) as one
// ex2 and one reciprocal on the MUFU, s + f s (1 - s) as one FMA.
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float silu_grad_fast(float f) {
  const float s = rcp_approx(1.f + ex2_approx(f * -1.4426950408889634f));
  return fmaf(f * s, 1.f - s, s);
}

template <typename T> __device__ __forceinline__ float reduce_silu_grad(float u);
template <> __device__ __forceinline__ float reduce_silu_grad<float>(float u) {
  return silu_grad<float>(u);
}
template <> __device__ __forceinline__ float reduce_silu_grad<__nv_bfloat16>(float u) {
  return silu_grad_fast(round_to<__nv_bfloat16>(u));
}

// The four sums of one pixel's VEC channels: x, x^2, dy', dy' x (the
// squares and products as FMAs). SWISH: dy' = dy SiLU'(round(a x + b)).
template <typename T, int VEC, bool SWISH> struct BwdSums {
  using L = VecLoad<T, VEC>;
  static __device__ __forceinline__ void add(const typename L::Raw& rx,
                                             const typename L::Raw& rd, const float (&av)[VEC],
                                             const float (&bv)[VEC], float (&s)[4][VEC]) {
    float fx[VEC], fd[VEC];
    L::to_float(rx, fx);
    L::to_float(rd, fd);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = SWISH ? fd[j] * reduce_silu_grad<T>(fmaf(fx[j], av[j], bv[j])) : fd[j];
      s[0][j] += fx[j];
      s[1][j] = fmaf(fx[j], fx[j], s[1][j]);
      s[2][j] += d;
      s[3][j] = fmaf(d, fx[j], s[3][j]);
    }
  }
};
// bf16, 8 channels: bf16 pairs to fp32 and a x + b to bf16 by the packed
// conversions, the fast SiLU'.
template <bool SWISH> struct BwdSums<__nv_bfloat16, 8, SWISH> {
  static __device__ __forceinline__ void add(const uint4& rx, const uint4& rd,
                                             const float (&av)[8], const float (&bv)[8],
                                             float (&s)[4][8]) {
    const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&rx);
    const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(&rd);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x2 = __bfloat1622float2(hx[i]);
      float2 d2 = __bfloat1622float2(hd[i]);
      if (SWISH) {
        const float2 f2 = __bfloat1622float2(__floats2bfloat162_rn(
            fmaf(x2.x, av[2 * i], bv[2 * i]), fmaf(x2.y, av[2 * i + 1], bv[2 * i + 1])));
        d2.x *= silu_grad_fast(f2.x);
        d2.y *= silu_grad_fast(f2.y);
      }
      const float xs[2] = {x2.x, x2.y}, ds[2] = {d2.x, d2.y};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * i + h;
        s[0][j] += xs[h];
        s[1][j] = fmaf(xs[h], xs[h], s[1][j]);
        s[2][j] += ds[h];
        s[3][j] = fmaf(ds[h], xs[h], s[3][j]);
      }
    }
  }
};

// 16 bytes from device memory to this thread's shared memory, asynchronously
// (cp.async: no register holds the data in flight), and its groups.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(a), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(a), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One thread's sums over pixels p, p + lanes_p, ... < p_end of its VEC
// channels (xc, dc: the channels' first pixel). A 16-byte vector streams
// through the thread's own slots of the shared-memory ring (`ring`: its
// first slot; slots kBwdThreads vectors apart): stages of kBwdUnroll pixels
// of x and of dy copied unpredicated by cp.async, kBwdStages - 1 stages (16
// loads) in flight while the oldest is summed; no other thread reads the
// slots, so no barrier. Then the ragged tail (fewer than kBwdUnroll pixels),
// and with VEC = 1 every pixel, by guarded loads into registers, all
// issued before any is used.
template <typename T, int VEC, bool SWISH>
__device__ __forceinline__ void bwd_thread_sums(const T* __restrict__ xc,
                                                const T* __restrict__ dc, int p, int p_end,
                                                int lanes_p, int c_total, const float (&av)[VEC],
                                                const float (&bv)[VEC], float (&s)[4][VEC],
                                                typename VecLoad<T, VEC>::Raw* ring) {
  using L = VecLoad<T, VEC>;
  using Raw = typename L::Raw;
  const size_t step = (size_t)lanes_p * c_total;
  if constexpr (sizeof(Raw) == 16) {
    const int n_stage = p < p_end ? (p_end - p + lanes_p - 1) / lanes_p / kBwdUnroll : 0;
    auto issue = [&](int i) {
      if (i < n_stage) {
        const T* px = xc + (size_t)(p + i * kBwdUnroll * lanes_p) * c_total;
        const T* pd = dc + (size_t)(p + i * kBwdUnroll * lanes_p) * c_total;
        Raw* slot = ring + (i % kBwdStages) * kBwdUnroll * 2 * kBwdThreads;
#pragma unroll
        for (int u = 0; u < kBwdUnroll; ++u) {
          cp_async16(slot + 2 * u * kBwdThreads, px + u * step);
          cp_async16(slot + (2 * u + 1) * kBwdThreads, pd + u * step);
        }
      }
      cp_async_commit();  // empty past the end: the group count stays fixed
    };
#pragma unroll
    for (int i = 0; i < kBwdStages - 1; ++i) issue(i);
    for (int i = 0; i < n_stage; ++i) {
      issue(i + kBwdStages - 1);
      cp_async_wait<kBwdStages - 1>();  // stage i has landed
      const Raw* slot = ring + (i % kBwdStages) * kBwdUnroll * 2 * kBwdThreads;
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u)
        BwdSums<T, VEC, SWISH>::add(slot[2 * u * kBwdThreads], slot[(2 * u + 1) * kBwdThreads],
                                    av, bv, s);
    }
    if (n_stage > 0) cp_async_wait<0>();  // else nothing of the ring is pending
    p += n_stage * kBwdUnroll * lanes_p;
  }
  Raw rx[kBwdUnroll], rd[kBwdUnroll];
  for (; p < p_end; p += kBwdUnroll * lanes_p) {
    const T* px = xc + (size_t)p * c_total;
    const T* pd = dc + (size_t)p * c_total;
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u) {
      if (p + u * lanes_p < p_end) {
        rx[u] = L::load(px + u * step);
        rd[u] = L::load(pd + u * step);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdUnroll; ++u)
      if (p + u * lanes_p < p_end) BwdSums<T, VEC, SWISH>::add(rx[u], rd[u], av, bv, s);
  }
}

// Thread-block clusters (as csrc/fwht.cu; those helpers are file-local).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// arrival that publishes nothing: this CTA is done reading its peers
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

// orders this thread's device-memory accesses around the integer counter
__device__ __forceinline__ void fence_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// the float of rank `rank`'s shared memory at the local address `local`
__device__ __forceinline__ float ld_cluster(const float* local, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(a), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// Shared memory per block: the block's sums [4][span] (read by its cluster
// peers), gamma and film_scale of the span [2][span] (copied in at the
// start), then, over the ring of the 16-byte path (kBwdRingBytes; none at
// VEC = 1) once the pixels are summed, a work area that first holds every
// thread's sums [4][pixel lanes][lanes_c VEC] and then the sums this CTA
// finalises [4][span], the per-group rstd, Bx, Cx [3][span / cpg] and 16
// bytes for the last-CTA flag. ops/groupnorm.py `_bwd_reduce_smem` computes
// the same.
__host__ __device__ constexpr int bwd_work_floats(int span, int vec) {
  return 4 * kBwdThreads * vec > 4 * span ? 4 * kBwdThreads * vec : 4 * span;
}
inline int bwd_smem_bytes(int span, int vec, int cpg, int elem) {
  const int tail = 4 * (bwd_work_floats(span, vec) + 3 * (span / cpg)) + 16;
  const int ring = vec * elem == 16 ? kBwdRingBytes : 0;
  return 24 * span + (ring > tail ? ring : tail);
}

// p[0] + p[stride] + ... + p[(n - 1) stride] in a fixed order: four chains
// (i mod 4), then (c0 + c1) + (c2 + c3), so four loads are in flight.
template <typename Load>
__device__ __forceinline__ float sum4(int n, Load load) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    a0 += load(i);
    a1 += load(i + 1);
    a2 += load(i + 2);
    a3 += load(i + 3);
  }
  for (; i < n; ++i) a0 += load(i);
  return (a0 + a1) + (a2 + a3);
}

// VEC floats at p: 16-byte loads where p allows them.
template <int VEC> __device__ __forceinline__ void ld_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int j = 0; j < VEC; j += 4) {
        const float4 w = __ldg(reinterpret_cast<const float4*>(p + j));
        v[j] = w.x, v[j + 1] = w.y, v[j + 2] = w.z, v[j + 3] = w.w;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = __ldg(p + j);
}

// The VEC floats at p (16-byte aligned when VEC > 1) and their store.
template <int VEC> __device__ __forceinline__ void st_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = v[j];
  }
}

// One launch: the per-(B, C) coefficients (A, Bx, Cx) of dx = A dy' + Bx x +
// Cx. grid (runs, C / span, B) in clusters of K = %cluster_nctarank CTAs
// along x; 256 threads, lanes_c (a power of two <= 256) channel lanes x
// 256 / lanes_c pixel lanes; a span wider than lanes_c VEC channels is
// walked in slots. Block (j, s, b) sums pixels [j hw / runs, (j + 1) hw /
// runs) of channels [s span, (s + 1) span) of image b. Then, in a fixed
// order every launch:
//   1. the pixel lanes: every thread's sums go to shared memory, and the
//      block's threads split the (quantity, channel) columns, each adding
//      its column's pixel lanes in a fixed order (sum4);
//   2. the cluster: after a cluster barrier, rank r takes the groups
//      [r ng / K, (r + 1) ng / K) of the span and adds the K ranks' sums of
//      their channels in rank order (ld.shared::cluster, the four sums of a
//      rank in flight together); it then arrives at a second cluster barrier,
//      which it waits on before exiting, so no CTA leaves while a peer may
//      still read it;
//   3. the clusters (runs / K > 1): rank r writes its channels' cluster sum
//      to scratch[b][s][cluster], and the last rank r to arrive (integer
//      counter counters[(b spans + s) K + r]) adds the cluster sums in a
//      fixed order, its threads splitting the columns and the clusters
//      (sum4, then shuffles combine the pieces), and resets the counter;
//   4. the rank that holds its channels' whole sums finalises their groups
//      from shared memory alone (gamma and film_scale came in with the
//      first stage).
// Partial mode (`partial` = 1; a spatial shard's rows, whose groups span
// every shard): step 4 stops before the fold and writes its channels'
// four sums, out (4, B, C) fp32 = (sum x, sum x^2, sum dy', sum dy' x);
// the shards' sums are added in rank order outside the kernel and
// gn_bwd_finalize_kernel folds them. gamma and film_scale are then unread
// (may be null).
// No fp32 atomics: every launch gives the same bits. a, b: the forward's
// affine (read only when swish; under spatial shards the whole map's);
// film_scale may be null. out: (3, B, C) fp32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads, 2)
gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                     const float* __restrict__ gamma, const float* __restrict__ film_scale,
                     const float* __restrict__ aff_a, const float* __restrict__ aff_b,
                     float* __restrict__ out, float* __restrict__ scratch,
                     unsigned* __restrict__ counters, int batch, int hw, int c_total, int cpg,
                     int span, int lanes_c, float eps, int swish, int partial) {
  extern __shared__ __align__(16) float sm[];
  using Raw = typename VecLoad<T, VEC>::Raw;
  const int t = threadIdx.x;
  const int log_c = __ffs(lanes_c) - 1;   // lanes_c is a power of two
  const int lanes_p = kBwdThreads >> log_c;
  const int tc = t & (lanes_c - 1), tp = t >> log_c;
  const int b = blockIdx.z, c0 = blockIdx.y * span;
  const int width = lanes_c * VEC;        // channels of one slot
  const int ng = span / cpg;
  float* part = sm;                                 // [4][span]
  float* gam = part + 4 * span;                     // [span]
  float* fil = gam + span;                          // [span]
  float* work = fil + span;                         // over the ring
  float* gstat = work + bwd_work_floats(span, VEC);  // [3][ng]
  unsigned* flag = reinterpret_cast<unsigned*>(gstat + 3 * ng);
  Raw* ring = reinterpret_cast<Raw*>(work) + t;     // this thread's first slot

  const float* fsb = film_scale != nullptr ? film_scale + (size_t)b * c_total + c0 : nullptr;
  for (int j = t; j < span; j += kBwdThreads) {
    if (gamma != nullptr) cp_async4(gam + j, gamma + c0 + j);
    if (fsb != nullptr) cp_async4(fil + j, fsb + j);
  }
  cp_async_commit();

  const int run = blockIdx.x, n_run = gridDim.x;
  int p_begin = 0, p_end = hw;
  if (n_run > 1) {
    if ((long long)hw * n_run < (1ll << 31)) {
      p_begin = run * hw / n_run;
      p_end = (run + 1) * hw / n_run;
    } else {
      p_begin = static_cast<int>((long long)run * hw / n_run);
      p_end = static_cast<int>((long long)(run + 1) * hw / n_run);
    }
  }
  const size_t img = (size_t)b * hw * c_total + c0;
  for (int slot = 0; slot * width < span; ++slot) {
    const int cv = slot * lanes_c + tc;
    float s[4][VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[0][j] = s[1][j] = s[2][j] = s[3][j] = 0.f;
    if (cv * VEC < span) {
      float av[VEC], bv[VEC];
      const T* xc = x + img + cv * VEC;
      const T* dc = dy + img + cv * VEC;
      if (swish) {
        ld_vec<VEC>(aff_a + (size_t)b * c_total + c0 + cv * VEC, av);
        ld_vec<VEC>(aff_b + (size_t)b * c_total + c0 + cv * VEC, bv);
        bwd_thread_sums<T, VEC, true>(xc, dc, p_begin + tp, p_end, lanes_p, c_total, av, bv, s,
                                      ring);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) av[j] = bv[j] = 0.f;
        bwd_thread_sums<T, VEC, false>(xc, dc, p_begin + tp, p_end, lanes_p, c_total, av, bv,
                                       s, ring);
      }
    }
    cp_async_wait<0>();  // gamma and film_scale too
    // 1. the pixel lanes: every thread's sums into the work area (over the
    // ring: every thread done with it), then the (quantity, column) sums
    // over the lanes in lane order, split over the block's threads
    __syncthreads();
    if (cv * VEC < span)
#pragma unroll
      for (int q = 0; q < 4; ++q) st_vec<VEC>(work + (q * lanes_p + tp) * width + tc * VEC, s[q]);
    __syncthreads();
    const int cols = min(width, span - slot * width);
    for (int task = t; task < 4 * cols; task += kBwdThreads) {
      const int q = task / cols, cc = task - q * cols;
      const float* col = work + q * lanes_p * width + cc;
      part[q * span + slot * width + cc] = sum4(lanes_p, [&](int i) { return col[i * width]; });
    }
    __syncthreads();
  }

  // 2. the cluster's sums of this rank's channels, in rank order
  const int K = static_cast<int>(cluster_size());  // a power of two
  const int log_k = __ffs(K) - 1;
  const int rank = static_cast<int>(cluster_rank());
  const int g_lo = (rank * ng) >> log_k, g_hi = ((rank + 1) * ng) >> log_k;
  const int ch0 = g_lo * cpg, nch = (g_hi - g_lo) * cpg;
  float* fin = part;  // [4][span]: the sums this rank finalises (its channels)
  if (K > 1) {
    cluster_arrive();
    cluster_wait();
    fin = work;
    for (int j = ch0 + t; j < ch0 + nch; j += kBwdThreads) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r = 0; r < K; ++r) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = ld_cluster(part + q * span + j, r);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += v[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) fin[q * span + j] = acc[q];
    }
    cluster_arrive_relaxed();  // this CTA has read its peers
    __syncthreads();
  }

  // 3. the clusters of (b, s): the last rank r to arrive adds them
  const int n_cl = n_run >> log_k;
  bool last = true;
  if (n_cl > 1) {
    const size_t bs = (size_t)b * gridDim.y + blockIdx.y;
    float* all = scratch + bs * n_cl * 4 * span;
    float* mine = all + (size_t)(run >> log_k) * 4 * span;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (int j = ch0 + t; j < ch0 + nch; j += kBwdThreads) mine[q * span + j] = fin[q * span + j];
    fence_gpu();
    __syncthreads();
    unsigned* counter = counters + bs * K + rank;
    if (t == 0) *flag = atomicAdd(counter, 1u) == (unsigned)(n_cl - 1);
    __syncthreads();
    last = *flag != 0;
    if (last) {
      fence_gpu();
      // tpc threads a column (q, j), each adding a contiguous run of the
      // clusters (loads first, then the adds in cluster order)
      const int cols = 4 * nch;
      int tpc = 1;
      while (tpc < 32 && 2 * tpc * cols <= kBwdThreads) tpc *= 2;
      const int sub = t % tpc;
      const int k_lo = sub * n_cl / tpc, k_hi = (sub + 1) * n_cl / tpc;
      for (int base = 0; base < cols; base += kBwdThreads / tpc) {
        const int col = base + t / tpc;
        const int q = col / nch;
        const int c = q * span + ch0 + col - q * nch;
        const float* src = all + (size_t)k_lo * 4 * span + c;
        float acc = col < cols ? sum4(k_hi - k_lo, [&](int k) {
          return __ldcg(src + (size_t)k * 4 * span);
        }) : 0.f;
        for (int o = 1; o < tpc; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (col < cols && sub == 0) fin[c] = acc;
      }
      if (t == 0) *counter = 0;  // ready for the next launch
      __syncthreads();
    }
  }

  // partial mode: this rank's channels' four sums, unweighted
  if (last && partial) {
    for (int j = ch0 + t; j < ch0 + nch; j += kBwdThreads)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        out[((size_t)q * batch + b) * c_total + c0 + j] = fin[q * span + j];
  }

  // 4. the dy' sums of this rank's channels weighed by g = gamma (1 +
  // film_scale), one thread a channel; fixed-order group sums; A, Bx, Cx
  if (last && !partial) {
    for (int j = ch0 + t; j < ch0 + nch; j += kBwdThreads) {
      const float g = fsb != nullptr ? gam[j] * (1.f + fil[j]) : gam[j];
      fin[2 * span + j] *= g;
      fin[3 * span + j] *= g;
    }
    __syncthreads();
    // four threads a group, one a sum (sum4 over its channels), gathered by
    // shuffles into the group's first thread
    const float inv_n = 1.f / static_cast<float>(static_cast<double>(hw) * cpg);
    const int n_task = 4 * (g_hi - g_lo);
    for (int task0 = 0; task0 < n_task; task0 += kBwdThreads) {
      const int task = task0 + t, gi = g_lo + (task >> 2), q = task & 3;
      const float* src = fin + q * span + gi * cpg;
      const float v = task < n_task ? sum4(cpg, [&](int j) { return src[j]; }) : 0.f;
      const int lead = (t & 31) & ~3;
      const float g1 = __shfl_sync(0xffffffffu, v, lead);
      const float g2 = __shfl_sync(0xffffffffu, v, lead + 1);
      const float g3 = __shfl_sync(0xffffffffu, v, lead + 2);
      const float g4 = __shfl_sync(0xffffffffu, v, lead + 3);
      if (task < n_task && q == 0) {
        const float mean = g1 * inv_n;
        const float rstd = rsqrtf(fmaxf(g2 * inv_n - mean * mean, 0.f) + eps);
        const float c1 = g3 * inv_n;                      // mean_g(g dy')
        const float c2 = rstd * (g4 * inv_n - mean * c1);  // mean_g(g dy' x^)
        gstat[gi] = rstd;
        gstat[ng + gi] = -rstd * rstd * c2;                  // Bx
        gstat[2 * ng + gi] = rstd * (mean * rstd * c2 - c1);  // Cx
      }
    }
    __syncthreads();
    float* a_out = out + (size_t)b * c_total + c0;
    for (int j = ch0 + t; j < ch0 + nch; j += kBwdThreads) {
      const int gi = j / cpg;
      const float g = fsb != nullptr ? gam[j] * (1.f + fil[j]) : gam[j];
      a_out[j] = gstat[gi] * g;
      a_out[(size_t)batch * c_total + j] = gstat[ng + gi];
      a_out[(size_t)2 * batch * c_total + j] = gstat[2 * ng + gi];
    }
  }
  if (K > 1) cluster_wait();  // the peers have read this CTA
}

template <typename T, int VEC>
cudaError_t launch_bwd_reduce(const void* x, const void* dy, const float* gamma,
                              const float* film_scale, const float* aff_a, const float* aff_b,
                              float* out, float* scratch, unsigned* counters, int batch, int hw,
                              int c_total, int cpg, float eps, int swish, int span, int runs,
                              int cluster, int lanes_c, int smem_bytes, int partial,
                              cudaStream_t stream) {
  auto kernel = gn_bwd_reduce_kernel<T, VEC>;
  // all of the SM's shared memory, so that two rings fit: a function
  // attribute of the current device, so set once on each device
  constexpr int kMaxDevices = 64;
  static bool carved[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!carved[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    carved[dev] = true;
  }
  if (smem_bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(runs, c_total / span, batch);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(dy), gamma, film_scale,
      aff_a, aff_b, out, scratch, counters, batch, hw, c_total, cpg, span, lanes_c, eps, swish,
      partial);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The fold of gn_bwd_reduce_kernel's step 4 on given sums (4, B, C) =
// (sum x, sum x^2, sum dy', sum dy' x) of a map of `hw` pixels in all:
// under spatial shards every shard's partial sums added in rank order by
// the caller, in training the whole map's from the reduce kernel's partial
// mode. Step 4's own arithmetic: the dy' sums weighed per channel by
// g = gamma (1 + film_scale), fixed-order group sums (sum4), mean and rstd
// by the fast variance, then coef (3, B, C) = (A, Bx, Cx) per channel.
// d_gamma given (training; then d_beta and beta too, and d_film_scale,
// d_film_shift where film_scale is): the parameter gradients beside them.
// With S_dy = sum dy', S_dyx = sum dy' x and sum dy' x^ = rstd (S_dyx -
// mean S_dy), in the FiLM convention y = (x^ gamma + beta) (1 + s) + shift:
//   d shift[b, c] = S_dy,
//   d s[b, c]     = gamma_c rstd (S_dyx - mean S_dy) + beta_c S_dy,
//   d gamma_c     = sum_b (1 + s_bc) rstd (S_dyx - mean S_dy),
//   d beta_c      = sum_b (1 + s_bc) S_dy.
// No TPU counterpart: the JAX package takes these gradients with jax.grad
// through XLA. grid (ceil(C / kFinalizeThreads)), block kFinalizeThreads:
// thread c walks the images in order (the sums over b in a fixed order, no
// atomics) and folds its group's four sums per image. A few B C cpg floats
// read a launch: it costs its launch. All fp32.
__global__ void __launch_bounds__(kFinalizeThreads)
gn_bwd_finalize_kernel(const float* __restrict__ sums, const float* __restrict__ gamma,
                       const float* __restrict__ beta, const float* __restrict__ film_scale,
                       float* __restrict__ coef, float* __restrict__ d_gamma,
                       float* __restrict__ d_beta, float* __restrict__ d_film_scale,
                       float* __restrict__ d_film_shift, int batch, int hw, int c_total,
                       int cpg, float eps) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= c_total) return;
  const float inv_n = 1.f / static_cast<float>(static_cast<double>(hw) * cpg);
  const size_t bc = (size_t)batch * c_total;
  const int c0 = c - c % cpg;
  float dg = 0.f, db = 0.f;
  for (int b = 0; b < batch; ++b) {
    const size_t o = (size_t)b * c_total;
    const float* fs = film_scale != nullptr ? film_scale + o : nullptr;
    auto g_of = [&](int ch) { return fs != nullptr ? gamma[ch] * (1.f + fs[ch]) : gamma[ch]; };
    const float g1 = sum4(cpg, [&](int j) { return sums[o + c0 + j]; });
    const float g2 = sum4(cpg, [&](int j) { return sums[bc + o + c0 + j]; });
    const float g3 = sum4(cpg, [&](int j) { return sums[2 * bc + o + c0 + j] * g_of(c0 + j); });
    const float g4 = sum4(cpg, [&](int j) { return sums[3 * bc + o + c0 + j] * g_of(c0 + j); });
    const float mean = g1 * inv_n;
    const float rstd = rsqrtf(fmaxf(g2 * inv_n - mean * mean, 0.f) + eps);
    const float c1 = g3 * inv_n;                      // mean_g(g dy')
    const float c2 = rstd * (g4 * inv_n - mean * c1);  // mean_g(g dy' x^)
    coef[o + c] = rstd * g_of(c);
    coef[bc + o + c] = -rstd * rstd * c2;                  // Bx
    coef[2 * bc + o + c] = rstd * (mean * rstd * c2 - c1);  // Cx
    if (d_gamma == nullptr) continue;
    const float s_dy = sums[2 * bc + o + c];
    const float s_xhat = rstd * (sums[3 * bc + o + c] - mean * s_dy);  // sum dy' x^
    const float f1 = fs != nullptr ? 1.f + fs[c] : 1.f;
    dg += f1 * s_xhat;
    db += f1 * s_dy;
    if (fs != nullptr) {
      d_film_scale[o + c] = gamma[c] * s_xhat + beta[c] * s_dy;
      d_film_shift[o + c] = s_dy;
    }
  }
  if (d_gamma != nullptr) {
    d_gamma[c] = dg;
    d_beta[c] = db;
  }
}

// dx = A dy' + Bx x + Cx, dy' = dy SiLU'(a x + b) when swish: the apply
// kernel's layout (grid (blocks, B), (blocks * threads) % cv == 0, a
// thread's VEC channels and their coefficients fixed along its stride).
// coef: (3, B, C) fp32 from gn_bwd_reduce_kernel; a, b read only when swish.
template <typename T, int VEC>
__global__ void __launch_bounds__(256)
gn_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 const float* __restrict__ aff_a, const float* __restrict__ aff_b,
                 const float* __restrict__ coef, T* __restrict__ dx, int batch, int img_vec,
                 int cv, int c_total, int swish) {
  const int stride = gridDim.x * blockDim.x;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= img_vec) return;
  const size_t img = blockIdx.y;
  const size_t bc = (size_t)batch * c_total;
  const int ch = (i % cv) * VEC;
  float ca[VEC], cx[VEC], cc[VEC], av[VEC], bv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const size_t o = img * c_total + ch + j;
    ca[j] = __ldg(coef + o);
    cx[j] = __ldg(coef + bc + o);
    cc[j] = __ldg(coef + 2 * bc + o);
    av[j] = swish ? __ldg(aff_a + o) : 0.f;
    bv[j] = swish ? __ldg(aff_b + o) : 0.f;
  }
  const T* xb = x + img * img_vec * VEC;
  const T* db = dy + img * img_vec * VEC;
  T* ob = dx + img * img_vec * VEC;
  for (; i < img_vec; i += stride) {
    float fx[VEC], fd[VEC];
    VecLoad<T, VEC>::to_float(VecLoad<T, VEC>::load(xb + (size_t)i * VEC), fx);
    VecLoad<T, VEC>::to_float(VecLoad<T, VEC>::load(db + (size_t)i * VEC), fd);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = swish ? fd[j] * silu_grad<T>(fx[j] * av[j] + bv[j]) : fd[j];
      fd[j] = ca[j] * d + cx[j] * fx[j] + cc[j];
    }
    VecStore<T, VEC>::store(ob + (size_t)i * VEC, fd);
  }
}

template <typename T, int VEC>
cudaError_t launch_bwd_dx(const void* x, const void* dy, const void* a, const void* b,
                          const void* coef, void* dx, int batch, int hwc, int c_total, int swish,
                          int threads, int blocks, cudaStream_t stream) {
  dim3 grid(blocks, batch);
  gn_bwd_dx_kernel<T, VEC><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const float*>(coef), static_cast<T*>(dx), batch,
      hwc / VEC, c_total / VEC, c_total, swish);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The stats kernel's launch, whole (partial = 0) or partial (1); see the
// entry points below.
static int gn_stats_entry(const void* x, const void* gamma, const void* beta,
                          const void* film_scale, const void* film_shift, void* out,
                          void* scratch, void* counters, int batch, int hw, int c_total,
                          int groups, float eps, int vec, int span, int n_blk, int threads,
                          int lanes_c, int smem_bytes, int dtype, int partial, void* stream) {
  if (groups <= 0 || c_total % groups != 0 || span <= 0 || vec <= 0 || lanes_c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = c_total / groups;
  const bool ok = c_total % span == 0 && span % cpg == 0 && span % vec == 0 && n_blk >= 1 &&
                  threads % lanes_c == 0 && threads <= 1024 &&
                  smem_bytes == 4 * (2 * span + 2 * threads * vec + 2 * (span / cpg)) + 16;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* fs = static_cast<const float*>(film_scale);
  const float* ft = static_cast<const float*>(film_shift);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  unsigned* cn = static_cast<unsigned*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    err = launch_stats_affine<float, 4>(x, g, bt, fs, ft, o, sc, cn, batch, hw, c_total, cpg,
                                        eps, span, n_blk, threads, lanes_c, smem_bytes, partial,
                                        s);
  else if (dtype == 0 && vec == 1)
    err = launch_stats_affine<float, 1>(x, g, bt, fs, ft, o, sc, cn, batch, hw, c_total, cpg,
                                        eps, span, n_blk, threads, lanes_c, smem_bytes, partial,
                                        s);
  else if (dtype == 1 && vec == 8)
    err = launch_stats_affine<__nv_bfloat16, 8>(x, g, bt, fs, ft, o, sc, cn, batch, hw, c_total,
                                                cpg, eps, span, n_blk, threads, lanes_c,
                                                smem_bytes, partial, s);
  else if (dtype == 1 && vec == 1)
    err = launch_stats_affine<__nv_bfloat16, 1>(x, g, bt, fs, ft, o, sc, cn, batch, hw, c_total,
                                                cpg, eps, span, n_blk, threads, lanes_c,
                                                smem_bytes, partial, s);
  return static_cast<int>(err);
}

// dtype: 0 = float32, 1 = bfloat16. Every entry returns cudaGetLastError().
// x: (batch, hw, c_total) contiguous; gamma, beta: (c_total,) fp32; film_scale,
// film_shift: (batch, c_total) fp32 or both null; out: (2, batch, c_total)
// fp32; scratch: batch * (c_total / span) * n_blk * 2 * span fp32 (unused when
// n_blk == 1); counters: batch * (c_total / span) zeros, left zero. The
// launch plan (vec, span, n_blk, threads, lanes_c, smem_bytes) is
// ops/groupnorm.py `_stats_plan`; a plan the kernel cannot run returns
// cudaErrorInvalidValue.
int ddnm_gn_stats_affine(const void* x, const void* gamma, const void* beta,
                         const void* film_scale, const void* film_shift, void* out,
                         void* scratch, void* counters, int batch, int hw, int c_total,
                         int groups, float eps, int vec, int span, int n_blk, int threads,
                         int lanes_c, int smem_bytes, int dtype, void* stream) {
  return gn_stats_entry(x, gamma, beta, film_scale, film_shift, out, scratch, counters, batch,
                        hw, c_total, groups, eps, vec, span, n_blk, threads, lanes_c,
                        smem_bytes, dtype, 0, stream);
}

// The stats kernel's partial mode (a spatial shard's rows): out (2, batch,
// c_total) fp32 gets the per-channel sum of x and of x^2 over the hw pixels
// given; the rest as ddnm_gn_stats_affine, the same plan.
int ddnm_gn_stats_partial(const void* x, void* out, void* scratch, void* counters, int batch,
                          int hw, int c_total, int groups, int vec, int span, int n_blk,
                          int threads, int lanes_c, int smem_bytes, int dtype, void* stream) {
  return gn_stats_entry(x, nullptr, nullptr, nullptr, nullptr, out, scratch, counters, batch,
                        hw, c_total, groups, 0.f, vec, span, n_blk, threads, lanes_c,
                        smem_bytes, dtype, 1, stream);
}

// The finalize of the partial mode: sums (2, batch, c_total) fp32, every
// shard's added; hw the pixels of the whole map; gamma, beta, film as
// ddnm_gn_stats_affine; out (2, batch, c_total) fp32 = (a, b).
int ddnm_gn_finalize(const void* sums, const void* gamma, const void* beta,
                     const void* film_scale, const void* film_shift, void* out, int batch,
                     int hw, int c_total, int groups, float eps, void* stream) {
  if (groups <= 0 || c_total % groups != 0 || batch <= 0 || batch > 65535 || hw <= 0 ||
      8 * groups > 48 * 1024 || (film_scale == nullptr) != (film_shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  gn_finalize_kernel<<<batch, kFinalizeThreads, 8 * groups,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(film_scale),
      static_cast<const float*>(film_shift), static_cast<float*>(out), batch, hw, c_total,
      c_total / groups, eps);
  return static_cast<int>(cudaGetLastError());
}

// x, y: (batch, hwc / c_total, c_total) contiguous, dtype as above; a, b:
// (batch, c_total) fp32. The launch plan (vec, threads, blocks per image) is
// ops/groupnorm.py `_apply_plan`: vec is 1 or 16 bytes of channels, and the
// thread count of an image's blocks is a multiple of c_total / vec; a plan
// the kernel cannot run returns cudaErrorInvalidValue.
int ddnm_gn_apply(const void* x, const void* a, const void* b, void* y, int batch,
                  int hwc, int c_total, int swish, int dtype, int vec, int threads,
                  int blocks, void* stream) {
  const int wide = dtype == 0 ? 4 : 8;
  const bool ok = (dtype == 0 || dtype == 1) && (vec == 1 || vec == wide) && c_total > 0 &&
                  c_total % vec == 0 && hwc % c_total == 0 && threads > 0 &&
                  threads <= 256 && blocks > 0 && batch > 0 && batch <= 65535 &&
                  ((long long)threads * blocks) % (c_total / vec) == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec == 1 ? launch_apply<float, 1>(x, a, b, y, batch, hwc, c_total, swish, threads,
                                            blocks, s)
                   : launch_apply<float, 4>(x, a, b, y, batch, hwc, c_total, swish, threads,
                                            blocks, s);
  else
    err = vec == 1 ? launch_apply<__nv_bfloat16, 1>(x, a, b, y, batch, hwc, c_total, swish,
                                                    threads, blocks, s)
                   : launch_apply<__nv_bfloat16, 8>(x, a, b, y, batch, hwc, c_total, swish,
                                                    threads, blocks, s);
  return static_cast<int>(err);
}

// The backward reduce kernel's launch, whole (partial = 0) or partial (1);
// see the entry points below.
static int gn_bwd_entry(const void* x, const void* dy, const void* gamma,
                        const void* film_scale, const void* a, const void* b, void* out,
                        void* scratch, void* counters, int batch, int hw, int c_total,
                        int groups, float eps, int swish, int vec, int span, int runs,
                        int cluster, int lanes_c, int smem_bytes, int dtype, int partial,
                        void* stream) {
  if (groups <= 0 || c_total % groups != 0 || span <= 0 || vec <= 0 || lanes_c <= 0 ||
      batch <= 0 || hw <= 0 || cluster <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cpg = c_total / groups;
  const bool ok = c_total % span == 0 && span % cpg == 0 && span % vec == 0 &&
                  lanes_c <= kBwdThreads && (lanes_c & (lanes_c - 1)) == 0 &&
                  cluster <= kBwdMaxCluster && (cluster & (cluster - 1)) == 0 &&
                  runs >= cluster && runs % cluster == 0 && runs <= hw &&
                  batch <= 65535 && c_total / span <= 65535 && (!swish || (a && b)) &&
                  (runs == cluster || (scratch && counters)) && (partial || gamma) &&
                  smem_bytes == bwd_smem_bytes(span, vec, cpg, dtype == 0 ? 4 : 2);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const float* g = static_cast<const float*>(gamma);
  const float* fs = static_cast<const float*>(film_scale);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  unsigned* cn = static_cast<unsigned*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && vec == 4)
    err = launch_bwd_reduce<float, 4>(x, dy, g, fs, fa, fb, o, sc, cn, batch, hw, c_total, cpg,
                                      eps, swish, span, runs, cluster, lanes_c, smem_bytes,
                                      partial, s);
  else if (dtype == 0 && vec == 1)
    err = launch_bwd_reduce<float, 1>(x, dy, g, fs, fa, fb, o, sc, cn, batch, hw, c_total, cpg,
                                      eps, swish, span, runs, cluster, lanes_c, smem_bytes,
                                      partial, s);
  else if (dtype == 1 && vec == 8)
    err = launch_bwd_reduce<__nv_bfloat16, 8>(x, dy, g, fs, fa, fb, o, sc, cn, batch, hw,
                                              c_total, cpg, eps, swish, span, runs, cluster,
                                              lanes_c, smem_bytes, partial, s);
  else if (dtype == 1 && vec == 1)
    err = launch_bwd_reduce<__nv_bfloat16, 1>(x, dy, g, fs, fa, fb, o, sc, cn, batch, hw,
                                              c_total, cpg, eps, swish, span, runs, cluster,
                                              lanes_c, smem_bytes, partial, s);
  return static_cast<int>(err);
}

// GroupNorm backward, first pass. x, dy: (batch, hw, c_total) contiguous,
// dtype as above; gamma: (c_total,) fp32; film_scale: (batch, c_total) fp32
// or null; a, b: the forward's (batch, c_total) fp32 affine (read only when
// swish; may be null otherwise); out: (3, batch, c_total) fp32 (A, Bx, Cx).
// The launch plan is ops/groupnorm.py `_bwd_reduce_plan`: channel span,
// `runs` blocks per (image, span) in clusters of `cluster` (1, 2, 4 or 8),
// lanes_c channel lanes (a power of two <= 256) and smem_bytes as
// bwd_smem_bytes computes them. With runs / cluster > 1: scratch holds
// batch * c_total * 4 * (runs / cluster) fp32 and counters batch *
// (c_total / span) * cluster zeros, left zero (shared with the stats
// kernel: one stream); otherwise both may be null. A plan the kernel cannot
// run returns cudaErrorInvalidValue.
int ddnm_gn_bwd_reduce(const void* x, const void* dy, const void* gamma, const void* film_scale,
                       const void* a, const void* b, void* out, void* scratch, void* counters,
                       int batch, int hw, int c_total, int groups, float eps, int swish, int vec,
                       int span, int runs, int cluster, int lanes_c, int smem_bytes, int dtype,
                       void* stream) {
  return gn_bwd_entry(x, dy, gamma, film_scale, a, b, out, scratch, counters, batch, hw,
                      c_total, groups, eps, swish, vec, span, runs, cluster, lanes_c, smem_bytes,
                      dtype, 0, stream);
}

// The backward reduce kernel's partial mode (a spatial shard's rows): out
// (4, batch, c_total) fp32 gets the per-channel sums of x, x^2, dy' and dy'
// x over the hw pixels given, dy' through the SiLU' at a, b (the whole
// map's affine) when swish; the plan, scratch and counters as
// ddnm_gn_bwd_reduce's.
int ddnm_gn_bwd_partial(const void* x, const void* dy, const void* a, const void* b, void* out,
                        void* scratch, void* counters, int batch, int hw, int c_total,
                        int groups, int swish, int vec, int span, int runs, int cluster,
                        int lanes_c, int smem_bytes, int dtype, void* stream) {
  return gn_bwd_entry(x, dy, nullptr, nullptr, a, b, out, scratch, counters, batch, hw,
                      c_total, groups, 0.f, swish, vec, span, runs, cluster, lanes_c, smem_bytes,
                      dtype, 1, stream);
}

// The backward finalize: sums (4, batch, c_total) fp32 (under spatial
// shards every shard's added in rank order, in training the whole map's
// from ddnm_gn_bwd_partial); hw the pixels of the whole map; gamma
// (c_total,) and film_scale (batch, c_total) or null, fp32; coef (3, batch,
// c_total) fp32 = (A, Bx, Cx), read by ddnm_gn_bwd_dx. d_gamma, d_beta
// (c_total,) null or, in training, written with beta (c_total,) read, and
// where film_scale is given d_film_scale, d_film_shift (batch, c_total).
int ddnm_gn_bwd_finalize(const void* sums, const void* gamma, const void* beta,
                         const void* film_scale, void* coef, void* d_gamma, void* d_beta,
                         void* d_film_scale, void* d_film_shift, int batch, int hw,
                         int c_total, int groups, float eps, void* stream) {
  const bool params = d_gamma != nullptr;
  if (groups <= 0 || c_total % groups != 0 || batch <= 0 || hw <= 0 || sums == nullptr ||
      gamma == nullptr || coef == nullptr || params != (d_beta != nullptr) ||
      (params && (beta == nullptr || (film_scale != nullptr &&
                                      (d_film_scale == nullptr || d_film_shift == nullptr)))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (c_total + kFinalizeThreads - 1) / kFinalizeThreads;
  gn_bwd_finalize_kernel<<<blocks, kFinalizeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sums), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(film_scale),
      static_cast<float*>(coef), static_cast<float*>(d_gamma), static_cast<float*>(d_beta),
      static_cast<float*>(d_film_scale), static_cast<float*>(d_film_shift), batch, hw, c_total,
      c_total / groups, eps);
  return static_cast<int>(cudaGetLastError());
}

// GroupNorm backward, second pass. x, dy, dx: (batch, hwc / c_total,
// c_total) contiguous, dtype as above; a, b: (batch, c_total) fp32 (read
// only when swish); coef: (3, batch, c_total) fp32 from ddnm_gn_bwd_reduce.
// The launch plan is the apply kernel's (`_apply_plan`).
int ddnm_gn_bwd_dx(const void* x, const void* dy, const void* a, const void* b,
                   const void* coef, void* dx, int batch, int hwc, int c_total, int swish,
                   int dtype, int vec, int threads, int blocks, void* stream) {
  const int wide = dtype == 0 ? 4 : 8;
  const bool ok = (dtype == 0 || dtype == 1) && (vec == 1 || vec == wide) && c_total > 0 &&
                  c_total % vec == 0 && hwc % c_total == 0 && threads > 0 &&
                  threads <= 256 && blocks > 0 && batch > 0 && batch <= 65535 &&
                  (!swish || (a && b)) &&
                  ((long long)threads * blocks) % (c_total / vec) == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = vec == 1 ? launch_bwd_dx<float, 1>(x, dy, a, b, coef, dx, batch, hwc, c_total, swish,
                                             threads, blocks, s)
                   : launch_bwd_dx<float, 4>(x, dy, a, b, coef, dx, batch, hwc, c_total, swish,
                                             threads, blocks, s);
  else
    err = vec == 1 ? launch_bwd_dx<__nv_bfloat16, 1>(x, dy, a, b, coef, dx, batch, hwc, c_total,
                                                     swish, threads, blocks, s)
                   : launch_bwd_dx<__nv_bfloat16, 8>(x, dy, a, b, coef, dx, batch, hwc, c_total,
                                                     swish, threads, blocks, s);
  return static_cast<int>(err);
}

const char* ddnm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
