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
// out: (2, B, C) fp32, out[0] = a, out[1] = b.
template <typename T, int VEC>
__global__ void gn_stats_affine_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ film_scale,
                                       const float* __restrict__ film_shift,
                                       float* __restrict__ out, float* __restrict__ scratch,
                                       unsigned* __restrict__ counters, int batch, int hw,
                                       int c_total, int cpg, int span, int lanes_c, float eps) {
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
                                int threads, int lanes_c, int smem_bytes, cudaStream_t stream) {
  auto kernel = gn_stats_affine_kernel<T, VEC>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(n_blk, c_total / span, batch);
  kernel<<<grid, threads, smem_bytes, stream>>>(static_cast<const T*>(x), gamma, beta,
                                                film_scale, film_shift, out, scratch, counters,
                                                batch, hw, c_total, cpg, span, lanes_c, eps);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

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
                                        eps, span, n_blk, threads, lanes_c, smem_bytes, s);
  else if (dtype == 0 && vec == 1)
    err = launch_stats_affine<float, 1>(x, g, bt, fs, ft, o, sc, cn, batch, hw, c_total, cpg,
                                        eps, span, n_blk, threads, lanes_c, smem_bytes, s);
  else if (dtype == 1 && vec == 8)
    err = launch_stats_affine<__nv_bfloat16, 8>(x, g, bt, fs, ft, o, sc, cn, batch, hw, c_total,
                                                cpg, eps, span, n_blk, threads, lanes_c,
                                                smem_bytes, s);
  else if (dtype == 1 && vec == 1)
    err = launch_stats_affine<__nv_bfloat16, 1>(x, g, bt, fs, ft, o, sc, cn, batch, hw, c_total,
                                                cpg, eps, span, n_blk, threads, lanes_c,
                                                smem_bytes, s);
  return static_cast<int>(err);
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

const char* ddnm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
