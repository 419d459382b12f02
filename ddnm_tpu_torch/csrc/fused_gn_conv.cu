// Fused GroupNorm affine -> SiLU -> 3x3 SAME convolution over NHWC bf16.
//
// Replaces the Pallas kernels of the fused GN+SiLU+conv experiment:
//   mode 0, full <- tools/experiments/fused_gn_conv.py _pallas_raw / _kernel:
//                   y = conv3x3(where(inside, silu(x * a + b), 0)), the
//                   activation rounded once to bf16, fp32 accumulation over
//                   K = 9 C, one rounding of the output to bf16;
//   mode 1, conv <- tools/experiments/fused_gn_conv_ablations.py _call with
//                   _kernel_noact: the same convolution of the raw input;
//   mode 2, act  <- the same _call with _kernel_nodot: silu(x * a + b) in
//                   fp32, one rounding to bf16, no convolution.
// The per-(B, C) affine a, b comes from the ported GroupNorm stats kernel
// (groupnorm.cu), as the experiment takes it from XLA's gn_stats_affine.
//
// What bounds it on an H100: the convolution does 2 * 9 C^2 flops per
// output pixel against 4 C bytes moved (x read, y written), so at C = 128
// it is ~576 flops per byte, above the ~295 where bf16 tensor cores and not
// memory set the limit: full and conv are bound by operations, act by
// bytes. The TPU kernel's 16-row tiles, right pad, whole-tile im2col buffer
// and DMA semaphores do not carry over. This is an implicit GEMM instead:
// M = B H W output pixels, N = C output channels, K = 9 C. A block owns a
// tile of TH image rows x 16 columns of one image (TH * 16 pixels, one wmma
// M fragment per row) and BN output channels, and walks K in chunks of 32
// input channels. For each chunk it stages in shared memory
//   - the (TH + 2) x 18 halo of the tile, loaded once per chunk with its
//     border computed from blockIdx and masked at the image edge; in full
//     mode the affine and SiLU run in fp32 on load and the pixels outside
//     the image are then zeroed (the conv's zero padding belongs to the
//     activation, not to x), so each input element is activated once per
//     chunk, not once per tap;
//   - the 9 taps x 32 x BN slice of the (9 C, C) weights, by cp.async;
// and runs the 9 taps as shifted windows of the halo on bf16 tensor cores
// (nvcuda::wmma 16x16x16, fp32 accumulators in registers). Two stages: the
// next chunk's weights fly by cp.async and its halo sits in registers while
// the current chunk's products run. The epilogue rounds once to bf16 and
// stores NHWC. No atomics: every launch gives the same bits. wgmma, TMA and
// a persistent schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTW = 16;       // output columns per block: one wmma M fragment
constexpr int kHW = kTW + 2;  // halo columns
constexpr int kKC = 32;       // input channels per K chunk

template <int TH, int BN>
struct Tile {
  static constexpr int kWarps = TH;  // TH / 2 along M (2 rows each) x 2 along N
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kNF = BN / 32;  // N fragments per warp
  static constexpr int kHaloPix = (TH + 2) * kHW;
  // halo: [2 channel halves][pixels][16], so a 16-pixel run of one halo row
  // is a row-major 16x16 A fragment with ldm 16 (32-byte aligned rows)
  static constexpr int kHaloElems = 2 * kHaloPix * 16;
  static constexpr int kWStride = BN + 16;  // padded weight row (32-byte multiple)
  static constexpr int kWElems = 9 * kKC * kWStride;
  static constexpr int kStageElems = kHaloElems + kWElems;
  static constexpr int kSmemBytes = 2 * kStageElems * 2;
  static constexpr int kHaloVecs = kHaloPix * (kKC / 8);  // 16-byte vectors
  static constexpr int kHaloVecsPerThread = (kHaloVecs + kThreads - 1) / kThreads;
  static constexpr int kWVecs = 9 * kKC * BN / 8;
};

__device__ __forceinline__ float silu(float v) { return v * (1.f / (1.f + expf(-v))); }

// 8 bf16 channels: silu(x * a + b) in fp32, one rounding to bf16.
__device__ __forceinline__ uint4 act8(uint4 raw, const float* __restrict__ a,
                                      const float* __restrict__ b) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(a));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(a) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(b));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(b) + 1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(in[k]);
    o[k] = __floats2bfloat162_rn(silu(f.x * av[2 * k] + bv[2 * k]),
                                 silu(f.y * av[2 * k + 1] + bv[2 * k + 1]));
  }
  return out;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// grid (tiles_w * tiles_h, C / BN, B), block Tile::kThreads, dynamic shared
// memory Tile::kSmemBytes. ACT: full mode (affine + SiLU + mask on load);
// otherwise conv mode (a, b unused).
template <int TH, int BN, bool ACT>
__global__ void __launch_bounds__(Tile<TH, BN>::kThreads, 1)
fgc_conv_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ ga, const float* __restrict__ gb,
                __nv_bfloat16* __restrict__ y, int H, int W, int C, int tiles_w) {
  using T = Tile<TH, BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % (TH / 2);  // M fragments (tile rows) 2 wm, 2 wm + 1
  const int wn = warp / (TH / 2);  // N columns [wn BN / 2, (wn + 1) BN / 2)
  const int bi = blockIdx.z;
  const int n0 = blockIdx.y * BN;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const __nv_bfloat16* xb = x + (size_t)bi * H * W * C;
  const float* ab = ACT ? ga + (size_t)bi * C : nullptr;
  const float* bb = ACT ? gb + (size_t)bi * C : nullptr;
  const int n_chunks = C / kKC;

  uint4 staged[T::kHaloVecsPerThread];

  // global -> registers: the raw halo of chunk c, zeros outside the image.
  // Halo pixel p = (hy, hx) is image pixel (h0 - 1 + hy, w0 - 1 + hx).
  auto load_halo = [&](int c) {
#pragma unroll
    for (int i = 0; i < T::kHaloVecsPerThread; ++i) {
      const int v = tid + i * T::kThreads;
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (v < T::kHaloVecs) {
        const int p = v >> 2, q = v & 3;
        const int ih = h0 - 1 + p / kHW, iw = w0 - 1 + p % kHW;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          r = __ldg(reinterpret_cast<const uint4*>(
              xb + ((size_t)ih * W + iw) * C + c * kKC + q * 8));
      }
      staged[i] = r;
    }
  };

  // registers -> shared. Full mode activates the pixels inside the image
  // and leaves the outside ones at the zero they were loaded as.
  auto store_halo = [&](int c, int s) {
    __nv_bfloat16* hs = smem + s * T::kStageElems;
#pragma unroll
    for (int i = 0; i < T::kHaloVecsPerThread; ++i) {
      const int v = tid + i * T::kThreads;
      if (v < T::kHaloVecs) {
        const int p = v >> 2, q = v & 3;
        uint4 r = staged[i];
        if (ACT) {
          const int ih = h0 - 1 + p / kHW, iw = w0 - 1 + p % kHW;
          if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
            const int ch = c * kKC + q * 8;
            r = act8(r, ab + ch, bb + ch);
          }
        }
        *reinterpret_cast<uint4*>(hs + ((q >> 1) * T::kHaloPix + p) * 16 + (q & 1) * 8) = r;
      }
    }
  };

  // the 9 x 32 x BN weights of chunk c, rows tap * 32 + k, by cp.async
  auto load_w = [&](int c, int s) {
    __nv_bfloat16* ws = smem + s * T::kStageElems + T::kHaloElems;
    for (int v = tid; v < T::kWVecs; v += T::kThreads) {
      const int row = v / (BN / 8), col = (v % (BN / 8)) * 8;
      const int tap = row / kKC, k = row % kKC;
      cp_async16(ws + row * T::kWStride + col,
                 w + ((size_t)tap * C + c * kKC + k) * C + n0 + col);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][T::kNF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < T::kNF; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // tap (dy, dx): A[m][k] = halo(row + dy, m + dx)[k], B[k][n] = w[tap][k][n]
  auto mma_chunk = [&](int s) {
    const __nv_bfloat16* hs = smem + s * T::kStageElems;
    const __nv_bfloat16* ws = hs + T::kHaloElems;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[T::kNF];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(
              fa[i], hs + (kh * T::kHaloPix + (2 * wm + i + dy) * kHW + dx) * 16, 16);
#pragma unroll
        for (int j = 0; j < T::kNF; ++j)
          wmma::load_matrix_sync(
              fb[j], ws + (tap * kKC + kh * 16) * T::kWStride + wn * (BN / 2) + j * 16,
              T::kWStride);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < T::kNF; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
  };

  load_w(0, 0);
  load_halo(0);
  store_halo(0, 0);
  cp_async_wait_all();
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c & 1;
    const bool more = c + 1 < n_chunks;
    if (more) {  // stage s ^ 1 was last read before the previous barrier
      load_w(c + 1, s ^ 1);
      load_halo(c + 1);
    }
    mma_chunk(s);
    if (more) store_halo(c + 1, s ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }

  // epilogue: each fragment through a per-warp 16x16 fp32 scratch (the
  // stages are free after the last barrier); lane -> pixel lane / 2,
  // 8 channels, one rounding to bf16, one 16-byte store
  float* scratch = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane >> 1, half = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int oh = h0 + 2 * wm + i, ow = w0 + r;
#pragma unroll
    for (int j = 0; j < T::kNF; ++j) {
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      if (oh < H && ow < W) {
        const float* src = scratch + r * 16 + half;
        uint4 out;
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = __floats2bfloat162_rn(src[2 * k], src[2 * k + 1]);
        *reinterpret_cast<uint4*>(y + (((size_t)bi * H + oh) * W + ow) * C + n0 +
                                  wn * (BN / 2) + j * 16 + half) = out;
      }
      __syncwarp();
    }
  }
}

// act mode: grid (blocks, B), block 256; grid-stride over the H W C / 8
// vectors of one image (H W C < 2^31, C % 8 == 0: checked by the wrapper).
__global__ void fgc_act_kernel(const __nv_bfloat16* __restrict__ x,
                               const float* __restrict__ a, const float* __restrict__ b,
                               __nv_bfloat16* __restrict__ y, int hwc, int C) {
  const int bi = blockIdx.y;
  const uint4* xb = reinterpret_cast<const uint4*>(x + (size_t)bi * hwc);
  uint4* yb = reinterpret_cast<uint4*>(y + (size_t)bi * hwc);
  const float* ab = a + (size_t)bi * C;
  const float* bb = b + (size_t)bi * C;
  const int n_vec = hwc / 8;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < n_vec; v += gridDim.x * blockDim.x) {
    const int ch = (v * 8) % C;
    yb[v] = act8(__ldg(xb + v), ab + ch, bb + ch);
  }
}

template <int TH, int BN, bool ACT>
cudaError_t launch_conv(const void* x, const void* w, const void* a, const void* b, void* y,
                        int batch, int H, int W, int C, cudaStream_t stream) {
  using T = Tile<TH, BN>;
  auto kern = fgc_conv_kernel<TH, BN, ACT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_w * tiles_h, C / BN, batch);
  kern<<<grid, T::kThreads, T::kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y), H, W, C, tiles_w);
  return cudaGetLastError();
}

// BN: the widest of 128, 64, 32 that divides C (C % 32 == 0), so no
// N tile is ragged; TH: 16 rows from 32-row maps up, 8 below.
template <int TH, bool ACT>
cudaError_t launch_bn(const void* x, const void* w, const void* a, const void* b, void* y,
                      int batch, int H, int W, int C, cudaStream_t stream) {
  if (C % 128 == 0) return launch_conv<TH, 128, ACT>(x, w, a, b, y, batch, H, W, C, stream);
  if (C % 64 == 0) return launch_conv<TH, 64, ACT>(x, w, a, b, y, batch, H, W, C, stream);
  return launch_conv<TH, 32, ACT>(x, w, a, b, y, batch, H, W, C, stream);
}

template <bool ACT>
cudaError_t launch_th(const void* x, const void* w, const void* a, const void* b, void* y,
                      int batch, int H, int W, int C, cudaStream_t stream) {
  if (H >= 32) return launch_bn<16, ACT>(x, w, a, b, y, batch, H, W, C, stream);
  return launch_bn<8, ACT>(x, w, a, b, y, batch, H, W, C, stream);
}

}  // namespace

extern "C" {

// x, y: (B, H, W, C) bf16 NHWC; w: (9 C, C) bf16, rows (dy, dx, c_in), the
// HWIO weights reshaped (unused in act mode); a, b: (B, C) fp32 affine
// (unused in conv mode). C % 32 == 0. mode: 0 full, 1 conv, 2 act.
// Returns cudaGetLastError() (or the error of the shared-memory opt-in).
int ddnm_fused_gn_conv(const void* x, const void* w, const void* a, const void* b, void* y,
                       int batch, int h, int w_cols, int c, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    const int hwc = h * w_cols * c;
    int blocks = (hwc / 8 + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    dim3 grid(blocks, batch);
    fgc_act_kernel<<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), hwc, c);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode == 0)
    return static_cast<int>(launch_th<true>(x, w, a, b, y, batch, h, w_cols, c, s));
  return static_cast<int>(launch_th<false>(x, w, a, b, y, batch, h, w_cols, c, s));
}

}  // extern "C"
