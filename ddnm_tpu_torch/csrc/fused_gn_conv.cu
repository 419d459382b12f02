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
// memory set the limit: full and conv are bound by operations (0.156 ms at
// (8, 256, 256, 128) at the 989 TFLOP/s peak), act by bytes. The TPU
// kernel's 16-row tiles, right pad, whole-tile im2col buffer and DMA
// semaphores do not carry over. fgc_conv_kernel is a Hopper implicit GEMM
// instead: M = B H W output pixels, N = C output channels, K = 9 C.
//   - Tiles: an output tile is 16 x 16 pixels of one image (M = 256) by BN
//     output channels (all of C up to 64, else 128; a ragged last N tile
//     reads zeros past C and its store is clipped). K is walked in chunks
//     of KC = 64 input channels (32 where C % 64 != 0), each chunk in 9 taps.
//   - A persistent grid of at most one block per SM walks the tiles; a
//     block is one producer warpgroup and two consumer warpgroups
//     (setmaxnreg moves the registers to the consumers).
//   - Loads, by TMA tensor copies completing on mbarriers, in two rings:
//     the halo of a chunk, a box 1 x 18 x 18 x KC of the (B, H, W, C) map
//     started at (h0 - 1, w0 - 1), with the 128-byte swizzle (64-byte at
//     KC = 32), whose out-of-bounds zero fill is the conv's zero padding;
//     and the (KC, BN) slice of the (9 C, C) weights of one (chunk, tap),
//     in 64-column boxes (32 at KC = 32) with the same swizzle, which is the
//     canonical layout a wgmma descriptor reads (N-major, transposed B).
//     Warp 0 of the producer issues them in the order the consumers use
//     them, the next chunk's halo about one chunk ahead. The weights ring
//     has 3-8 stages (what fits beside two halo stages and the epilogue's
//     buffers in 227 KB), the halo ring 2.
//   - Full mode: warps 1-3 of the producer warpgroup make one pass over
//     each landed halo: the fp32 affine and SiLU (fast exp and divide, a
//     few fp32 ulp) once per element, one rounding to bf16, in place; pixels
//     outside the image keep the zero
//     the copy wrote (the padding belongs to the activation, as in the
//     Pallas kernel and the plain version). So every input element is
//     activated once per chunk, not once per tap, and the pass overlaps
//     the consumers' products of the chunk before.
//   - Products: the 9 taps are shifted windows of the halo, which no wgmma
//     shared-memory descriptor can describe, so A comes from registers:
//     each warp owns one image row of 16 output pixels per 64-row subtile
//     and reads its shifted halo rows with ldmatrix, the swizzle applied to
//     the lane addresses (conflict-free). wgmma m64nBNk16 (bf16 in, fp32
//     accumulators in registers, B by descriptor from the weights stage);
//     each consumer warpgroup owns two 64-row subtiles (8 image rows), 64 or
//     128 fp32 accumulators a thread. ptxas allocates no more registers than
//     the 384-thread launch bound gives (168), so a warpgroup keeps one
//     wgmma group in flight and the two warpgroups fill each other's gaps.
//     A weights stage is released when the group that read it has
//     completed, a halo stage after its last ldmatrix.
//   - Epilogue: accumulators rounded once to bf16 into a 128-byte-swizzled
//     staging buffer (two per consumer warpgroup, in turn), stored by TMA
//     tensor copies of 64 pixels x 64 channels, clipped at the image and at
//     C; the producer meanwhile loads the next tile, so the epilogue
//     overlaps its loads.
//   - No atomics: every launch gives the same bits.
// The launch plan (KC, BN, stages, grid, shared memory) is ops/fused_gn_conv.py
// `_conv_plan`; the entry point checks it against conv_layout.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTH = 16, kTW = 16;                    // output tile: pixels of one image
constexpr int kHaloW = kTW + 2;                      // halo columns (and rows: 18)
constexpr int kHaloPix = (kTH + 2) * kHaloW;         // 324
constexpr int kConsumers = 2;                        // consumer warpgroups, 8 tile rows each
constexpr int kMW = 2;                               // 64-row subtiles per consumer warpgroup
constexpr int kThreads = 128 * (1 + kConsumers);     // 384
constexpr int kActThreads = 96;                      // warps 1-3 of the producer warpgroup
constexpr int kHaloStages = 2, kMaxWStages = 8;
constexpr int kOutBox = 64;                          // channels of one output store
constexpr int kEpiPiece = 64 * kOutBox * 2;          // 8 KB: one subtile x 64 channels
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

// Shared-memory layout in bytes from the first 1024-aligned address (the
// swizzle patterns repeat every 1024 bytes), within 1024 bytes of slack:
// the halo ring, the weights ring, the epilogue's staging buffers, the
// mbarriers. ops/fused_gn_conv.py `_conv_plan` computes the same total.
struct ConvLayout {
  int halo_stage, w_stage, w, epi, bars, total;
};
__host__ __device__ constexpr ConvLayout conv_layout(int kc, int bn, int ws) {
  const int halo_stage = (kHaloPix * kc * 2 + 1023) / 1024 * 1024;
  const int w_stage = kc * bn * 2;
  const int w = kHaloStages * halo_stage;
  const int epi = w + ws * w_stage;
  const int bars = epi + kConsumers * 2 * kEpiPiece;
  return ConvLayout{halo_stage, w_stage, w, epi, bars,
                    1024 + bars + 8 * (3 * kHaloStages + 2 * kMaxWStages)};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, unsigned src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory, before the async proxy (TMA) uses it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Byte offset of 16-byte chunk j of line p in a TMA stage with KC-channel
// lines: the 128-byte swizzle (KC = 64: chunk ^ line % 8) or the 64-byte one
// (KC = 32: chunk ^ (line / 2) % 4), from a 1024-aligned base.
template <int KC>
__device__ __forceinline__ unsigned swizzled(int p, int j) {
  if constexpr (KC == 64)
    return p * 128 + ((j ^ (p & 7)) << 4);
  else
    return p * 64 + ((j ^ ((p >> 1) & 3)) << 4);
}

// ------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across a wgmma boundary
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a (16 K rows, N) slice of a weights stage: N-major, N in
// boxes of KC columns (KC rows of 2 KC bytes each), the 128-byte (KC = 64)
// or 64-byte (KC = 32) swizzle; leading byte offset = one box, stride byte
// offset = 8 rows.
template <int KC>
__device__ __forceinline__ unsigned long long b_desc(unsigned addr) {
  constexpr unsigned long long line = KC * 2;
  constexpr unsigned long long lbo = KC * line >> 4, sbo = 8 * line >> 4;
  constexpr unsigned long long layout = KC == 64 ? 1 : 2;
  return ((addr & 0x3FFFF) >> 4) | (lbo << 16) | (sbo << 32) | (layout << 62);
}

// d += A B: m64nNk16, A (bf16) from registers in the mma.m16n8k16 fragment
// layout of each warp's 16 rows, B (bf16) by descriptor, transposed (N-major);
// fp32 accumulators.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4],
                                           unsigned long long desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4],
                                           unsigned long long desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], const unsigned (&a)[4],
                                         unsigned long long desc_b) {
  if constexpr (BN == 128)
    wgmma_n128(d, a, desc_b);
  else
    wgmma_n64(d, a, desc_b);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float silu(float v) { return v * (1.f / (1.f + expf(-v))); }
// silu with the fast exp and divide (ex2.approx, rcp.approx: a few fp32
// ulp, far below the bf16 rounding that follows). The halo pass runs on
// three warps beside the products, and with the accurate expf and IEEE
// division it, not the products, set the pace of full mode (about twice
// the time of conv mode at (8, 256, 256, 128)).
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// 8 bf16 channels: silu(x * a + b) in fp32, one rounding to bf16; FAST:
// silu_fast (full mode's halo pass), else silu (act mode).
template <bool FAST>
__device__ __forceinline__ uint4 act8(uint4 raw, const float (&av)[8], const float (&bv)[8]) {
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 out;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(in[k]);
    const float u = f.x * av[2 * k] + bv[2 * k], v = f.y * av[2 * k + 1] + bv[2 * k + 1];
    o[k] = FAST ? __floats2bfloat162_rn(silu_fast(u), silu_fast(v))
                : __floats2bfloat162_rn(silu(u), silu(v));
  }
  return out;
}

// silu(x a + b) in place on the pixels of a landed halo stage that lie
// inside the image, by `n` threads (this one is `at`).
template <int KC>
__device__ __forceinline__ void activate_halo(unsigned char* stage, int at, int n, const float* ga,
                                              const float* gb, int ch, int h0, int w0, int H,
                                              int W) {
  const int j = at % (KC / 8);  // this thread's 8 channels: fixed (n % (KC / 8) == 0)
  float av[8], bv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    av[k] = __ldg(ga + ch + j * 8 + k);
    bv[k] = __ldg(gb + ch + j * 8 + k);
  }
  for (int v = at; v < kHaloPix * (KC / 8); v += n) {
    const int p = v / (KC / 8);
    const int hy = p / kHaloW, hx = p - hy * kHaloW;
    const int ih = h0 - 1 + hy, iw = w0 - 1 + hx;
    if (ih >= 0 && ih < H && iw >= 0 && iw < W) {
      uint4* q = reinterpret_cast<uint4*>(stage + swizzled<KC>(p, j));
      *q = act8<true>(*q, av, bv);
    }
  }
  fence_proxy_async();  // before a later TMA copy reuses the stage
}

struct Tile {
  int b, h0, w0, n0;
};
// tiles in (image, tile row, tile column, N tile) order, N fastest: the N
// tiles of one spatial tile read the same halo from L2 one after another
template <int BN>
__device__ __forceinline__ Tile tile_at(int t, int tiles_w, int tiles_h, int n_tiles) {
  const int nt = t % n_tiles;
  t /= n_tiles;
  const int tw = t % tiles_w;
  t /= tiles_w;
  return Tile{t / tiles_h, (t % tiles_h) * kTH, tw * kTW, nt * BN};
}

// Persistent grid (<= one block per SM), block kThreads, dynamic shared
// memory conv_layout(KC, BN, ws_n).total. tm_x, tm_y: the (C, W, H, B)
// maps of x (halo boxes, KC-byte swizzle) and y (64 x 16 x 4 x 1 boxes,
// 128-byte swizzle); tm_w: the (C, 9 C) map of the weights, (KC, KC) boxes.
// ACT: full mode (a, b: (B, C) fp32); otherwise conv mode.
template <int KC, int BN, bool ACT>
__global__ void __launch_bounds__(kThreads, 1)
fgc_conv_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_y, const float* __restrict__ ga,
                const float* __restrict__ gb, int H, int W, int C, int tiles_w, int tiles_h,
                int n_tiles, int n_total, int ws_n) {
  constexpr int kLine = KC * 2;                   // bytes of one halo pixel / weights row
  constexpr int kSteps = KC / 16;                 // k16 steps of one tap
  constexpr int kWBoxes = BN / KC;                // weights boxes of one stage
  constexpr unsigned kHaloBytes = kHaloPix * kLine;
  constexpr unsigned kWBytes = KC * BN * 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ConvLayout lay = conv_layout(KC, BN, ws_n);
  const unsigned base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - smem_addr(smem_raw));
  const unsigned bars = base + lay.bars;
  // barriers: halo full, halo activated, halo empty, weights full, weights empty
  const unsigned h_full = bars, h_act = bars + 8 * kHaloStages,
                 h_empty = bars + 16 * kHaloStages;
  const unsigned w_full = bars + 24 * kHaloStages, w_empty = w_full + 8 * kMaxWStages;
  const int n_chunks = C / KC;
  const int wg = threadIdx.x >> 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      mbar_init(h_full + 8 * s, 1);
      mbar_init(h_act + 8 * s, kActThreads);
      mbar_init(h_empty + 8 * s, 128 * kConsumers);
    }
    for (int s = 0; s < ws_n; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(w_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // for the TMA unit
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0) {
      if (lane != 0) return;
      int hk = 0, wk = 0;  // halo and weights stage uses so far
      auto load_halo = [&](int t, int c) {
        const Tile tl = tile_at<BN>(t, tiles_w, tiles_h, n_tiles);
        const int s = hk % kHaloStages;
        mbar_wait(h_empty + 8 * s, ((hk / kHaloStages) & 1) ^ 1);
        mbar_expect(h_full + 8 * s, kHaloBytes);
        tma_load_4d(base + s * lay.halo_stage, &tm_x, c * KC, tl.w0 - 1, tl.h0 - 1, tl.b,
                    h_full + 8 * s);
        ++hk;
      };
      // the next chunk's halo goes out once the weights stage it waits
      // behind is free, about one chunk before it is needed
      const int halo_at = min(ws_n - 1, 8);
      if (blockIdx.x < n_total) load_halo(blockIdx.x, 0);
      for (int t = blockIdx.x; t < n_total; t += gridDim.x) {
        const Tile tl = tile_at<BN>(t, tiles_w, tiles_h, n_tiles);
        for (int c = 0; c < n_chunks; ++c) {
          for (int tap = 0; tap < 9; ++tap) {
            const int s = wk % ws_n;
            mbar_wait(w_empty + 8 * s, ((wk / ws_n) & 1) ^ 1);
            mbar_expect(w_full + 8 * s, kWBytes);
            const unsigned dst = base + lay.w + s * lay.w_stage;
#pragma unroll
            for (int nb = 0; nb < kWBoxes; ++nb)
              tma_load_2d(dst + nb * KC * kLine, &tm_w, tl.n0 + nb * KC, tap * C + c * KC,
                          w_full + 8 * s);
            ++wk;
            if (tap == halo_at) {
              if (c + 1 < n_chunks)
                load_halo(t, c + 1);
              else if (t + (int)gridDim.x < n_total)
                load_halo(t + gridDim.x, 0);
            }
          }
        }
      }
    } else if (ACT) {
      // activation warps: silu(x a + b) in place on each landed halo
      int hk = 0;
      for (int t = blockIdx.x; t < n_total; t += gridDim.x) {
        const Tile tl = tile_at<BN>(t, tiles_w, tiles_h, n_tiles);
        for (int c = 0; c < n_chunks; ++c) {
          const int s = hk % kHaloStages;
          mbar_wait(h_full + 8 * s, (hk / kHaloStages) & 1);
          activate_halo<KC>(gbase + s * lay.halo_stage, threadIdx.x - 32, kActThreads, ga, gb,
                            tl.b * C + c * KC, tl.h0, tl.w0, H, W);
          mbar_arrive(h_act + 8 * s);
          ++hk;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;                     // consumer: tile rows 8 cw .. 8 cw + 7
  const int ctid = threadIdx.x - 128 * wg;
  const int wq = ctid >> 5;                  // subtile mi: tile row 8 cw + 4 mi + wq
  const int g = lane >> 2, t4 = lane & 3;    // accumulator row and column pair
  // ldmatrix lane: A row lane % 16 (a pixel of the warp's image row), 8
  // channels lane / 16 of the k16 step; halo pixel of tap (0, 0), mi = 0
  const int hp0 = (8 * cw + wq) * kHaloW + (lane & 15);
  const int jsel = lane >> 4;
  const unsigned epi = base + lay.epi + cw * 2 * kEpiPiece;
  float acc[kMW][BN / 2];
  int hk = 0, wk = 0, piece = 0;

  for (int t = blockIdx.x; t < n_total; t += gridDim.x) {
    const Tile tl = tile_at<BN>(t, tiles_w, tiles_h, n_tiles);
#pragma unroll
    for (int mi = 0; mi < kMW; ++mi)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int hs = hk % kHaloStages;
      mbar_wait((ACT ? h_act : h_full) + 8 * hs, (hk / kHaloStages) & 1);
      const unsigned halo = base + hs * lay.halo_stage;
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ws = wk % ws_n;
        mbar_wait(w_full + 8 * ws, (wk / ws_n) & 1);
        const unsigned wst = base + lay.w + ws * lay.w_stage;
        const int hp = hp0 + (tap / 3) * kHaloW + tap % 3;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          unsigned a[kMW][4];
#pragma unroll
          for (int mi = 0; mi < kMW; ++mi)
            ldsm_x4(a[mi], halo + swizzled<KC>(hp + mi * 4 * kHaloW, 2 * kk + jsel));
          wgmma_fence();
#pragma unroll
          for (int mi = 0; mi < kMW; ++mi)
            wgmma_bn<BN>(acc[mi], a[mi], b_desc<KC>(wst + kk * 16 * kLine));
          wgmma_commit();
          // Each group completes before the next A is loaded: a second group
          // in flight needs a second A set, which 168 registers a thread
          // (the 384-thread launch bound) do not hold beside 128
          // accumulators, and ptxas then serialises the wgmmas itself, which
          // was slower. The other consumer warpgroup's group fills the gap.
          wgmma_wait<0>();
        }
        if (ctid == 0) mbar_arrive(w_empty + 8 * ws);
        ++wk;
      }
      mbar_arrive(h_empty + 8 * hs);  // this thread's ldmatrix reads are done
      ++hk;
    }
#pragma unroll
    for (int mi = 0; mi < kMW; ++mi) fence_regs(acc[mi]);

    // epilogue: per subtile and 64 output channels, one rounding to bf16
    // into a swizzled staging buffer, then one TMA store (clipped at H, W, C)
#pragma unroll
    for (int mi = 0; mi < kMW; ++mi) {
#pragma unroll
      for (int nb = 0; nb < BN / kOutBox; ++nb, ++piece) {
        const unsigned buf = epi + (piece & 1) * kEpiPiece;
        if (ctid == 0) bulk_wait_read<1>();  // the store that used this buffer has read it
        named_barrier(1 + cw, 128);
        const unsigned r0 = buf + (wq * 16 + g) * 128 + 4 * t4;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* d = &acc[mi][(nb * 8 + jj) * 4];
          const __nv_bfloat162 lo = __floats2bfloat162_rn(d[0], d[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(d[2], d[3]);
          const unsigned off = (jj ^ g) << 4;  // rows g and g + 8 share the swizzle
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(r0 + off),
                       "r"(*reinterpret_cast<const unsigned*>(&lo)));
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(r0 + 8 * 128 + off),
                       "r"(*reinterpret_cast<const unsigned*>(&hi)));
        }
        fence_proxy_async();
        named_barrier(1 + cw, 128);
        if (ctid == 0) {
          tma_store_4d(&tm_y, buf, tl.n0 + nb * kOutBox, tl.w0, tl.h0 + 8 * cw + 4 * mi, tl.b);
          bulk_commit();
        }
      }
    }
  }
  if (ctid == 0) bulk_wait_all();
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
    const float4 a0 = __ldg(reinterpret_cast<const float4*>(ab + ch));
    const float4 a1 = __ldg(reinterpret_cast<const float4*>(ab + ch) + 1);
    const float4 b0 = __ldg(reinterpret_cast<const float4*>(bb + ch));
    const float4 b1 = __ldg(reinterpret_cast<const float4*>(bb + ch) + 1);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    yb[v] = act8<false>(__ldg(xb + v), av, bv);
  }
}

// cuTensorMapEncodeTiled, looked up at first use (the library links only the
// CUDA runtime)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first; strides in bytes of
// dims 1..), read or written in `box` boxes with `swizzle`; out-of-bounds
// reads fill zeros, out-of-bounds writes are dropped.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int KC, int BN, bool ACT>
cudaError_t launch_conv(const void* x, const void* w, const void* a, const void* b, void* y,
                        int batch, int H, int W, int C, int ws_n, int grid, int smem_bytes,
                        cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  static int granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kern = fgc_conv_kernel<KC, BN, ACT>;
  if (smem_bytes > granted[dev]) {  // per device and kernel; raised, never lowered
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
    granted[dev] = smem_bytes;
  }
  const CUtensorMapSwizzle swz = KC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const cuuint64_t px = (cuuint64_t)C * 2;
  const cuuint64_t dims4[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)batch};
  const cuuint64_t strides4[3] = {px, px * W, px * W * H};
  const cuuint32_t halo_box[4] = {KC, kHaloW, kTH + 2, 1};
  const cuuint32_t out_box[4] = {kOutBox, kTW, 4, 1};
  const cuuint64_t dims2[2] = {(cuuint64_t)C, (cuuint64_t)9 * C};
  const cuuint32_t w_box[2] = {KC, KC};
  CUtensorMap tm_x, tm_w, tm_y;
  if ((err = make_map(&tm_x, x, 4, dims4, strides4, halo_box, swz)) != cudaSuccess ||
      (err = make_map(&tm_w, w, 2, dims2, &px, w_box, swz)) != cudaSuccess ||
      (err = make_map(&tm_y, y, 4, dims4, strides4, out_box, CU_TENSOR_MAP_SWIZZLE_128B)) !=
          cudaSuccess)
    return err;
  const int tiles_w = (W + kTW - 1) / kTW, tiles_h = (H + kTH - 1) / kTH;
  const int n_tiles = (C + BN - 1) / BN;
  const int n_total = batch * tiles_h * tiles_w * n_tiles;
  kern<<<grid, kThreads, smem_bytes, stream>>>(tm_x, tm_w, tm_y, static_cast<const float*>(a),
                                               static_cast<const float*>(b), H, W, C, tiles_w,
                                               tiles_h, n_tiles, n_total, ws_n);
  return cudaGetLastError();
}

template <bool ACT>
cudaError_t dispatch_conv(int kc, int bn, const void* x, const void* w, const void* a,
                          const void* b, void* y, int batch, int H, int W, int C, int ws_n,
                          int grid, int smem_bytes, cudaStream_t s) {
  if (kc == 64 && bn == 128)
    return launch_conv<64, 128, ACT>(x, w, a, b, y, batch, H, W, C, ws_n, grid, smem_bytes, s);
  if (kc == 64 && bn == 64)
    return launch_conv<64, 64, ACT>(x, w, a, b, y, batch, H, W, C, ws_n, grid, smem_bytes, s);
  if (kc == 32 && bn == 128)
    return launch_conv<32, 128, ACT>(x, w, a, b, y, batch, H, W, C, ws_n, grid, smem_bytes, s);
  if (kc == 32 && bn == 64)
    return launch_conv<32, 64, ACT>(x, w, a, b, y, batch, H, W, C, ws_n, grid, smem_bytes, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: (B, H, W, C) bf16 NHWC; w: (9 C, C) bf16, rows (dy, dx, c_in), the
// HWIO weights reshaped (unused in act mode); a, b: (B, C) fp32 affine
// (unused in conv mode); all 16-byte aligned. C % 32 == 0. mode: 0 full,
// 1 conv, 2 act. Full and conv take the launch plan of ops/fused_gn_conv.py
// `_conv_plan` (kc, bn, weights stages, grid, shared-memory bytes; ignored
// in act mode) and return cudaErrorInvalidValue for a plan the kernel does
// not take. Returns cudaGetLastError() (or the error of the
// shared-memory opt-in or of a tensor-map encode).
int ddnm_fused_gn_conv(const void* x, const void* w, const void* a, const void* b, void* y,
                       int batch, int h, int w_cols, int c, int mode, int kc, int bn,
                       int w_stages, int grid, int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    const int hwc = h * w_cols * c;
    int blocks = (hwc / 8 + 255) / 256;
    if (blocks > 1024) blocks = 1024;
    dim3 grid2(blocks, batch);
    fgc_act_kernel<<<grid2, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), hwc, c);
    return static_cast<int>(cudaGetLastError());
  }
  const bool ok = (mode == 0 || mode == 1) && (kc == 64 || kc == 32) && c % kc == 0 &&
                  (bn == 64 || bn == 128) && w_stages >= 2 && w_stages <= kMaxWStages &&
                  grid >= 1 && smem_bytes == conv_layout(kc, bn, w_stages).total;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0)
    return static_cast<int>(dispatch_conv<true>(kc, bn, x, w, a, b, y, batch, h, w_cols, c,
                                                w_stages, grid, smem_bytes, s));
  return static_cast<int>(dispatch_conv<false>(kc, bn, x, w, a, b, y, batch, h, w_cols, c,
                                               w_stages, grid, smem_bytes, s));
}

}  // extern "C"
