// Single-head attention over (B*, T, C) token grids: O = softmax(Q K^T * scale) V.
//
// Replaces the Pallas kernel ddnm_tpu/ops/attention.py (_attn_kernel /
// _pallas_attention): S = Q K^T * scale accumulated in fp32, a fp32 softmax,
// normalised, then cast to the type of V, then P V accumulated in fp32.
//
// The TPU kernel held a whole (T, T) score block and the whole (T, C) slabs
// in VMEM. An H100 block has at most 227 KB of shared memory and registers
// are the scarce resource, so here one block owns kQ = 16 query rows of one
// slab and streams K and V through shared memory in tiles of key_tile(C)
// keys. There are two kernels, chosen by the input type.
//
// bf16 (attn_mma_kernel<C>; the UNet's bf16 torso, the main path). Both
// products run on the tensor cores: mma.sync m16n8k16 with bf16 operands
// and fp32 accumulators, the operands read from shared memory by ldmatrix.
//   - Why mma.sync and not wgmma: at the main path's shapes, (8, 256, 512)
//     x5 and (8, 64, 512) x1 per forward, the work is 5.4 GFLOP against 44
//     MB moved, which is bytes-bound on this card (a 13 us bound per
//     forward, ~5 us of it tensor-core time). wgmma's 64-row tiles would
//     give 32 blocks at T = 256 and leave 100 of the 132 SMs idle; 16-row
//     tiles give 128 blocks. A warp-level m16n8k16 fits a 16-row tile.
//   - Work split: 4 warps. For Q K^T each warp takes a quarter of the
//     tile's keys over the whole head dimension (A = Q from shared memory,
//     B = the K tile's rows, which is K^T in the col-major layout the mma
//     wants), in 4 independent accumulator chains. For P V each warp owns a
//     quarter of the C output columns: C / 32 n8 tiles, 64 fp32 accumulator
//     registers a thread at C = 512. V's rows are read with ldmatrix.trans.
//     C is a template parameter (32 .. 512), so every loop over it unrolls.
//   - Loads: K and V of one slab (256 KB each at T = 256, C = 512) are read
//     by all T / 16 query tiles of that slab. They stay in the 50 MB L2, so
//     the HBM bytes remain the bound's, but each block pulls 2 T C bf16
//     bytes out of L2. Copies by cp.async from every thread kept the blocks
//     waiting for their tiles, and TMA bulk copies of one row each were
//     bound by posting them one copy at a time. So where C is a multiple
//     of 64 the tiles come by TMA tensor copies: one 64-column box of
//     key_tile(C) rows per copy (8 copies for a 64 KB tile at C = 512, one
//     lane of warp 0 each), with the 128-byte swizzle, completing on an
//     mbarrier, two stages deep. The swizzle puts the 8 rows an ldmatrix
//     reads on 8 different bank groups; rows past T are outside the
//     (C, T, B) tensor map and arrive as zeros. Other C (32, 96, ...) use
//     cp.async into rows padded by 16 bytes. Q (16 rows) comes by cp.async.
//     Sharing a tile among the query tiles of a slab (a cluster with TMA
//     multicast) halves the L2 reads but gained little once the copies
//     were tensor copies, so it is not done.
//   - Softmax, whole-row path (T <= kWholeRowMaxT): the kernel first streams
//     all K tiles and keeps the block's 16 x T fp32 scores in shared memory,
//     then takes each row's max and sum (8 threads a row, float4 reads, xor
//     shuffles) and normalises in fp32 before the bf16 rounding, as the
//     Pallas kernel does; the P operand is rounded to bf16 as it is packed
//     into the mma's A fragment. Then it streams the V tiles. T <= 1024
//     covers every grid of the DDPM and ADM UNets.
//   - Softmax, online path (T > kWholeRowMaxT, where 16 rows of scores no
//     longer fit beside the ring): K and V tiles alternate; per key tile a
//     running row max m and sum l, the accumulators rescaled by
//     exp(m_old - m_new), and the unnormalised exp(s - m) rounded to bf16
//     for P V (one bf16 ulp of each probability from the Pallas rounding),
//     divided by l at the end.
//   - exp is __expf (ex2.approx): its error, ~2 ulp of fp32, is far below
//     the bf16 rounding of the probabilities that follows.
//   - What holds it back now: at (8, 256, 512) the tile copies land before
//     they are needed, and a block's time goes to the Q K^T and P V
//     products and the whole-row softmax (4 warps on 16 x 256 scores). At
//     the ADM heads (C = 64, T = 1024) each block re-reads all of K and V
//     for 16 query rows, 64 times per slab, and the kernel is several
//     times slower than SDPA there; a block of 64-128 rows, each warp on 16
//     rows and all C columns, is the design for C <= 128 (later work).
//
// Spatial shards (a map's rows split over processes, parallel/spatial.py):
// a shard's tokens are a contiguous block of the row-major sequence, so
// its queries attend to the keys and values gathered from every shard in
// rank order. Both forward kernels take the query count t_q and the key
// count t_k apart (ddnm_attention_kv): the grid, the Q rows and the output
// follow t_q; the key tiles, the TMA maps of K and V, the score rows and
// the masks follow t_k. Each shard computes only its own rows (t_q = T /
// sp), not the whole attention sliced. The four backward kernels do the
// same (ddnm_attention_bwd_dq_kv, ddnm_attention_bwd_dkdv_kv): the dq pass's
// grid, Q, dO, O, LSE and D follow t_q and its streamed K / V tiles, masks
// and TMA maps t_k; the dkdv pass's grid and dK / dV rows follow t_k and its
// streamed Q / dO tiles, LSE and D t_q. A shard's dK and dV are partials
// (its queries' share of every key's gradient): the caller sums the
// shards' in rank order (models/nn.py attention(spatial=)).
//
// fp32 (attn_kernel<float>; the fp32 parity runs, never the bf16 main
// path): fp32 FMA on the CUDA cores with an online softmax, not TF32 tensor
// cores: TF32 keeps about three decimal digits and would break the 1e-4
// gate against the plain version and the JAX golden. Q's tile sits in
// shared memory as fp32, K and V are streamed kDC columns at a time, and
// each thread keeps its share of the (kBQ, C) accumulator in registers; the
// kernel is bound by shared-memory reads (two per FMA).
//
// Backward (dQ, dK, dV of O = softmax(Q K^T scale) V, for the classifier-
// guidance gradient; no TPU counterpart: the JAX package differentiates
// its XLA attention). With P the probabilities, D = rowsum(dO o O),
// dS = P o (dO V^T - D), dQ = dS K scale, dK = dS^T Q scale, dV = P^T dO.
// Two passes, each writing its outputs once (no atomics, so two calls give
// the same bits): a dQ pass, which also stores each row's LSE and D, and a
// dK / dV pass that reads them. C (the head dimension) is a template
// parameter: 32, 64, 128. Two designs, chosen by the input type.
//
// bf16 (attn_bwd_dq_mma_kernel<C>, attn_bwd_dkdv_mma_kernel<C>; the
// guidance gradient of the bf16 classifier). Every product runs on the
// tensor cores: mma.sync m16n8k16, bf16 operands, fp32 accumulators. A
// block holds kBwdRows = 64 "resident" rows of one slab (4 warps, 16 rows
// and all C columns each), loaded once by cp.async into rows padded by 16
// bytes, and streams the other operand pair through a two-stage ring of
// tiles, by TMA tensor copies with the 128-byte swizzle where C % 64 == 0
// (the forward's (C, T, B) maps, rows past T arrive as zeros), by cp.async
// otherwise.
//   - dq: resident Q and dO, streamed K and V (64 keys a tile). A first
//     sweep over the K tiles takes each row's LSE from S = Q K^T alone (an
//     online max and sum per thread, combined over the row's 4 lanes); the
//     second sweep forms S and dP = dO V^T, P = exp(S scale - LSE) and dS =
//     P o (dP - D), rounds dS to bf16 straight from the accumulator
//     fragments into A fragments (no trip through shared memory) and adds
//     dS K to dQ, K read by ldmatrix.trans.
//   - dkdv: resident K and V, streamed Q and dO (64 rows a tile, 32 at C =
//     128, which keeps dK, dV and the tile's products within 255 registers
//     a thread), with each tile's LSE and D staged in shared memory one tile
//     ahead. Keys as rows: S^T = K Q^T, dP^T = V dO^T, then P^T and dS^T,
//     both rounded to bf16 into A fragments, dV += P^T dO and dK += dS^T Q,
//     dO and Q read by ldmatrix.trans; dK and dV stay in registers over all
//     query tiles.
//   Exponentials are ex2.approx in the base-2 domain (S scale log2 e); P
//   and dS are rounded to bf16 as mma operands, dS from the fp32 P.
//   Masks: keys past T give S = 0 from the zero rows, so they are set to
//   -inf (LSE) and P = 0 explicitly; query rows past T have P = dS = 0 in
//   the dkdv pass; rows past T are never stored.
//   - What holds them back: at (32, 1024, 64) the pair takes 2.3x SDPA's
//     autograd backward on an H100 (about 130 TFLOP/s of useful work).
//     Registers bound the blocks an SM (the dkdv kernel: 168 a thread at C
//     = 64, three blocks, 12 warps); every warp reads the whole streamed
//     tile through ldmatrix for its 16 rows; the dq pass sweeps K twice
//     (the LSE sweep is a quarter of its products). Warpgroup wgmma with a
//     producer warp, or the forward storing its LSE, is the next design.
//
// fp32 (attn_bwd_dq_kernel<float, C>, attn_bwd_dkdv_kernel<float, C>; the
// fp32 parity runs): fp32 FMA on the CUDA cores, as the fp32 forward and
// for the same reason (TF32 would break the 1e-4 gates), bound by shared-
// memory reads. The dq kernel takes bwd_rows(C) query rows a block and
// sweeps the key tiles twice (LSE, then dS and dQ); the dkdv kernel
// bwd_rows(C) keys a block over all query tiles. Rows and keys past T are
// zeros in shared memory and are masked out of every sum. Head dimensions
// 32, 64, 128 (the classifier's heads) and 256, 512 (the DDPM UNet's
// single-head AttnBlocks under training: the flagship's (16, 256, 512) and
// (16, 64, 512)). At C = 512 the staged rows alone would overflow a block's
// 227 KB, so that instantiation halves the rows a block and the tile
// (bwd_rows, bwd_per_lane): 128 threads, one block an SM. A simple design
// that is right; the tensor-core path of the bf16 kernels (C <= 128) is
// the model for a faster one.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kMaxC = 512;  // largest head dimension (C % 32 == 0)

// ------------------------------------------------- bf16: tensor cores

constexpr int kQ = 16;                 // query rows per block: one mma M tile
constexpr int kWarps = 4;              // each owns a quarter of the keys of a tile
                                       // (Q K^T) and of the output columns (P V)
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kStages = 2;             // K / V tiles in the ring
constexpr int kWholeRowMaxT = 1024;    // longest T whose score rows stay in shared memory
constexpr int kRowPad = 8;             // bf16 padding of a Q / K / V row in shared memory
constexpr int kScorePad = 8;           // fp32 padding of a score row

// Keys per K / V tile: 32-68 KB of bf16 per tile whatever C is.
__host__ __device__ constexpr int key_tile(int c_dim) {
  return c_dim > 256 ? 64 : (c_dim > 128 ? 128 : 256);
}

// K and V tiles arrive by TMA (tensor copies of 64-column boxes with the
// 128-byte swizzle) when C is a multiple of 64, otherwise by cp.async into
// padded rows.
__host__ __device__ constexpr bool uses_tma(int c_dim) { return c_dim % 64 == 0; }

// Shared-memory layout of attn_mma_kernel, in bytes (ops/attention.py
// `_attention_plan` computes the same total, and the entry point checks it).
// The K / V ring first (TMA: at the first 1024-byte boundary, which the
// swizzle needs, within 1024 bytes of slack), then the ring's mbarriers, Q,
// the (kQ, srow) fp32 scores and the per-row max, sum and rescale factor.
struct MmaLayout {
  int row;         // bf16 elements per Q row (and K / V row without TMA)
  int srow;        // fp32 elements per score row
  int stage;       // bytes per ring stage
  int bars;        // offsets
  int q;
  int scores;
  int stats;
  int total;
};

__host__ __device__ constexpr MmaLayout mma_layout(int t_len, int c_dim, int whole) {
  const int kt = key_tile(c_dim);
  const bool tma = uses_tma(c_dim);
  const int row = c_dim + kRowPad;
  const int srow = (whole ? (t_len + kt - 1) / kt * kt : kt) + kScorePad;
  const int stage = kt * (tma ? c_dim : row) * 2;
  const int bars = (tma ? 1024 : 0) + kStages * stage;
  const int q = bars + 8 * kStages;
  const int scores = q + kQ * row * 2;
  const int stats = scores + kQ * srow * 4;
  return MmaLayout{row, srow, stage, bars, q, scores, stats, stats + 3 * kQ * 4};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory; when !valid it writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// mbarrier with one arrival (the thread that posts the tile's bytes) and a
// transaction count (the bytes the bulk copies deliver).
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// TMA tensor copy of box (c, r, b) of `map` into shared memory, completing
// on `bar`.
__device__ __forceinline__ void tensor_copy(void* smem, const CUtensorMap* map, int c, int r,
                                            int b, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(smem)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(c), "r"(r),
      "r"(b), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float2 v) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<unsigned*>(&h);
}

// grid (ceil(Tq / kQ), B), block kMmaThreads, dynamic shared memory
// mma_layout(Tk, C, whole).total. q, o: (B, t_q, C); k, v: (B, t_k, C)
// (t_q < t_k: one spatial shard's queries against every shard's keys). C is a template parameter so that every
// loop over the head dimension unrolls. whole: the whole-row softmax (T <=
// kWholeRowMaxT); otherwise the online softmax. tm_k, tm_v: the (C, t_k, B)
// tensor maps of K and V (TMA only).
template <int C>
__global__ void __launch_bounds__(kMmaThreads)
attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                int t_q, int t_k, float scale, int whole,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v) {
  constexpr int KT = key_tile(C);
  constexpr int kNK = KT / (8 * kWarps);  // n8 key tiles of a warp in Q K^T
  constexpr int kNT = C / (8 * kWarps);   // n8 output column tiles of a warp in P V
  constexpr int kCvec = C / 8;            // 16-byte chunks per row
  constexpr int kSplit = kNK < 4 ? 4 / kNK : 1;
  constexpr bool kTma = uses_tma(C);
  constexpr int kBox = KT * 128;          // bytes of one 64-column TMA box
  extern __shared__ __align__(16) unsigned char smem[];
  const MmaLayout lay = mma_layout(t_k, C, whole);
  const unsigned ring = kTma ? (1024u - (smem_addr(smem) & 1023u)) & 1023u : 0u;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bars);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.q);
  float* ss = reinterpret_cast<float*>(smem + lay.scores);
  float* row_m = reinterpret_cast<float*>(smem + lay.stats);
  float* row_l = row_m + kQ;
  float* row_a = row_l + kQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row and column pair
  const int q0 = blockIdx.x * kQ;
  const size_t q_base = (size_t)blockIdx.y * t_q * C;
  const size_t kv_base = (size_t)blockIdx.y * t_k * C;
  const int n_kt = (t_k + KT - 1) / KT;  // key tiles
  const int n_tiles = 2 * n_kt;            // K and V tiles in stream order
  const int wcol = warp * (C / kWarps);    // this warp's first output column

  // stream order: whole-row K_0..K_n-1, V_0..V_n-1; online K_0, V_0, K_1, ...
  auto is_v = [&](int i) { return whole ? i >= n_kt : (i & 1); };
  auto key0 = [&](int i) { return (whole ? (i >= n_kt ? i - n_kt : i) : i >> 1) * KT; };
  auto stage = [&](int i) { return smem + ring + (i % kStages) * lay.stage; };
  // Tile i into its stage. TMA: lane 0 of warp 0 posts the tile's bytes on
  // the stage's barrier, and lane j copies box j of the C / 64 (<= 8)
  // 64-column boxes; rows past T arrive as zeros (they are outside the
  // (C, T, B) map). cp.async: all threads, rows past T zeroed.
  auto load_tile = [&](int i) {
    unsigned char* dst = stage(i);
    const int k0 = key0(i);
    if constexpr (kTma) {
      if (warp == 0) {
        unsigned long long* bar = bars + i % kStages;
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect(bar, KT * C * 2);
        }
        __syncwarp();
        if (lane < C / 64)  // one box a lane
          tensor_copy(dst + lane * kBox, is_v(i) ? &tm_v : &tm_k, lane * 64, k0, blockIdx.y, bar);
      }
    } else {
      const int valid = min(KT, t_k - k0);
      const __nv_bfloat16* src = (is_v(i) ? v : k) + kv_base + (size_t)k0 * C;
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(dst);
      for (int e = tid; e < KT * kCvec; e += kMmaThreads) {
        const int r = e / kCvec, ch = e - r * kCvec;
        cp_async16(d + r * lay.row + ch * 8, src + (size_t)(r < valid ? r : 0) * C + ch * 8,
                   r < valid);
      }
    }
  };
  // byte offset of the 8 columns col .. col + 7 of key row r in a stage
  // (col % 8 == 0): 128-byte swizzle within 64-column boxes, or padded rows
  auto kv_off = [&](int r, int col) {
    if constexpr (kTma)
      return (col >> 6) * kBox + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4);
    else
      return (r * lay.row + col) * 2;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // for the TMA unit
  }
  if (tid < kQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  for (int e = tid; e < kQ * kCvec; e += kMmaThreads) {
    const int r = e / kCvec, ch = e - r * kCvec;
    const bool ok = q0 + r < t_q;
    cp_async16(qs + r * lay.row + ch * 8, q + q_base + (size_t)(ok ? q0 + r : 0) * C + ch * 8,
               ok);
  }
  cp_async_commit();
  __syncthreads();  // the barriers are initialised
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    if constexpr (!kTma) cp_async_commit();
  }

  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // softmax threads: 8 a row (lanes 8 (r % 4) .. 8 (r % 4) + 7 of one warp),
  // each on 4 neighbouring scores of every 32
  const int sm_r = tid >> 3, sm_j = 4 * (tid & 7);
  float* sm_row = ss + sm_r * lay.srow;
  const float* p_row = ss + g * lay.srow + 2 * t4;  // this thread's P rows g, g + 8

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) load_tile(i + kStages - 1);
    if constexpr (kTma) {
      if (i == 0) {
        cp_async_wait<0>();  // Q
        __syncthreads();
      }
      mbar_wait(bars + i % kStages, (i / kStages) & 1);  // tile i has landed
    } else {
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // tile i (and Q) landed for this thread
      __syncthreads();               // ... and for every thread
    }
    const unsigned char* tile = stage(i);
    const int k0 = key0(i);
    if (!is_v(i)) {
      // S[:, k0 + KT / 4 warp + (0 .. KT / 4)] = Q K^T * scale, in kSplit x kNK
      // independent accumulator chains (the k steps alternate between splits)
      float s[kSplit][kNK][4];
#pragma unroll
      for (int u = 0; u < kSplit; ++u)
#pragma unroll
        for (int j = 0; j < kNK; ++j) s[u][j][0] = s[u][j][1] = s[u][j][2] = s[u][j][3] = 0.f;
      const __nv_bfloat16* qa = qs + (lane & 15) * lay.row + (lane >> 4) * 8;
      // B fragments of 16 keys: matrices (keys 0-7, cols c..c+7), (0-7, c+8..),
      // (8-15, c..), (8-15, c+8..)
      const int kr = warp * (KT / kWarps) + (lane & 7) + ((lane >> 4) << 3);
      const int kc = ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int c = 0; c < C; c += 16) {
        unsigned a[4];
        ldsm_x4(a, qa + c);
#pragma unroll
        for (int j = 0; j < kNK; j += 2) {
          unsigned b[4];
          ldsm_x4(b, tile + kv_off(kr + j * 8, c + kc));
          mma_bf16(s[(c / 16) % kSplit][j], a, b[0], b[1]);
          mma_bf16(s[(c / 16) % kSplit][j + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int u = 1; u < kSplit; ++u)
#pragma unroll
        for (int j = 0; j < kNK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[0][j][e] += s[u][j][e];
      float* srow = ss + g * lay.srow + (whole ? k0 : 0) + warp * (KT / kWarps) + 2 * t4;
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        *reinterpret_cast<float2*>(srow + j * 8) =
            make_float2(s[0][j][0] * scale, s[0][j][1] * scale);
        *reinterpret_cast<float2*>(srow + 8 * lay.srow + j * 8) =
            make_float2(s[0][j][2] * scale, s[0][j][3] * scale);
      }
    } else {
      if (!whole) {  // rescale by exp(m_old - m_new) of this key tile
        const float al0 = row_a[g], al1 = row_a[g + 8];
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          acc[n][0] *= al0;
          acc[n][1] *= al0;
          acc[n][2] *= al1;
          acc[n][3] *= al1;
        }
      }
      const float* p0 = p_row + (whole ? k0 : 0);
      const int vc = wcol + (lane >> 4) * 8;
#pragma unroll 4
      for (int ks = 0; ks < KT; ks += 16) {
        // A = P[:, keys ks .. ks + 15 of the tile], rounded to bf16 as it is packed
        const float* pk = p0 + ks;
        const unsigned a[4] = {pack_bf16(*reinterpret_cast<const float2*>(pk)),
                               pack_bf16(*reinterpret_cast<const float2*>(pk + 8 * lay.srow)),
                               pack_bf16(*reinterpret_cast<const float2*>(pk + 8)),
                               pack_bf16(*reinterpret_cast<const float2*>(pk + 8 * lay.srow + 8))};
        const int vr = ks + (lane & 15);
#pragma unroll
        for (int n = 0; n + 1 < kNT; n += 2) {
          unsigned b[4];
          ldsm_x4_trans(b, tile + kv_off(vr, vc + n * 8));
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
        if (kNT % 2) {
          unsigned b[4];
          ldsm_x2_trans(b, tile + kv_off(vr, vc + (kNT - 1) * 8));
          mma_bf16(acc[kNT - 1], a, b[0], b[1]);
        }
      }
    }
    __syncthreads();  // the stage is free for the copy issued next; S is complete

    if (!is_v(i) && !whole) {
      // online step over this key tile: KT / 8 scores a thread
      float sv[KT / 8];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < KT / 32; ++u) {
        const float4 x = *reinterpret_cast<const float4*>(sm_row + 32 * u + sm_j);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sv[4 * u + e] = k0 + 32 * u + sm_j + e < t_k ? xs[e] : -INFINITY;
          mx = fmaxf(mx, sv[4 * u + e]);
        }
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[sm_r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a real key
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < KT / 32; ++u) {
        float4 p;
        p.x = __expf(sv[4 * u] - m_new);  // 0 for the keys past T
        p.y = __expf(sv[4 * u + 1] - m_new);
        p.z = __expf(sv[4 * u + 2] - m_new);
        p.w = __expf(sv[4 * u + 3] - m_new);
        *reinterpret_cast<float4*>(sm_row + 32 * u + sm_j) = p;
        sum += (p.x + p.y) + (p.z + p.w);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (sm_j == 0) {
        const float alpha = __expf(m_old - m_new);
        row_l[sm_r] = row_l[sm_r] * alpha + sum;
        row_m[sm_r] = m_new;
        row_a[sm_r] = alpha;
      }
      __syncthreads();
    } else if (whole && i == n_kt - 1) {
      // whole rows: max, exp, sum, then normalise in fp32; keys past T get 0
      const int cols = n_kt * KT;
      float mx = -INFINITY;
#pragma unroll 4
      for (int j = sm_j; j < cols; j += 32) {
        const float4 x = *reinterpret_cast<const float4*>(sm_row + j);
        mx = fmaxf(mx, fmaxf(fmaxf(j < t_k ? x.x : -INFINITY, j + 1 < t_k ? x.y : -INFINITY),
                             fmaxf(j + 2 < t_k ? x.z : -INFINITY,
                                   j + 3 < t_k ? x.w : -INFINITY)));
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll 4
      for (int j = sm_j; j < cols; j += 32) {
        const float4 x = *reinterpret_cast<const float4*>(sm_row + j);
        float4 e;
        e.x = j < t_k ? __expf(x.x - mx) : 0.f;
        e.y = j + 1 < t_k ? __expf(x.y - mx) : 0.f;
        e.z = j + 2 < t_k ? __expf(x.z - mx) : 0.f;
        e.w = j + 3 < t_k ? __expf(x.w - mx) : 0.f;
        *reinterpret_cast<float4*>(sm_row + j) = e;
        sum += (e.x + e.y) + (e.z + e.w);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float inv = 1.f / sum;
#pragma unroll 4
      for (int j = sm_j; j < cols; j += 32) {
        float4 e = *reinterpret_cast<const float4*>(sm_row + j);
        e.x *= inv;
        e.y *= inv;
        e.z *= inv;
        e.w *= inv;
        *reinterpret_cast<float4*>(sm_row + j) = e;
      }
      __syncthreads();
    }
  }

  float inv0 = 1.f, inv1 = 1.f;
  if (!whole) {
    inv0 = 1.f / row_l[g];
    inv1 = 1.f / row_l[g + 8];
  }
  __nv_bfloat16* ob = o + q_base;
  const int r0 = q0 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    const int col = wcol + n * 8 + 2 * t4;
    if (r0 < t_q)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r0 * C + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < t_q)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r1 * C + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
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

// The (C, T, B) bf16 tensor map of x, read in (64, kt, 1) boxes with the
// 128-byte swizzle; reads past T fill zeros.
cudaError_t make_tensor_map(CUtensorMap* map, const void* x, int batch, int t_len, int c_dim,
                            int kt) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)c_dim, (cuuint64_t)t_len, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)c_dim * 2, (cuuint64_t)t_len * c_dim * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kt, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device the first time a launch needs more than 48 KB: `granted` is that
// kernel's per-device record, raised, never lowered.
cudaError_t grant_smem(const void* kernel, int* granted, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    granted[dev] = bytes;
  }
  return cudaSuccess;
}

// One launch of attn_mma_kernel<C>.
template <int C>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int batch,
                       int t_q, int t_k, float scale, int whole, int smem_bytes,
                       cudaStream_t s) {
  static int granted[kMaxDevices] = {};
  auto kernel = attn_mma_kernel<C>;
  cudaError_t err = grant_smem(reinterpret_cast<const void*>(kernel), granted, smem_bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_k = {}, tm_v = {};
  if constexpr (uses_tma(C)) {
    if ((err = make_tensor_map(&tm_k, k, batch, t_k, C, key_tile(C))) != cudaSuccess ||
        (err = make_tensor_map(&tm_v, v, batch, t_k, C, key_tile(C))) != cudaSuccess)
      return err;
  }
  dim3 grid((t_q + kQ - 1) / kQ, batch);
  kernel<<<grid, kMmaThreads, smem_bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), t_q, t_k, scale,
      whole, tm_k, tm_v);
  return cudaGetLastError();
}

// launch_mma<32 m> for c_dim = 32 m, m = 1 .. 16
template <int M = 1>
cudaError_t dispatch_mma(int c_dim, const void* q, const void* k, const void* v, void* o,
                         int batch, int t_q, int t_k, float scale, int whole, int smem_bytes,
                         cudaStream_t s) {
  if (c_dim == 32 * M)
    return launch_mma<32 * M>(q, k, v, o, batch, t_q, t_k, scale, whole, smem_bytes, s);
  if constexpr (32 * M < kMaxC)
    return dispatch_mma<M + 1>(c_dim, q, k, v, o, batch, t_q, t_k, scale, whole, smem_bytes,
                               s);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- fp32: CUDA-core FMA

constexpr int kBQ = 16;     // query rows per block
constexpr int kBK = 64;     // keys per tile
constexpr int kDC = 32;     // head-dimension columns per shared-memory chunk
constexpr int kThreads = 256;
constexpr int kMaxChunks = kMaxC / kDC;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// grid (ceil(Tq / kBQ), B), block kThreads. Static shared memory: 45.4 KB.
// q, o: (B, t_q, C); k, v: (B, t_k, C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ o, int t_q, int t_k, int c_dim, float scale) {
  __shared__ float qs[kBQ][kMaxC + 1];   // +1: rows of one warp hit other banks
  __shared__ float kv[kBK][kDC + 1];     // K chunk, then V chunk
  __shared__ float ps[kBQ][kBK];         // probabilities of the current tile
  __shared__ float alpha_s[kBQ];
  __shared__ float l_s[kBQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const size_t q_base = (size_t)blockIdx.y * t_q * c_dim;
  const size_t kv_base = (size_t)blockIdx.y * t_k * c_dim;
  const T* qb = q + q_base;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;
  T* ob = o + q_base;
  const int nchunks = c_dim / kDC;

  for (int e = tid; e < kBQ * c_dim; e += kThreads) {
    const int r = e / c_dim;
    const int d = e - r * c_dim;
    const int qi = q0 + r;
    qs[r][d] = qi < t_q ? to_f(qb[(size_t)qi * c_dim + d]) : 0.f;
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

  for (int kt = 0; kt < t_k; kt += kBK) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ch = 0; ch < nchunks; ++ch) {
      for (int e = tid; e < kBK * kDC; e += kThreads) {
        const int r = e / kDC;
        const int d = e - r * kDC;
        const int ki = kt + r;
        kv[r][d] = ki < t_k ? to_f(kb[(size_t)ki * c_dim + ch * kDC + d]) : 0.f;
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
      s[j] = kt + sk + 16 * j < t_k ? s[j] * scale : -INFINITY;
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
          kv[r][d] = ki < t_k ? to_f(vb[(size_t)ki * c_dim + ch * kDC + d]) : 0.f;
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
      if (r0 < t_q) ob[(size_t)r0 * c_dim + d] = from_f<T>(acc0[ch] * inv0);
      if (r1 < t_q) ob[(size_t)r1 * c_dim + d] = from_f<T>(acc1[ch] * inv1);
    }
  }
}

// ------------------------------------------------- backward, fp32: CUDA-core FMA

// The tiles of a head dimension: `rows` query rows a dq block and keys a
// dkdv block (8 threads each), `per_lane` keys (dq) or query rows (dkdv) a
// thread takes of each streamed tile of 8 * per_lane, and 8 * rows threads.
// 32 rows and tiles of 64 up to C = 256; at C = 512 the rows padded to C + 1
// floats would take 394 KB (dq) and 402 KB (dkdv) of shared memory, so 16
// rows and tiles of 32 (199 KB, 201 KB: one block an SM, 4 warps).
__host__ __device__ constexpr int bwd_rows(int c) { return c > 256 ? 16 : 32; }
__host__ __device__ constexpr int bwd_per_lane(int c) { return c > 256 ? 4 : 8; }
__host__ __device__ constexpr int bwd_threads(int c) { return 8 * bwd_rows(c); }

// Dynamic shared memory (floats) of the two kernels: rows padded by one
// float (C + 1) so the 8 rows a warp reads sit in 8 different banks.
__host__ __device__ constexpr int bwd_dq_smem_floats(int c) {
  return (2 * bwd_rows(c) + 2 * 8 * bwd_per_lane(c)) * (c + 1) +
         bwd_rows(c) * (8 * bwd_per_lane(c) + 1) + bwd_rows(c);
}
__host__ __device__ constexpr int bwd_dkdv_smem_floats(int c) {
  return (2 * bwd_rows(c) + 2 * 8 * bwd_per_lane(c)) * (c + 1) +
         2 * bwd_rows(c) * (8 * bwd_per_lane(c) + 1) + 2 * 8 * bwd_per_lane(c);
}

// Rows [r0, r0 + rows) of a (t_len, C) slab into shared memory as fp32,
// rows past t_len as zeros.
template <typename T, int C>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int r0,
                                          int rows, int t_len) {
  for (int e = threadIdx.x; e < rows * C; e += bwd_threads(C)) {
    const int r = e / C, c = e - r * C;
    dst[r * (C + 1) + c] = r0 + r < t_len ? to_f(src[(size_t)(r0 + r) * C + c]) : 0.f;
  }
}

// grid (ceil(Tq / QR), B*), block 8 QR threads (QR = bwd_rows(C)). Thread t
// owns query row t / 8 and keys t % 8 + 8 u (u < U = bwd_per_lane(C)) of each
// key tile of 8 U for the scores, and channels t % 8 + 8 w (w < C / 8) of its
// row for dQ. q, o, dout, dq: (B*, t_q, C); k, v: (B*, t_k, C); lse, dsum:
// (B*, t_q).
template <typename T, int C>
__global__ void __launch_bounds__(bwd_threads(C))
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
                   float* __restrict__ lse, float* __restrict__ dsum, int t_q, int t_k,
                   float scale) {
  constexpr int kBwdQ = bwd_rows(C), U = bwd_per_lane(C), kBwdK = 8 * U;
  constexpr int LD = C + 1, SD = kBwdK + 1, NW = C / 8;
  extern __shared__ float sm[];
  float* qs = sm;                  // [kBwdQ][LD]
  float* dos = qs + kBwdQ * LD;    // [kBwdQ][LD]
  float* ks = dos + kBwdQ * LD;    // [kBwdK][LD]
  float* vs = ks + kBwdK * LD;     // [kBwdK][LD]
  float* ss = vs + kBwdK * LD;     // [kBwdQ][SD]: dS of the tile
  float* row_d = ss + kBwdQ * SD;  // [kBwdQ]

  const int tid = threadIdx.x, r = tid >> 3, lane = tid & 7;
  const int q0 = blockIdx.x * kBwdQ;
  const size_t base = (size_t)blockIdx.y * t_q * C;     // q, o, dout, dq
  const size_t kv_base = (size_t)blockIdx.y * t_k * C;  // k, v
  load_rows<T, C>(qs, q + base, q0, kBwdQ, t_q);
  load_rows<T, C>(dos, dout + base, q0, kBwdQ, t_q);
  {  // D = rowsum(dO o O): 8 lanes a row
    float acc = 0.f;
    if (q0 + r < t_q)
      for (int c = lane; c < C; c += 8)
        acc += to_f(dout[base + (size_t)(q0 + r) * C + c]) * to_f(o[base + (size_t)(q0 + r) * C + c]);
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) row_d[r] = acc;
  }

  // sweep 1: each row's log-sum-exp
  float m = -INFINITY, l = 0.f;
  for (int kt = 0; kt < t_k; kt += kBwdK) {
    __syncthreads();
    load_rows<T, C>(ks, k + kv_base, kt, kBwdK, t_k);
    __syncthreads();
    float s[U] = {};
#pragma unroll 8
    for (int c = 0; c < C; ++c) {
      const float qv = qs[r * LD + c];
#pragma unroll
      for (int u = 0; u < U; ++u) s[u] = fmaf(qv, ks[(lane + 8 * u) * LD + c], s[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (kt + lane + 8 * u < t_k) {
        const float x = s[u] * scale;
        if (x > m) {
          l = l * expf(m - x) + 1.f;
          m = x;
        } else {
          l += expf(x - m);
        }
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, m2);
    l = (m == -INFINITY ? 0.f : l * expf(m - mn)) + (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
    m = mn;
  }
  const float row_lse = m + logf(l);  // every thread of the row holds it
  const float d_r = row_d[r];

  // sweep 2: dS and dQ
  float acc[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) acc[w] = 0.f;
  for (int kt = 0; kt < t_k; kt += kBwdK) {
    __syncthreads();
    load_rows<T, C>(ks, k + kv_base, kt, kBwdK, t_k);
    load_rows<T, C>(vs, v + kv_base, kt, kBwdK, t_k);
    __syncthreads();
    float s[U] = {};
    float dp[U] = {};
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float qv = qs[r * LD + c], dv = dos[r * LD + c];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = fmaf(qv, ks[(lane + 8 * u) * LD + c], s[u]);
        dp[u] = fmaf(dv, vs[(lane + 8 * u) * LD + c], dp[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = q0 + r < t_q && kt + lane + 8 * u < t_k;
      const float p = ok ? expf(s[u] * scale - row_lse) : 0.f;
      ss[r * SD + lane + 8 * u] = p * (dp[u] - d_r);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBwdK; ++j) {
      const float ds = ss[r * SD + j];
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[w] = fmaf(ds, ks[j * LD + lane + 8 * w], acc[w]);
    }
  }
  if (q0 + r < t_q) {
    T* dqr = dq + base + (size_t)(q0 + r) * C;
#pragma unroll
    for (int w = 0; w < NW; ++w) dqr[lane + 8 * w] = from_f<T>(acc[w] * scale);
    if (lane == 0) {
      lse[(size_t)blockIdx.y * t_q + q0 + r] = row_lse;
      dsum[(size_t)blockIdx.y * t_q + q0 + r] = d_r;
    }
  }
}

// grid (ceil(Tk / KV), B*), block 8 KV threads (KV = bwd_rows(C)). Thread t
// owns key t / 8 and query rows t % 8 + 8 u (u < U = bwd_per_lane(C)) of each
// query tile of 8 U for the scores, and channels t % 8 + 8 w (w < C / 8) of
// its key for dK and dV. q, dout: (B*, t_q, C); k, v, dk, dv: (B*, t_k, C);
// lse, dsum: (B*, t_q).
template <typename T, int C>
__global__ void __launch_bounds__(bwd_threads(C))
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                     int t_q, int t_k, float scale) {
  constexpr int kBwdKV = bwd_rows(C), U = bwd_per_lane(C), kBwdQT = 8 * U;
  constexpr int kBwdThreads = bwd_threads(C);
  constexpr int LD = C + 1, PD = kBwdQT + 1, NW = C / 8;
  extern __shared__ float sm[];
  float* ks = sm;                   // [kBwdKV][LD]
  float* vs = ks + kBwdKV * LD;     // [kBwdKV][LD]
  float* qs = vs + kBwdKV * LD;     // [kBwdQT][LD]
  float* dos = qs + kBwdQT * LD;    // [kBwdQT][LD]
  float* ps = dos + kBwdQT * LD;    // [kBwdKV][PD]
  float* dss = ps + kBwdKV * PD;    // [kBwdKV][PD]
  float* lse_s = dss + kBwdKV * PD; // [kBwdQT]
  float* d_s = lse_s + kBwdQT;      // [kBwdQT]

  const int tid = threadIdx.x, j = tid >> 3, lane = tid & 7;
  const int k0 = blockIdx.x * kBwdKV;
  const size_t base = (size_t)blockIdx.y * t_q * C;     // q, dout
  const size_t kv_base = (size_t)blockIdx.y * t_k * C;  // k, v, dk, dv
  const size_t rows = (size_t)blockIdx.y * t_q;
  load_rows<T, C>(ks, k + kv_base, k0, kBwdKV, t_k);
  load_rows<T, C>(vs, v + kv_base, k0, kBwdKV, t_k);
  float adk[NW], adv[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) adk[w] = adv[w] = 0.f;
  for (int qt = 0; qt < t_q; qt += kBwdQT) {
    __syncthreads();
    load_rows<T, C>(qs, q + base, qt, kBwdQT, t_q);
    load_rows<T, C>(dos, dout + base, qt, kBwdQT, t_q);
    for (int i = tid; i < kBwdQT; i += kBwdThreads) {
      lse_s[i] = qt + i < t_q ? lse[rows + qt + i] : 0.f;
      d_s[i] = qt + i < t_q ? dsum[rows + qt + i] : 0.f;
    }
    __syncthreads();
    float s[U] = {};
    float dp[U] = {};
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float kv = ks[j * LD + c], vv = vs[j * LD + c];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u] = fmaf(qs[(lane + 8 * u) * LD + c], kv, s[u]);
        dp[u] = fmaf(dos[(lane + 8 * u) * LD + c], vv, dp[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = lane + 8 * u;
      const bool ok = k0 + j < t_k && qt + i < t_q;
      const float p = ok ? expf(s[u] * scale - lse_s[i]) : 0.f;
      ps[j * PD + i] = p;
      dss[j * PD + i] = p * (dp[u] - d_s[i]);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kBwdQT; ++i) {
      const float p = ps[j * PD + i], ds = dss[j * PD + i];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        adv[w] = fmaf(p, dos[i * LD + lane + 8 * w], adv[w]);
        adk[w] = fmaf(ds, qs[i * LD + lane + 8 * w], adk[w]);
      }
    }
  }
  if (k0 + j < t_k) {
    T* dkr = dk + kv_base + (size_t)(k0 + j) * C;
    T* dvr = dv + kv_base + (size_t)(k0 + j) * C;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      dkr[lane + 8 * w] = from_f<T>(adk[w] * scale);
      dvr[lane + 8 * w] = from_f<T>(adv[w]);
    }
  }
}

// ------------------------------------------------- backward, bf16: tensor cores

constexpr int kBwdRows = 64;         // resident rows a block: 16 per warp
constexpr int kBwdMmaThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Blocks an SM the dq kernel is compiled for. At C = 64 (the classifier's
// heads) four: that caps it at 128 registers a thread (a 28-byte spill) and
// ran faster on an H100 than the three blocks its 155 registers allowed; at
// C = 32 the cap gained nothing, at C = 128 it spilled and ran slower.
__host__ __device__ constexpr int bwd_dq_min_blocks(int c_dim) { return c_dim == 64 ? 4 : 1; }

// Rows of a streamed tile: the dq kernel's key tiles, the dkdv kernel's
// query tiles (32 at C = 128, where dK and dV take 128 registers a thread).
__host__ __device__ constexpr int bwd_stream_rows(int c_dim, int dkdv) {
  return dkdv && c_dim > 64 ? 32 : 64;
}

// Shared-memory layout of the two bf16 backward kernels, in bytes
// (ops/attention.py `_bwd_plan` computes the same total, and the entry point
// checks it): the ring of streamed tiles (each stage an X tile, then a Y
// tile; TMA: at the first 1024-byte boundary, within 1024 bytes of slack),
// its mbarriers, the two resident arrays (kBwdRows padded rows each), then
// fp32 row statistics: dq: D of each resident row; dkdv: LSE log2 e and D
// of each streamed row, one pair of arrays per stage.
struct BwdLayout {
  int row;    // bf16 elements per resident row (and streamed row without TMA)
  int tile;   // bytes per streamed tile
  int stage;  // bytes per ring stage
  int bars;   // offsets
  int res;
  int stats;
  int total;
};

__host__ __device__ constexpr BwdLayout bwd_layout(int c_dim, int dkdv) {
  const int r = bwd_stream_rows(c_dim, dkdv);
  const bool tma = uses_tma(c_dim);
  const int row = c_dim + kRowPad;
  const int tile = r * (tma ? c_dim : row) * 2;
  const int bars = (tma ? 1024 : 0) + kStages * 2 * tile;
  const int res = bars + 8 * kStages;
  const int stats = res + 2 * kBwdRows * row * 2;
  const int n_stats = dkdv ? 2 * kStages * r : kBwdRows;
  return BwdLayout{row, tile, 2 * tile, bars, res, stats, stats + 4 * n_stats};
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of the 8 columns col .. col + 7 of row r in a streamed tile of
// R rows (col % 8 == 0): 128-byte swizzle within 64-column boxes, or padded
// rows
template <int C, int R>
__device__ __forceinline__ int st_off(int r, int col) {
  if constexpr (uses_tma(C))
    return (col >> 6) * (R * 128) + r * 128 + ((((col >> 3) & 7) ^ (r & 7)) << 4);
  else
    return (r * (C + kRowPad) + col) * 2;
}

// Rows r0 .. r0 + kBwdRows - 1 of a (t_len, C) slab into padded shared rows
// by cp.async, rows past t_len as zeros (the caller commits).
template <int C>
__device__ __forceinline__ void load_resident(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                              int r0, int t_len) {
  for (int e = threadIdx.x; e < kBwdRows * (C / 8); e += kBwdMmaThreads) {
    const int r = e / (C / 8), ch = e - r * (C / 8);
    const bool ok = r0 + r < t_len;
    cp_async16(dst + r * (C + kRowPad) + ch * 8, src + (size_t)(ok ? r0 + r : 0) * C + ch * 8,
               ok);
  }
}

// Streamed rows r0 .. r0 + R - 1 of X (and of Y when with_y) into the ring
// stage at dst: X's tile, then Y's. TMA: lane 0 of warp 0 posts the bytes
// on bar, lanes 0 .. C / 64 - 1 copy X's 64-column boxes and the next C / 64
// lanes Y's; rows past t_len arrive as zeros. cp.async (x, y: the slab's
// first rows): every thread, rows past t_len zeroed.
template <int C, int R>
__device__ __forceinline__ void load_stream(unsigned char* dst, const CUtensorMap* mx,
                                            const CUtensorMap* my, const __nv_bfloat16* x,
                                            const __nv_bfloat16* y, bool with_y, int r0,
                                            int t_len, unsigned long long* bar) {
  constexpr int kTile = R * (uses_tma(C) ? C : C + kRowPad) * 2;
  if constexpr (uses_tma(C)) {
    constexpr int kBoxes = C / 64;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp == 0) {
      if (lane == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(bar, (with_y ? 2 : 1) * R * C * 2);
      }
      __syncwarp();
      if (lane < kBoxes)
        tensor_copy(dst + lane * R * 128, mx, lane * 64, r0, blockIdx.y, bar);
      else if (with_y && lane < 2 * kBoxes)
        tensor_copy(dst + kTile + (lane - kBoxes) * R * 128, my, (lane - kBoxes) * 64, r0,
                    blockIdx.y, bar);
    }
  } else {
    constexpr int kChunks = R * (C / 8);
    const int valid = min(R, t_len - r0);
    for (int e = threadIdx.x; e < (with_y ? 2 : 1) * kChunks; e += kBwdMmaThreads) {
      const int w = e / kChunks, rem = e - w * kChunks;
      const int r = rem / (C / 8), ch = rem - r * (C / 8);
      const __nv_bfloat16* src = (w ? y : x) + (size_t)(r0 + (r < valid ? r : 0)) * C + ch * 8;
      cp_async16(dst + w * kTile + (r * (C + kRowPad) + ch * 8) * 2, src, r < valid);
    }
  }
}

// acc[j] = A B_j^T in fp32: A the warp's 16 resident rows (a_rows, padded,
// all C columns), B_j rows 8 j .. 8 j + 7 of a streamed tile
template <int C, int R, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4], const __nv_bfloat16* a_rows,
                                        const unsigned char* tile) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* pa = a_rows + (lane & 15) * (C + kRowPad) + (lane >> 4) * 8;
  // B fragments of 16 rows: matrices (rows 0-7, cols c..c+7), (0-7, c+8..),
  // (8-15, c..), (8-15, c+8..)
  const int br = (lane & 7) + ((lane >> 4) << 3), bc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int c = 0; c < C; c += 16) {
    unsigned a[4];
    ldsm_x4(a, pa + c);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      unsigned b[4];
      ldsm_x4(b, tile + st_off<C, R>(br + j * 8, c + bc));
      mma_bf16(acc[j], a, b[0], b[1]);
      mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// The (16, 8 NJ) accumulator tiles x rounded to bf16 as the A fragments of
// NJ / 2 k16 steps (the accumulator's row / column pairs are the A
// fragment's: no shuffle, no shared memory)
template <int NJ>
__device__ __forceinline__ void pack_a(unsigned (&a)[NJ / 2][4], const float (&x)[NJ][4]) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    a[kk][0] = pack_bf16(make_float2(x[2 * kk][0], x[2 * kk][1]));
    a[kk][1] = pack_bf16(make_float2(x[2 * kk][2], x[2 * kk][3]));
    a[kk][2] = pack_bf16(make_float2(x[2 * kk + 1][0], x[2 * kk + 1][1]));
    a[kk][3] = pack_bf16(make_float2(x[2 * kk + 1][2], x[2 * kk + 1][3]));
  }
}

// acc (16, C) += A (16, R; fragments a) . tile (R, C), the streamed tile
// read by ldmatrix.trans
template <int C, int R>
__device__ __forceinline__ void mma_a_tile(float (&acc)[C / 8][4], const unsigned (&a)[R / 16][4],
                                           const unsigned char* tile) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    const int r = kk * 16 + (lane & 15);
#pragma unroll
    for (int n = 0; n < C / 8; n += 2) {
      unsigned b[4];
      ldsm_x4_trans(b, tile + st_off<C, R>(r, (lane >> 4) * 8 + n * 8));
      mma_bf16(acc[n], a[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], a[kk], b[2], b[3]);
    }
  }
}

// The warp's 16 rows of a (16, C) accumulator times mul, rounded to bf16,
// into out (the slab); r0 is this thread's first row (the other is r0 + 8).
template <int C>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[C / 8][4],
                                           int r0, int t_len, float mul) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < C / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (r0 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r0 * C + col) =
          __floats2bfloat162_rn(acc[n][0] * mul, acc[n][1] * mul);
    if (r0 + 8 < t_len)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + 8) * C + col) =
          __floats2bfloat162_rn(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// grid (ceil(Tq / kBwdRows), B*), block kBwdMmaThreads, dynamic shared
// memory bwd_layout(C, 0).total. q, o, dout, dq: (B*, t_q, C); k, v: (B*,
// t_k, C); lse, dsum: (B*, t_q). tm_k, tm_v: the (C, Tk, B) tensor maps of K
// and V with boxes of 64 rows (TMA only). Streams 2 ceil(Tk / 64) tiles:
// K_0 .. K_n-1 (the LSE sweep), then (K, V)_0 .. (K, V)_n-1.
template <int C>
__global__ void __launch_bounds__(kBwdMmaThreads, bwd_dq_min_blocks(C))
attn_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
                       const __nv_bfloat16* __restrict__ dout, __nv_bfloat16* __restrict__ dq,
                       float* __restrict__ lse, float* __restrict__ dsum, int t_q, int t_k,
                       float scale,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v) {
  constexpr int R = bwd_stream_rows(C, 0);
  constexpr int NJ = R / 8;  // n8 key tiles of S and dP
  constexpr bool kTma = uses_tma(C);
  constexpr BwdLayout lay = bwd_layout(C, 0);
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned ring = kTma ? (1024u - (smem_addr(smem) & 1023u)) & 1023u : 0u;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bars);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.res);
  __nv_bfloat16* dos = qs + kBwdRows * lay.row;
  float* row_d = reinterpret_cast<float*>(smem + lay.stats);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kBwdRows;
  const size_t base = (size_t)blockIdx.y * t_q * C;     // q, o, dout, dq
  const size_t kv_base = (size_t)blockIdx.y * t_k * C;  // k, v
  const int n_t = (t_k + R - 1) / R;
  const int n_tiles = 2 * n_t;
  const float sl2 = scale * kLog2e;
  auto stage = [&](int i) { return smem + ring + (i % kStages) * lay.stage; };
  auto load = [&](int i) {
    load_stream<C, R>(stage(i), &tm_k, &tm_v, k + kv_base, v + kv_base, i >= n_t, (i % n_t) * R,
                      t_k, bars + i % kStages);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_resident<C>(qs, q + base, q0, t_q);
  load_resident<C>(dos, dout + base, q0, t_q);
  cp_async_commit();
  {  // D = rowsum(dO o O) in fp32: two threads a row, 16-byte loads
    const int r = tid >> 1;
    float acc = 0.f;
    if (q0 + r < t_q) {
      const size_t at = base + (size_t)(q0 + r) * C + (tid & 1) * (C / 2);
#pragma unroll
      for (int c = 0; c < C / 2; c += 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(dout + at + c);
        const uint4 b = *reinterpret_cast<const uint4*>(o + at + c);
        const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 fa = __bfloat1622float2(ha[u]), fb = __bfloat1622float2(hb[u]);
          acc = fmaf(fa.x, fb.x, fmaf(fa.y, fb.y, acc));
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) row_d[r] = acc;
  }
  __syncthreads();  // the barriers are initialised, D is in shared memory
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load(i);
    if constexpr (!kTma) cp_async_commit();
  }

  const __nv_bfloat16* qw = qs + warp * 16 * lay.row;  // this warp's 16 rows
  const __nv_bfloat16* dow = dos + warp * 16 * lay.row;
  const int row0 = q0 + warp * 16 + g;                   // this thread's rows: row0, row0 + 8
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // base-2 online max and sum
  float lse2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};
  float acc[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + kStages - 1 < n_tiles) load(i + kStages - 1);
    if constexpr (kTma) {
      if (i == 0) {
        cp_async_wait<0>();  // the resident rows
        __syncthreads();
      }
      mbar_wait(bars + i % kStages, (i / kStages) & 1);  // tile i has landed
    } else {
      cp_async_commit();
      cp_async_wait<kStages - 1>();  // tile i (and the resident rows) landed for this thread
      __syncthreads();               // ... and for every thread
    }
    const unsigned char* tile = stage(i);
    const int k0 = (i % n_t) * R;
    float s[NJ][4];
    mma_abt<C, R, NJ>(s, qw, tile);  // S = Q K^T of this key tile
    if (i < n_t) {
      // sweep 1: online max and sum of this thread's keys, rows row0 (h = 0)
      // and row0 + 8 (h = 1); keys past T are -inf
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[NJ][2], mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            x[j][e] = k0 + j * 8 + 2 * t4 + e < t_k ? s[j][2 * h + e] * sl2 : -INFINITY;
            mt = fmaxf(mt, x[j][e]);
          }
        const float mn = fmaxf(m[h], mt);
        if (mn != -INFINITY) {
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) sum += ex2(x[j][0] - mn) + ex2(x[j][1] - mn);
          l[h] = l[h] * ex2(m[h] - mn) + sum;
          m[h] = mn;
        }
      }
      if (i == n_t - 1) {
        // combine the row's 4 lanes; every row has a real key, so m is finite
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            const float m2 = __shfl_xor_sync(0xffffffffu, m[h], off);
            const float l2 = __shfl_xor_sync(0xffffffffu, l[h], off);
            const float mn = fmaxf(m[h], m2);
            l[h] = (m[h] == -INFINITY ? 0.f : l[h] * ex2(m[h] - mn)) +
                   (m2 == -INFINITY ? 0.f : l2 * ex2(m2 - mn));
            m[h] = mn;
          }
          lse2[h] = m[h] + log2f(l[h]);
          dd[h] = row_d[warp * 16 + g + 8 * h];
          const int r = row0 + 8 * h;
          if (t4 == 0 && r < t_q) {
            lse[(size_t)blockIdx.y * t_q + r] = lse2[h] * kLn2;
            dsum[(size_t)blockIdx.y * t_q + r] = dd[h];
          }
        }
      }
    } else {
      // sweep 2: dP = dO V^T, P, dS = P o (dP - D) rounded to bf16, dQ += dS K
      float dp[NJ][4];
      mma_abt<C, R, NJ>(dp, dow, tile + lay.tile);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p =
              k0 + j * 8 + 2 * t4 + (e & 1) < t_k ? ex2(s[j][e] * sl2 - lse2[h]) : 0.f;
          s[j][e] = p * (dp[j][e] - dd[h]);
        }
      unsigned a[R / 16][4];
      pack_a<NJ>(a, s);
      mma_a_tile<C, R>(acc, a, tile);
    }
    __syncthreads();  // the stage is free for the next copy
  }
  store_rows<C>(dq + base, acc, row0, t_q, scale);
}

// grid (ceil(Tk / kBwdRows), B*), block kBwdMmaThreads, dynamic shared
// memory bwd_layout(C, 1).total. q, dout: (B*, t_q, C); k, v, dk, dv: (B*,
// t_k, C); lse, dsum: (B*, t_q). tm_q, tm_do: the (C, Tq, B) tensor maps of Q
// and dO with boxes of bwd_stream_rows(C, 1) rows (TMA only). Streams the
// (Q, dO) tiles; each tile's LSE log2 e and D are read from global memory
// one tile ahead and staged in shared memory.
template <int C>
__global__ void __launch_bounds__(kBwdMmaThreads)
attn_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int t_q, int t_k, float scale,
                         const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do) {
  constexpr int R = bwd_stream_rows(C, 1);
  constexpr int NJ = R / 8;  // n8 query tiles of S^T and dP^T
  constexpr bool kTma = uses_tma(C);
  constexpr BwdLayout lay = bwd_layout(C, 1);
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned ring = kTma ? (1024u - (smem_addr(smem) & 1023u)) & 1023u : 0u;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem + lay.bars);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + lay.res);
  __nv_bfloat16* vs = ks + kBwdRows * lay.row;
  float* stats = reinterpret_cast<float*>(smem + lay.stats);  // [kStages][LSE log2 e | D][R]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kBwdRows;
  const size_t base = (size_t)blockIdx.y * t_q * C;     // q, dout
  const size_t kv_base = (size_t)blockIdx.y * t_k * C;  // k, v, dk, dv
  const size_t rows = (size_t)blockIdx.y * t_q;
  const int n_t = (t_q + R - 1) / R;
  const float sl2 = scale * kLog2e;
  auto stage = [&](int i) { return smem + ring + (i % kStages) * lay.stage; };
  auto load = [&](int i) {
    load_stream<C, R>(stage(i), &tm_q, &tm_do, q + base, dout + base, true, i * R, t_q,
                      bars + i % kStages);
  };
  // thread tid < 2 R: LSE log2 e (tid < R) or D of query row i R + tid % R
  // of tile i; 0 past T
  auto fetch = [&](int i) {
    const int qi = i * R + tid % R;
    if (tid >= 2 * R || i >= n_t || qi >= t_q) return 0.f;
    return tid < R ? lse[rows + qi] * kLog2e : dsum[rows + qi];
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  load_resident<C>(ks, k + kv_base, k0, t_k);
  load_resident<C>(vs, v + kv_base, k0, t_k);
  cp_async_commit();
  if (tid < 2 * R) stats[tid] = fetch(0);
  __syncthreads();  // the barriers are initialised, tile 0's statistics staged
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_t) load(i);
    if constexpr (!kTma) cp_async_commit();
  }

  const __nv_bfloat16* kw = ks + warp * 16 * lay.row;  // this warp's 16 keys
  const __nv_bfloat16* vw = vs + warp * 16 * lay.row;
  float adk[C / 8][4], adv[C / 8][4];
#pragma unroll
  for (int n = 0; n < C / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int i = 0; i < n_t; ++i) {
    if (i + kStages - 1 < n_t) load(i + kStages - 1);
    const float next = fetch(i + 1);  // staged after this tile's products
    if constexpr (kTma) {
      if (i == 0) {
        cp_async_wait<0>();  // the resident rows
        __syncthreads();
      }
      mbar_wait(bars + i % kStages, (i / kStages) & 1);
    } else {
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
    }
    const unsigned char* tile = stage(i);
    const float* lse_t = stats + (i % kStages) * 2 * R;
    const float* d_t = lse_t + R;
    const int q0 = i * R;
    float s[NJ][4], dp[NJ][4];
    mma_abt<C, R, NJ>(s, kw, tile);                // S^T = K Q^T
    mma_abt<C, R, NJ>(dp, vw, tile + lay.tile);    // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);  // query row of the tile
        const float p = q0 + col < t_q ? ex2(s[j][e] * sl2 - lse_t[col]) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - d_t[col]);
      }
    unsigned ap[R / 16][4], as[R / 16][4];
    pack_a<NJ>(ap, s);
    pack_a<NJ>(as, dp);
    mma_a_tile<C, R>(adv, ap, tile + lay.tile);  // dV += P^T dO
    mma_a_tile<C, R>(adk, as, tile);             // dK += dS^T Q
    if (tid < 2 * R) stats[((i + 1) % kStages) * 2 * R + tid] = next;
    __syncthreads();  // the stage is free for the next copy, tile i + 1's statistics staged
  }
  const int key0 = k0 + warp * 16 + g;
  store_rows<C>(dk + kv_base, adk, key0, t_k, scale);
  store_rows<C>(dv + kv_base, adv, key0, t_k, 1.f);
}

// One launch of the backward pass `which` (0: dq, 1: dkdv) in `dtype` (0:
// fp32 FMA kernels, 1: bf16 tensor-core kernels, C <= 128 only).
template <int C>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, float* lse, float* dsum,
                       int batch, int t_q, int t_k, float scale, int dtype, int which,
                       int smem_bytes, cudaStream_t s) {
  static int granted[2][2][kMaxDevices] = {};  // [dtype][which][device]
  using bf = __nv_bfloat16;
  if (dtype == 0) {
    const void* kernel = which == 0 ? reinterpret_cast<const void*>(attn_bwd_dq_kernel<float, C>)
                                    : reinterpret_cast<const void*>(attn_bwd_dkdv_kernel<float, C>);
    cudaError_t err = grant_smem(kernel, granted[0][which], smem_bytes);
    if (err != cudaSuccess) return err;
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v), *fdo = static_cast<const float*>(dout);
    constexpr int rows = bwd_rows(C);
    if (which == 0) {
      dim3 grid((t_q + rows - 1) / rows, batch);
      attn_bwd_dq_kernel<float, C><<<grid, bwd_threads(C), smem_bytes, s>>>(
          fq, fk, fv, static_cast<const float*>(o), fdo, static_cast<float*>(dq), lse, dsum,
          t_q, t_k, scale);
    } else {
      dim3 grid((t_k + rows - 1) / rows, batch);
      attn_bwd_dkdv_kernel<float, C><<<grid, bwd_threads(C), smem_bytes, s>>>(
          fq, fk, fv, fdo, lse, dsum, static_cast<float*>(dk), static_cast<float*>(dv), t_q,
          t_k, scale);
    }
    return cudaGetLastError();
  }
  if constexpr (C > 128) {
    return cudaErrorInvalidValue;
  } else {
    const void* kernel = which == 0 ? reinterpret_cast<const void*>(attn_bwd_dq_mma_kernel<C>)
                                    : reinterpret_cast<const void*>(attn_bwd_dkdv_mma_kernel<C>);
    cudaError_t err = grant_smem(kernel, granted[1][which], smem_bytes);
    if (err != cudaSuccess) return err;
    const bf *bq = static_cast<const bf*>(q), *bk = static_cast<const bf*>(k),
             *bv = static_cast<const bf*>(v), *bdo = static_cast<const bf*>(dout);
    CUtensorMap tx = {}, ty = {};  // the streamed pair: (K, V) for dq, (Q, dO) for dkdv
    const int t_stream = which ? t_q : t_k, t_res = which ? t_k : t_q;
    if constexpr (uses_tma(C)) {
      const int rows = bwd_stream_rows(C, which);
      if ((err = make_tensor_map(&tx, which ? q : k, batch, t_stream, C, rows)) != cudaSuccess ||
          (err = make_tensor_map(&ty, which ? dout : v, batch, t_stream, C, rows)) != cudaSuccess)
        return err;
    }
    dim3 grid((t_res + kBwdRows - 1) / kBwdRows, batch);
    if (which == 0)
      attn_bwd_dq_mma_kernel<C><<<grid, kBwdMmaThreads, smem_bytes, s>>>(
          bq, bk, bv, static_cast<const bf*>(o), bdo, static_cast<bf*>(dq), lse, dsum, t_q, t_k,
          scale, tx, ty);
    else
      attn_bwd_dkdv_mma_kernel<C><<<grid, kBwdMmaThreads, smem_bytes, s>>>(
          bq, bk, bv, bdo, lse, dsum, static_cast<bf*>(dk), static_cast<bf*>(dv), t_q, t_k, scale,
          tx, ty);
    return cudaGetLastError();
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

cudaError_t attention_bwd(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
                          int batch, int t_q, int t_k, int c_dim, float scale, int dtype,
                          int which, int smem_bytes, void* stream) {
  const bool fp32_dim = c_dim == 256 || c_dim == 512;  // the fp32 kernels' only
  if (batch <= 0 || batch > 65535 || t_q <= 0 || t_k <= 0 || (dtype != 0 && dtype != 1) ||
      (c_dim != 32 && c_dim != 64 && c_dim != 128 && !fp32_dim) || (dtype == 1 && fp32_dim))
    return cudaErrorInvalidValue;
  const int want = dtype == 1 ? bwd_layout(c_dim, which).total
                              : (which == 0 ? bwd_dq_smem_floats(c_dim)
                                            : bwd_dkdv_smem_floats(c_dim)) * 4;
  if (smem_bytes != want) return cudaErrorInvalidValue;
  if (dtype == 1) {  // 16-byte copies (cp.async, TMA, the D pass's loads)
    const void* ptrs[] = {q, k, v, dout, which == 0 ? o : dk, which == 0 ? dq : dv};
    for (const void* p : ptrs)
      if (!aligned16(p)) return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(dsum);
  switch (c_dim) {
    case 32:
      return launch_bwd<32>(q, k, v, o, dout, dq, dk, dv, l, d, batch, t_q, t_k, scale, dtype,
                            which, smem_bytes, s);
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, dq, dk, dv, l, d, batch, t_q, t_k, scale, dtype,
                            which, smem_bytes, s);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, dq, dk, dv, l, d, batch, t_q, t_k, scale, dtype,
                             which, smem_bytes, s);
    case 256:
      return launch_bwd<256>(q, k, v, o, dout, dq, dk, dv, l, d, batch, t_q, t_k, scale, dtype,
                             which, smem_bytes, s);
    default:
      return launch_bwd<512>(q, k, v, o, dout, dq, dk, dv, l, d, batch, t_q, t_k, scale, dtype,
                             which, smem_bytes, s);
  }
}

}  // namespace

extern "C" {

// The forward launch: q, o (batch, t_q, c_dim), k, v (batch, t_k, c_dim).
static int attention_entry(const void* q, const void* k, const void* v, void* o, int batch,
                           int t_q, int t_k, int c_dim, float scale, int dtype, int whole,
                           int smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_q < 1 || t_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    dim3 grid((t_q + kBQ - 1) / kBQ, batch);
    attn_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), t_q, t_k, c_dim, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if ((whole && t_k > kWholeRowMaxT) || mma_layout(t_k, c_dim, whole).total != smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch_mma(c_dim, q, k, v, o, batch, t_q, t_k, scale, whole, smem_bytes, s));
}

// q, k, v, o: (batch, t_len, c_dim) contiguous; dtype 0 = float32 (FMA
// kernel), 1 = bfloat16 (tensor-core kernel, 16-byte aligned pointers);
// c_dim % 32 == 0 and c_dim <= 512 (checked by the wrapper). For bf16 the
// launch plan is ops/attention.py `_attention_plan`: whole selects the
// whole-row softmax (t_len <= 1024), and smem_bytes is the kernel's
// shared-memory size for that plan. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel does not take.
int ddnm_attention(const void* q, const void* k, const void* v, void* o, int batch,
                   int t_len, int c_dim, float scale, int dtype, int whole, int smem_bytes,
                   void* stream) {
  return attention_entry(q, k, v, o, batch, t_len, t_len, c_dim, scale, dtype, whole,
                         smem_bytes, stream);
}

// The same with queries and keys of other lengths: q, o (batch, t_q, c_dim),
// k, v (batch, t_k, c_dim) (a spatial shard's queries against the keys and
// values gathered from every shard); whole and smem_bytes follow t_k.
int ddnm_attention_kv(const void* q, const void* k, const void* v, void* o, int batch,
                      int t_q, int t_k, int c_dim, float scale, int dtype, int whole,
                      int smem_bytes, void* stream) {
  return attention_entry(q, k, v, o, batch, t_q, t_k, c_dim, scale, dtype, whole, smem_bytes,
                         stream);
}

// Attention backward, first pass: q, k, v, o, dout, dq: (batch, t_len,
// c_dim) contiguous; dtype 0 = float32 (FMA kernel), 1 = bfloat16
// (tensor-core kernel, 16-byte aligned pointers); c_dim 32, 64 or 128, and
// for float32 also 256 or 512; lse,
// dsum: (batch, t_len) fp32, written (each row's log-sum-exp of the scaled
// scores and rowsum(dout o o)). smem_bytes: the kernel's dynamic shared
// memory (ops/attention.py `_bwd_plan`). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape, plan or pointer the kernel does not
// take.
int ddnm_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, void* dq, void* lse, void* dsum, int batch,
                          int t_len, int c_dim, float scale, int dtype, int smem_bytes,
                          void* stream) {
  return static_cast<int>(attention_bwd(q, k, v, o, dout, dq, nullptr, nullptr, lse, dsum,
                                        batch, t_len, t_len, c_dim, scale, dtype, 0,
                                        smem_bytes, stream));
}

// Attention backward, second pass: dk, dv (batch, t_len, c_dim) written
// from q, k, v, dout and the first pass's lse and dsum.
int ddnm_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* dsum, void* dk, void* dv, int batch,
                            int t_len, int c_dim, float scale, int dtype, int smem_bytes,
                            void* stream) {
  return static_cast<int>(attention_bwd(q, k, v, nullptr, dout, nullptr, dk, dv,
                                        const_cast<void*>(lse), const_cast<void*>(dsum), batch,
                                        t_len, t_len, c_dim, scale, dtype, 1, smem_bytes, stream));
}

// The two passes with queries and keys of other lengths (a spatial shard's
// queries against the keys and values gathered from every shard): q, o,
// dout, dq (batch, t_q, c_dim); k, v, dk, dv (batch, t_k, c_dim); lse, dsum
// (batch, t_q). The dq pass's grid runs over t_q and streams t_k keys, the
// dkdv pass's over t_k and streams t_q queries; the rest as above.
int ddnm_attention_bwd_dq_kv(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, void* dq, void* lse, void* dsum, int batch,
                             int t_q, int t_k, int c_dim, float scale, int dtype, int smem_bytes,
                             void* stream) {
  return static_cast<int>(attention_bwd(q, k, v, o, dout, dq, nullptr, nullptr, lse, dsum,
                                        batch, t_q, t_k, c_dim, scale, dtype, 0, smem_bytes,
                                        stream));
}

int ddnm_attention_bwd_dkdv_kv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* dsum, void* dk, void* dv, int batch,
                               int t_q, int t_k, int c_dim, float scale, int dtype,
                               int smem_bytes, void* stream) {
  return static_cast<int>(attention_bwd(q, k, v, nullptr, dout, nullptr, dk, dv,
                                        const_cast<void*>(lse), const_cast<void*>(dsum), batch,
                                        t_q, t_k, c_dim, scale, dtype, 1, smem_bytes, stream));
}

}  // extern "C\"
