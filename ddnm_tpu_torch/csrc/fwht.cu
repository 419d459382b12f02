// Walsh-Hadamard transform of fp32 slabs: out[n] = H_P x[n] / norm, P a power
// of two up to 65536, H_P the natural-order (Sylvester) Hadamard matrix.
//
// Replaces the Pallas kernel ddnm_tpu/ops/fwht.py (_fwht_kernel /
// _pallas_fwht), which computes H_a X H_b per slab (x reshaped row-major to
// (a, b), a b = P) as two dense fp32 matmuls on the TPU's matrix unit, with
// the whole 256 KB slab and both Hadamard matrices in VMEM.
//
// That does not carry over. A slab at P = 65536 is more than the 227 KB of
// shared memory a Hopper block can have, and the dense products spend
// 2 (a + b) flops per element where H has only +-1 entries. So this is the
// butterfly instead: log2(P) stages of add/subtract, exact in the sense
// that each output is a +-1 sum of the inputs in fp32 (no TF32, no tensor
// cores, no atomics: the same bits on every launch).
//
// What bounds it on an H100: the bytes. At the SVD path's shape (24 slabs
// of 65536) a call must read 6.3 MB and write 6.3 MB, 3.8 us at 3.35 TB/s,
// against 25 M fp32 adds, 0.4 us at 67 TFLOP/s. So the design moves each
// byte through device memory once each way, in one launch, and keeps every
// stage on chip. The cluster's exchange (step 3 below) still moves 7/8 of
// every slab between SMs once, a third pass over the data on the chip.
//
// One launch, all stages on chip. A stage adds and subtracts across one bit
// of an element's index, and the stages commute, so each bit is taken where
// it lives at some point of the kernel:
//
//   A CTA holds a tile of 2^S floats (S = 11..13, 32 KB at S = 13), 64 in
//   the registers of each of its 2^(S-6) threads. A slab wider than a tile
//   is split over a thread-block cluster of K = P / 2^S CTAs (K <= 8, the
//   portable limit), each holding one contiguous chunk; a slab narrower
//   than a tile shares it with its neighbours (K = 1, 2^S / P slabs a CTA).
//
//   1. load: thread t takes 16 float4 at e = 4t + j 2^(S-4) (j < 16),
//      16-byte loads, a warp on 512 contiguous bytes. Its registers span
//      index bits 0, 1 (the float4) and S-4..S-1 (j): 6 stages of adds.
//   2. one shared-memory transpose (one __syncthreads): thread t now holds
//      the 64 elements e0(t) | m << 2, so its registers span bits 2..7
//      (the stages not taken in step 1); its lanes sit on bits 0, 1, 8, 9,
//      10 and its warps on bits 11..S-1. The words are XOR-swizzled (bits
//      8..10 into bits 2..4), so that the float4 stores of step 1, the
//      scalar loads here and the float4 loads of step 3 are each free of
//      bank conflicts. The thread writes its 64 results back to the words
//      it read: no barrier between.
//   3. the cluster's bits, through distributed shared memory: after one
//      cluster barrier (barrier.cluster arrive.release / wait.acquire; a
//      __syncthreads at K = 1) rank r takes the r-th K-th of the chunk's
//      indices i, in 16 / K float4 slots a thread whose lowest slot bit is
//      index bit 8 at S = 13 (the one bit steps 1 and 2 leave), and reads
//      each slot from every rank's shared memory (mapa +
//      ld.shared::cluster.v4, 16 bytes a load): bit 8, then the last
//      log2(K) stages (H_K across the ranks), as adds in registers. Each
//      result goes straight to device memory with a 16-byte store, never
//      back to shared memory, so the cluster reads each chunk once over
//      DSMEM (not K times). A second cluster barrier, arrived at after the
//      remote loads and waited for at exit, keeps every CTA's shared
//      memory alive until its peers have read it.
//
// Barriers a call: one __syncthreads and two cluster barriers (K > 1), or
// two __syncthreads (K = 1); the two-launch version before it had 18. No
// shuffles: a first layout of 32 floats a thread needed three stages by
// __shfl_xor_sync and was no faster.
//
// The stores are inline st.global.v4.f32 (the default cache policy), which
// keeps them in program order between the scaling multiplies: in a
// comparison on the H100 a plain C++ float4 store, which ptxas schedules
// otherwise, was clearly slower at the SVD path's shape.
//
// The division: where norm is a power of two (img_dim = 256, 64, 32: every
// SVD path), the result is multiplied by 1 / norm, which is exact and so
// gives the bits of the division; otherwise it is divided (IEEE, __fdiv_rn).
//
// The launch plan (tile S, cluster K) is chosen in Python, ops/fwht.py
// `_fwht_plan`: the largest tile that still gives 2 CTAs an SM, else the
// most CTAs. At the SVD path's (24, 65536), K = 8 and S = 13: 192 CTAs of
// 128 threads and 32 KB, all resident at once (at most 2 an SM: 176
// registers a thread). At phase 6's (6, 65536) it is 48 CTAs on 48 of the
// 132 SMs: the card is a third busy, and that shape's time is the latency
// of one CTA's chain (load, stages, barriers, DSMEM, stores).

#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

namespace {

constexpr int kMaxP = 65536;
constexpr int kTileMin = 11;  // log2 floats of a CTA's tile: 32 threads, 8 KB
constexpr int kTileMax = 13;  // 128 threads, 32 KB of shared memory
constexpr int kRegs = 64;     // floats a thread holds (16 float4)
constexpr int kMaxCluster = 8;

// word index of element e in a tile: bits 8..10 XOR-ed into bits 2..4
__device__ __forceinline__ int swz(int e) { return e ^ (((e >> 8) & 7) << 2); }

// the stage across bit `h` (a power of two) of the register index
template <int N>
__device__ __forceinline__ void butterfly(float (&r)[N], int h) {
#pragma unroll
  for (int m = 0; m < N; ++m) {
    if (m & h) continue;
    const float u = r[m], v = r[m | h];
    r[m] = u + v;
    r[m | h] = u - v;
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// a 16-byte store to device memory, kept in program order (asm volatile)
__device__ __forceinline__ void st_global(float* p, float4 v) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// 16 bytes of rank `rank`'s shared memory at the local address `local`
__device__ __forceinline__ float4 ld_cluster(const float* local, uint32_t rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(local));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote) : "memory");
  return v;
}

// Step 3's index bits above the lanes' (bits 7 and up of a rank's slice),
// in the order the float4 slots (u) and then the warps take them: at S = 13
// bit 8, which no earlier step holds in registers, comes first, so that it
// is u's lowest bit.
template <int S>
__host__ __device__ constexpr int slice_bit(int idx) {
  return S == 13 && idx < 2 ? 8 - idx : 7 + idx;
}

// grid: one CTA per tile of 2^S floats (n K at K > 1, in clusters of K);
// block: 2^(S-6) threads. `local_bits` = log2 of the part of a slab one CTA
// holds (min(log2 P, S)); `total` = n P; `count` is masked only at K = 1.
template <int S, int K>
__global__ void __launch_bounds__(1 << (S - 6))
fwht_kernel(const float* __restrict__ x, float* __restrict__ out, long long total,
            int local_bits, float scale, int divide) {
  constexpr int T = 1 << (S - 6);
  constexpr int TILE = 1 << S;
  constexpr int LK = K == 8 ? 3 : K == 4 ? 2 : K == 2 ? 1 : 0;
  constexpr int U = 16 / K;  // float4 slots of a rank's slice a thread takes
  constexpr int LU = 4 - LK;
  __shared__ __align__(16) float s[TILE];
  const int t = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  const long long left = total - base;
  const int count = K > 1 || left >= TILE ? TILE : static_cast<int>(left);

  // 1. load; stages on bits 0, 1 and S-4..S-1
  float r[kRegs];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int e = j * (4 * T) + 4 * t;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e + 4 <= count) {
      v = *reinterpret_cast<const float4*>(x + base + e);
    } else if (e < count) {  // the ragged end at P < 4 (K = 1 only)
      v.x = x[base + e];
      if (e + 1 < count) v.y = x[base + e + 1];
      if (e + 2 < count) v.z = x[base + e + 2];
    }
    r[4 * j] = v.x, r[4 * j + 1] = v.y, r[4 * j + 2] = v.z, r[4 * j + 3] = v.w;
  }
#pragma unroll
  for (int b = 0; b < 6; ++b)
    if ((b < 2 ? b : S - 6 + b) < local_bits) butterfly(r, 1 << b);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    *reinterpret_cast<float4*>(s + swz(j * (4 * T) + 4 * t)) =
        make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  __syncthreads();

  // 2. transpose: registers on bits 2..7 (those below S-4: step 1 took the
  // rest), lanes on bits 0, 1, 8, 9, 10, warps on bits 11..S-1
  const int e0 = (t & 3) | (((t >> 2) & 7) << 8) | ((t >> 5) << 11);
#pragma unroll
  for (int m = 0; m < kRegs; ++m) r[m] = s[swz(e0 | (m << 2))];
#pragma unroll
  for (int b = 0; b < 6; ++b)
    if (2 + b < S - 4 && 2 + b < local_bits) butterfly(r, 1 << b);
#pragma unroll
  for (int m = 0; m < kRegs; ++m) s[swz(e0 | (m << 2))] = r[m];

  // 3. H_K across the cluster's ranks (and bit 8 at S = 13), the scale,
  // the stores. Rank r takes the r-th K-th of the chunk's indices.
  uint32_t rank = 0;
  if constexpr (K > 1) {
    rank = cluster_rank();
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  int warp_off = 0;
#pragma unroll
  for (int c = 0; c < S - 11; ++c) warp_off |= ((t >> (5 + c)) & 1) << slice_bit<S>(LU + c);
  const int i0 = static_cast<int>(rank) * (TILE / K) + (t & 31) * 4 + warp_off;
  float4 d[U][K];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int i = i0;
#pragma unroll
    for (int a = 0; a < LU; ++a) i |= ((u >> a) & 1) << slice_bit<S>(a);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if constexpr (K > 1)
        d[u][q] = ld_cluster(s + swz(i), q);
      else
        d[u][q] = *reinterpret_cast<const float4*>(s + swz(i));
    }
  }
  if (S == 13 && 8 < local_bits) {  // bit 8 is u's lowest bit
#pragma unroll
    for (int u = 0; u < U; u += 2) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const float4 a = d[u][q], b = d[u + 1][q];
        d[u][q] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        d[u + 1][q] = make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
      }
    }
  }
#pragma unroll
  for (int h = 1; h < K; h <<= 1) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (q & h) continue;
        const float4 a = d[u][q], b = d[u][q | h];
        d[u][q] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        d[u][q | h] = make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
      }
    }
  }
  if constexpr (K > 1) cluster_arrive();  // this CTA has read its peers
  // the slab's first element: the cluster's first tile (base itself at K = 1)
  float* dst = out + base - static_cast<long long>(rank) * TILE;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    int i = i0;
#pragma unroll
    for (int a = 0; a < LU; ++a) i |= ((u >> a) & 1) << slice_bit<S>(a);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      float4 v = d[u][q];
      if (divide) {
        v = make_float4(__fdiv_rn(v.x, scale), __fdiv_rn(v.y, scale),
                        __fdiv_rn(v.z, scale), __fdiv_rn(v.w, scale));
      } else {
        v = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
      }
      const int e = q * TILE + i;
      if (K > 1 || e + 4 <= count) {
        st_global(dst + e, v);
      } else if (e < count) {
        dst[e] = v.x;
        if (e + 1 < count) dst[e + 1] = v.y;
        if (e + 2 < count) dst[e + 2] = v.z;
      }
    }
  }
  if constexpr (K > 1) cluster_wait();  // the peers have read this CTA
}

template <int S, int K>
cudaError_t launch(const float* x, float* out, long long tiles, long long total,
                   int local_bits, float scale, int divide, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles));
  cfg.blockDim = dim3(1u << (S - 6));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, fwht_kernel<S, K>, x, out, total, local_bits, scale, divide);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int S>
cudaError_t launch_k(int k, const float* x, float* out, long long tiles, long long total,
                     int local_bits, float scale, int divide, cudaStream_t stream) {
  switch (k) {
    case 1: return launch<S, 1>(x, out, tiles, total, local_bits, scale, divide, stream);
    case 2: return launch<S, 2>(x, out, tiles, total, local_bits, scale, divide, stream);
    case 4: return launch<S, 4>(x, out, tiles, total, local_bits, scale, divide, stream);
    case 8: return launch<S, 8>(x, out, tiles, total, local_bits, scale, divide, stream);
    default: return cudaErrorInvalidValue;
  }
}

int log2_exact(int v) {
  int m = 0;
  while ((1 << m) < v) ++m;
  return m;
}

}  // namespace

extern "C" {

// x, out: (n, p) contiguous float32 on 16 bytes, distinct buffers; p a power
// of two, 1 <= p <= 65536. The plan (ops/fwht.py `_fwht_plan`): tiles of
// 2^log_tile floats, `cluster` CTAs a slab (p = cluster 2^log_tile) or 1
// (p <= 2^log_tile). One launch on `stream`. Returns the launch's error
// (cudaGetLastError()), or cudaErrorInvalidValue for a plan it does not take.
int ddnm_fwht(const void* x, void* out, int n, int p, int log_tile, int cluster, float norm,
              void* stream) {
  if (n <= 0 || p <= 0 || p > kMaxP || (p & (p - 1)) != 0 || log_tile < kTileMin ||
      log_tile > kTileMax || cluster < 1 || cluster > kMaxCluster ||
      (cluster & (cluster - 1)) != 0 ||
      (cluster > 1 ? p != (cluster << log_tile) : p > (1 << log_tile)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * p;
  const long long tiles = (total + (1LL << log_tile) - 1) >> log_tile;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int local_bits = log2_exact(p) < log_tile ? log2_exact(p) : log_tile;
  int expo = 0;  // a power of two norm = 2^(expo - 1) whose inverse is a normal float
  const bool pow2 = frexpf(norm, &expo) == 0.5f && expo > -124 && expo < 127;
  const float scale = pow2 ? ldexpf(1.f, 1 - expo) : norm;
  const int divide = pow2 ? 0 : 1;
  const float* xs = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (log_tile) {
    case 11: err = launch_k<11>(cluster, xs, o, tiles, total, local_bits, scale, divide, st); break;
    case 12: err = launch_k<12>(cluster, xs, o, tiles, total, local_bits, scale, divide, st); break;
    case 13: err = launch_k<13>(cluster, xs, o, tiles, total, local_bits, scale, divide, st); break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
