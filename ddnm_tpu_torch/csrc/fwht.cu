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
// cores). Since H_P = H_a (x) H_b, the stages split in two launches:
//
//   1. rows: each block loads 4096 contiguous floats (whole rows of length
//      b) into shared memory, runs the log2(b) stages there and writes them
//      out;
//   2. columns, in place: each block loads an (a, w) strip of one slab
//      (w = min(b, 32) neighbouring columns, so each row segment is one
//      128-byte load), runs the log2(a) stages down the columns, divides by
//      norm and writes the strip back.
//
// The result is the same for any factorisation a b = P, so the entry point
// takes P and picks the balanced a >= b itself (a, b <= 256).
//
// What bounds it on an H100: the bytes. At the SVD path's shape (24 slabs
// of 65536) a call must read 6.3 MB and write 6.3 MB, 3.8 us at 3.35 TB/s,
// against 25 M fp32 adds, 0.4 us at 67 TFLOP/s. This simple version moves
// the data twice (the intermediate stays in the 50 MB L2 at that size) and
// syncs the block between stages; faster versions are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 4096;  // floats per block in the row pass (16 KB)
constexpr int kColW = 32;       // columns per block in the column pass
constexpr int kMaxA = 256;      // a = 2^ceil(log2(P) / 2) <= 256
constexpr int kMaxP = 65536;

// grid (ceil(total / kRowTile)), block kThreads. A tile holds whole rows:
// b <= 256 divides kRowTile, and total is a multiple of b.
__global__ void __launch_bounds__(kThreads)
fwht_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                 long long total, int log_b) {
  __shared__ float s[kRowTile];
  const long long base = static_cast<long long>(blockIdx.x) * kRowTile;
  const long long left = total - base;
  const int count = left < kRowTile ? static_cast<int>(left) : kRowTile;
  for (int e = threadIdx.x; e < count; e += kThreads) s[e] = x[base + e];
  __syncthreads();
  const int half = count >> 1;
  for (int st = 0; st < log_b; ++st) {
    const int h = 1 << st;
    // pair p -> (i, i + h): i has bit `st` clear; 2h <= b keeps both in one row
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int i = ((p >> st) << (st + 1)) | (p & (h - 1));
      const float u = s[i], v = s[i + h];
      s[i] = u + v;
      s[i + h] = u - v;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < count; e += kThreads) out[base + e] = s[e];
}

// grid (n, b / w), block kThreads; y is read and written in place.
__global__ void __launch_bounds__(kThreads)
fwht_cols_kernel(float* __restrict__ y, int a, int b, int log_a, int log_w,
                 float norm) {
  __shared__ float s[kMaxA * kColW];
  const int w = 1 << log_w;
  float* slab = y + static_cast<long long>(blockIdx.x) * a * b + blockIdx.y * w;
  const int count = a << log_w;
  for (int e = threadIdx.x; e < count; e += kThreads)
    s[e] = slab[static_cast<long long>(e >> log_w) * b + (e & (w - 1))];
  __syncthreads();
  const int half = count >> 1;
  for (int st = 0; st < log_a; ++st) {
    const int h = 1 << st;
    // pair p -> column c, rows (r, r + h) with bit `st` of r clear
    for (int p = threadIdx.x; p < half; p += kThreads) {
      const int c = p & (w - 1);
      const int q = p >> log_w;
      const int r = ((q >> st) << (st + 1)) | (q & (h - 1));
      const int i = (r << log_w) | c;
      const int j = ((r + h) << log_w) | c;
      const float u = s[i], v = s[j];
      s[i] = u + v;
      s[j] = u - v;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < count; e += kThreads)
    slab[static_cast<long long>(e >> log_w) * b + (e & (w - 1))] = s[e] / norm;
}

int log2_exact(int v) {
  int m = 0;
  while ((1 << m) < v) ++m;
  return m;
}

}  // namespace

extern "C" {

// x, out: (n, p) contiguous float32, distinct buffers; p a power of two,
// 1 <= p <= 65536. Two launches on `stream`. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernels do not take.
int ddnm_fwht(const void* x, void* out, int n, int p, float norm, void* stream) {
  if (n <= 0 || p <= 0 || p > kMaxP || (p & (p - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = log2_exact(p);
  const int log_a = (m + 1) / 2, log_b = m - log_a;
  const int a = 1 << log_a, b = 1 << log_b;
  const int log_w = log_b < 5 ? log_b : 5;  // w = min(b, kColW)
  const long long total = static_cast<long long>(n) * p;
  const long long row_blocks = (total + kRowTile - 1) / kRowTile;
  if (row_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fwht_rows_kernel<<<static_cast<unsigned>(row_blocks), kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out), total, log_b);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fwht_cols_kernel<<<dim3(n, b >> log_w), kThreads, 0, st>>>(
      static_cast<float*>(out), a, b, log_a, log_w, norm);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
