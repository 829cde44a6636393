// Residual Gram products of the ICOA covariance engine, fp32 in, fp32 sums.
//
// repro_gram replaces src/repro/kernels/gram/kernel.py gram_pallas (B1):
//   out = R R^T for R (D, N), N >> D.  The TPU kernel walked N sequentially
//   into one VMEM accumulator.  Here blocks run in parallel, so the N axis is
//   split: block (pair, split) computes one 64x64 output tile of the upper
//   triangle over one N-chunk (64x32 slabs of both row ranges through shared
//   memory, 4x4 outputs per thread, fp32 FMA) and writes it to its own
//   partial slice; a second kernel sums the slices in split order and mirrors
//   the upper triangle, so the result is exactly symmetric and the same bits
//   on every run.
//   Bound on an H100: fp32 FMAs, about D(D+1)N of them; at D=100 the D x N
//   read (105 MB at N=262144) takes less than half as long as the arithmetic
//   at 67 TFLOP/s.  Tensor cores are not used: TF32 would break the fp32
//   contract of the TPU kernel.  The split count is chosen by the wrapper so
//   that a few hundred blocks fill the 132 SMs though D/64 gives few tiles.
//
// repro_row_gram replaces src/repro/kernels/gram/kernel.py row_gram_pallas
// (B3): out = R v for one N-vector v.
//   Bound: the single read of R (one FMA per 4 bytes).  Each block stages a
//   1024-wide strip of v in shared memory and streams the matching strip of
//   every row of R with one warp per row (coalesced 128-byte loads, 8 in
//   flight per lane), writing per-block partial dot products; a second pass
//   sums them in block order.
//
// repro_gram_batched and repro_row_gram_batched replace
// gram_pallas_batched (B2) and row_gram_pallas_batched (B4): the same
// products for B independent Monte-Carlo trials, R (B, D, N).  The trial is
// one more grid dimension of the same kernels (blockIdx.z for gram,
// blockIdx.y for row_gram) and each trial has its own partial slices, so a
// trial uses the N blocks, the split count and the summation order of the
// single-trial launch: slice b of a batched result is the single-trial
// result on trial b, bit for bit.  Bound: B times the single-trial bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;      // gram output tile edge
constexpr int kBk = 32;        // instances per shared-memory step
constexpr int kGramThreads = 256;
constexpr int kRowBn = 1024;   // row_gram strip width (columns per block)
constexpr int kRowThreads = 256;

__global__ void __launch_bounds__(kGramThreads)
gram_partial_kernel(const float* __restrict__ r, float* __restrict__ part,
                    int d, int n, int chunk, int tiles) {
  // this block's trial: its own R and its own `splits` partial slices
  r += (size_t)blockIdx.z * d * n;
  part += (size_t)blockIdx.z * gridDim.y * d * d;
  // upper-triangle tile pair (ti <= tj) of this block
  int p = blockIdx.x, ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const int row0 = ti * kTile, col0 = tj * kTile;
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(n, k_begin + chunk);

  __shared__ float sa[kBk][kTile + 1];
  __shared__ float sb[kBk][kTile + 1];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBk) {
    for (int q = threadIdx.x; q < kTile * kBk; q += kGramThreads) {
      const int rr = q / kBk, kk = q % kBk, k = k0 + kk;
      float va = 0.f, vb = 0.f;
      if (k < k_end) {
        if (row0 + rr < d) va = r[(size_t)(row0 + rr) * n + k];
        if (col0 + rr < d) vb = r[(size_t)(col0 + rr) * n + k];
      }
      sa[kk][rr] = va;
      sb[kk][rr] = vb;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = sa[kk][ty + 16 * u];
        b[u] = sb[kk][tx + 16 * u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.y * d * d;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = row0 + ty + 16 * u, j = col0 + tx + 16 * v;
      if (i < d && j < d) dst[(size_t)i * d + j] = acc[u][v];
    }
}

// out[i][j] = sum over splits of the partial entry (min(i,j), max(i,j)):
// upper-triangle tiles hold every (a, b) with a <= b.  blockIdx.y is the trial.
__global__ void gram_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ out, int d, int splits) {
  part += (size_t)blockIdx.y * splits * d * d;
  out += (size_t)blockIdx.y * d * d;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= d * d) return;
  const int i = idx / d, j = idx % d;
  const int a = min(i, j), b = max(i, j);
  const size_t off = (size_t)a * d + b, stride = (size_t)d * d;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += part[q * stride + off];
  out[idx] = s;
}

__global__ void __launch_bounds__(kRowThreads)
row_gram_partial_kernel(const float* __restrict__ r, const float* __restrict__ v,
                        float* __restrict__ part, int d, int n, int v_stride) {
  // blockIdx.y is the trial; v_stride is n for a per-trial v, 0 for a v
  // shared by every trial
  r += (size_t)blockIdx.y * d * n;
  v += (size_t)blockIdx.y * v_stride;
  part += (size_t)blockIdx.y * gridDim.x * d;
  __shared__ float vs[kRowBn];
  const int n0 = blockIdx.x * kRowBn;
  const int cols = min(kRowBn, n - n0);
  for (int t = threadIdx.x; t < kRowBn; t += kRowThreads)
    vs[t] = t < cols ? v[n0 + t] : 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row = warp; row < d; row += kRowThreads / 32) {
    const float* rr = r + (size_t)row * n + n0;
    float acc = 0.f;
#pragma unroll 8
    for (int c = lane; c < cols; c += 32) acc = fmaf(rr[c], vs[c], acc);
    acc = repro::warp_sum(acc);
    if (lane == 0) part[(size_t)blockIdx.x * d + row] = acc;
  }
}

__global__ void rows_reduce_kernel(const float* __restrict__ part, int nb,
                                   int d, float* __restrict__ out) {
  part += (size_t)blockIdx.y * nb * d;                      // the trial
  out += (size_t)blockIdx.y * d;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  repro::reduce_partials(part, nb, d, 1.f, out, warp, nwarps);
}

}  // namespace

namespace {

int launch_gram(const float* r, float* part, float* out, int d, int n,
                int chunk, int splits, int batch, cudaStream_t st) {
  const int tiles = (d + kTile - 1) / kTile;
  dim3 grid(tiles * (tiles + 1) / 2, splits, batch);
  gram_partial_kernel<<<grid, kGramThreads, 0, st>>>(r, part, d, n, chunk, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int total = d * d;
  gram_reduce_kernel<<<dim3((total + 255) / 256, batch), 256, 0, st>>>(
      part, out, d, splits);
  return cudaGetLastError();
}

int launch_row_gram(const float* r, const float* v, float* part, float* out,
                    int d, int n, int v_stride, int batch, cudaStream_t st) {
  const int nb = (n + kRowBn - 1) / kRowBn;
  row_gram_partial_kernel<<<dim3(nb, batch), kRowThreads, 0, st>>>(
      r, v, part, d, n, v_stride);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps_per_block = 8;
  const int blocks = (d + warps_per_block - 1) / warps_per_block;
  rows_reduce_kernel<<<dim3(blocks, batch), 32 * warps_per_block, 0, st>>>(
      part, nb, d, out);
  return cudaGetLastError();
}

}  // namespace

// r (d, n) fp32; part (splits, d, d) scratch; out (d, d).
// The wrapper picks chunk (a multiple of 32) and splits = ceil(n / chunk).
extern "C" int repro_gram(const float* r, float* part, float* out, int d,
                          int n, int chunk, int splits, void* stream) {
  return launch_gram(r, part, out, d, n, chunk, splits, 1,
                     static_cast<cudaStream_t>(stream));
}

// r (batch, d, n) fp32; part (batch, splits, d, d) scratch; out (batch, d, d).
// chunk and splits are the single-trial launch's for (d, n).
extern "C" int repro_gram_batched(const float* r, float* part, float* out,
                                  int d, int n, int chunk, int splits,
                                  int batch, void* stream) {
  return launch_gram(r, part, out, d, n, chunk, splits, batch,
                     static_cast<cudaStream_t>(stream));
}

// r (d, n), v (n,) fp32; part (ceil(n / 1024), d) scratch; out (d,).
extern "C" int repro_row_gram(const float* r, const float* v, float* part,
                              float* out, int d, int n, void* stream) {
  return launch_row_gram(r, v, part, out, d, n, 0, 1,
                         static_cast<cudaStream_t>(stream));
}

// r (batch, d, n); v (batch, n) with v_stride = n, or (n,) shared by every
// trial with v_stride = 0; part (batch, ceil(n / 1024), d); out (batch, d).
extern "C" int repro_row_gram_batched(const float* r, const float* v,
                                      float* part, float* out, int d, int n,
                                      int v_stride, int batch, void* stream) {
  return launch_row_gram(r, v, part, out, d, n, v_stride, batch,
                         static_cast<cudaStream_t>(stream));
}
