// Shared device helpers of the repro_torch kernels.
//
// Every cross-thread sum here has a fixed order (xor-butterfly within a warp,
// then warps in index order), so a kernel gives the same bits on every run
// for the same launch geometry: no float atomics anywhere.  The solver's
// accept/reject and back-search decisions depend on these sums, and its
// same-seed replay contract needs them to be reproducible.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Loads and stores of the LM kernels, which read bf16 or fp32 tensors and
// compute in fp32 (the TPU kernels' contract: fp32 accumulation, the output
// in the input's dtype).
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Asynchronous 16-byte copies from global to shared memory (cp.async.cg):
// a copy with valid == false writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns [col, col + 4) of a row of n floats (zero past n): one 16-byte
// load, or, with ALIGNED false (n % 4 != 0 or a row that does not start on
// 16 bytes), four 4-byte loads of the same values.  STREAM marks data read
// once (evict first).
template <bool ALIGNED, bool STREAM>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int col, int n) {
  if constexpr (ALIGNED) {
    if (col >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
    const float4* p = reinterpret_cast<const float4*>(row + col);
    return STREAM ? __ldcs(p) : __ldg(p);
  } else {
    float e[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      e[q] = col + q < n ? (STREAM ? __ldcs(row + col + q) : __ldg(row + col + q)) : 0.f;
    return make_float4(e[0], e[1], e[2], e[3]);
  }
}

// acc + <x, y>, the four products in order.
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  acc = fmaf(x.x, y.x, acc);
  acc = fmaf(x.y, y.y, acc);
  acc = fmaf(x.z, y.z, acc);
  return fmaf(x.w, y.w, acc);
}

// Max over the 32 lanes of a warp; every lane returns the same value.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sum over the 32 lanes of a warp (float or double); every lane returns the
// same value.  The warp must be full (blockDim.x a multiple of 32).
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the whole block; every thread returns the same value.
// `red` is shared scratch of at least 33 values; blockDim.x a multiple of 32.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  x = warp_sum(x);
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = 0;
    for (int w = 0; w < nw; ++w) t += red[w];
    red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// out[row] = (sum_b part[b * d + row]) / div over nb partial rows, one warp
// per output row, lanes striding over b in a fixed order.  Called by every
// warp of a block; `first_warp`/`warp_stride` spread the rows over warps.
__device__ __forceinline__ void reduce_partials(const float* __restrict__ part,
                                                int nb, int d, float div,
                                                float* out, int first_warp,
                                                int warp_stride) {
  const int lane = threadIdx.x & 31;
  for (int row = first_warp; row < d; row += warp_stride) {
    float acc = 0.f;
    for (int b = lane; b < nb; b += 32) acc += part[(size_t)b * d + row];
    acc = warp_sum(acc);
    if (lane == 0) out[row] = acc / div;
  }
}

// out[row] = sum over b < nb of part[row * nbp + b] for the d rows of a
// (d, nbp) scratch that other blocks of this launch wrote (nbp: nb rounded
// up to 4, entries past nb are padding).  Called by the whole block, after
// a __threadfence() that follows those blocks' writes: each warp sums 8 rows
// at a time with 16-byte loads through L2 (16 a lane in flight), lanes over
// quads of b in increasing order, then the lanes in a fixed order, so the
// result has the same bits on every run.  Rows are written by lane 0 of
// their warp; the caller syncs before reading.
__device__ __forceinline__ void fold_rows(const float* __restrict__ part, int nbp, int nb,
                                          int d, float* __restrict__ out) {
  constexpr int kRows = 8, kQuads = 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nq = nbp / 4;
  for (int row0 = warp; row0 < d; row0 += nw * kRows) {
    float acc[kRows];
#pragma unroll
    for (int g = 0; g < kRows; ++g) acc[g] = 0.f;
    for (int q0 = lane; q0 < nq; q0 += 32 * kQuads) {
      float4 x[kRows][kQuads];
#pragma unroll
      for (int g = 0; g < kRows; ++g)
#pragma unroll
        for (int m = 0; m < kQuads; ++m) {
          const int row = row0 + nw * g, q = q0 + 32 * m;
          x[g][m] = row < d && q < nq
                        ? __ldcg(reinterpret_cast<const float4*>(part + (size_t)row * nbp) + q)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int g = 0; g < kRows; ++g)
#pragma unroll
        for (int m = 0; m < kQuads; ++m) {
          const int b0 = 4 * (q0 + 32 * m);
          if (b0 < nb) acc[g] += x[g][m].x;
          if (b0 + 1 < nb) acc[g] += x[g][m].y;
          if (b0 + 2 < nb) acc[g] += x[g][m].z;
          if (b0 + 3 < nb) acc[g] += x[g][m].w;
        }
    }
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const float tot = warp_sum(acc[g]);
      if (lane == 0 && row0 + nw * g < d) out[row0 + nw * g] = tot;
    }
  }
}


// ------------------------------------------------- streaming row products
// The stream of row_gram (B3/B4) and of the commit (B7/B8): the row sums of
// R v over one strip of N, one partial per (row, strip).  A block of
// kStreamWarps warps takes the strip; lane l owns its 16-byte column slices
// col + 128 s (col = strip start + 4 l, s < slices = strip / 128, at most
// kStreamSlices) and holds its slices of v in registers (load_strip, once a
// strip).  Each warp then reads all slices of one row at once (4 KB in
// flight a warp), sums them against v in slice order and then over the
// warp, and lane 0 writes part[row * nbp + blockIdx.x].  Rows go to the
// warps round-robin.  No shared memory and no barrier before the stream.
constexpr int kStreamThreads = 256;
constexpr int kStreamWarps = kStreamThreads / 32;
constexpr int kStreamSlices = 8;

template <bool ALIGNED>
__device__ __forceinline__ void load_strip(const float* __restrict__ v, int col, int slices,
                                           int n, float4 (&vr)[kStreamSlices]) {
#pragma unroll
  for (int q = 0; q < kStreamSlices; ++q)
    vr[q] = q < slices ? load4<ALIGNED, false>(v, col + 128 * q, n)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
}

template <bool ALIGNED>
__device__ __forceinline__ void stream_rows(const float* __restrict__ r,
                                            const float4 (&vr)[kStreamSlices], int col,
                                            int slices, int d, int n,
                                            float* __restrict__ part, int nbp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < d; row += kStreamWarps) {
    const float* src = r + (size_t)row * n;
    float4 x[kStreamSlices];
#pragma unroll
    for (int q = 0; q < kStreamSlices; ++q)
      x[q] = q < slices ? load4<ALIGNED, true>(src, col + 128 * q, n)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < kStreamSlices; ++q)
      if (q < slices) acc = dot4(x[q], vr[q], acc);
    acc = warp_sum(acc);
    if (lane == 0) part[(size_t)row * nbp + blockIdx.x] = acc;
  }
}

// True in every thread of the block that is the last of `total` blocks to
// arrive at `counter` (an int in device memory, zero before the first
// arrival), false in the others; the writes of every arrived block are then
// visible to it.  Called by the whole block.  The atomic only picks that
// block, so the sums it goes on to take keep a fixed order; the block resets
// the counter when it is done.
__device__ __forceinline__ bool last_to_arrive(int* counter, int total) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == total - 1;
  __syncthreads();
  if (!s_last) return false;
  __threadfence();
  return true;
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
