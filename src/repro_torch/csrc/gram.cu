// Residual Gram products of the ICOA covariance engine, fp32 in, fp32 sums.
//
// repro_gram replaces src/repro/kernels/gram/kernel.py gram_pallas (B1):
//   out = R R^T for R (D, N), N >> D.  The TPU kernel walked N sequentially
//   into one VMEM accumulator; here the N axis is split over blocks.
//   Bound on an H100: fp32 FMAs (no TF32: the TPU kernel's fp32 contract),
//   D(D+1)/2 distinct outputs times N; the D x N read takes less than half
//   as long at 67 TFLOP/s.  So the design spends its FMAs on the upper
//   triangle only and feeds them from registers:
//   - A block owns one N-chunk of one upper-triangle pair of 128-row tiles.
//     At D <= 128 (the deployment's D=100, the paper's D=5) there is one
//     diagonal tile, and the block loads ONE slab of R per step; off-
//     diagonal pairs (D > 128) load two.
//   - A thread accumulates an 8x8 micro-tile of outputs in registers.  In a
//     diagonal tile only the micro-tiles on or above the diagonal have a
//     thread (91 at D=100: 5,824 outputs per instance for 5,050 needed),
//     taken in bands of 8 columns so that a warp reads at most 8 distinct
//     rows of each operand (one shared-memory wavefront a read).
//   - Slabs sit in shared memory as [row][k], each 8-row group followed by
//     16 bytes of padding: a warp's 16-byte reads (threads on different
//     8-row groups, same k) then hit distinct banks, and a thread addresses
//     its 8 rows as one register plus immediates.  16 LDS.128 feed 256
//     FMAs.  At 384 threads a thread may hold 168 registers; ptxas's report
//     (chip_smoke.py's build phase logs it) shows no spill but 12 bytes in
//     the one-group, 4-byte-load kernel (D > 128 with N % 4 != 0).
//   - A 3-stage ring of cp.async copies fills step k+2 while step k is
//     multiplied; a warp copies whole rows, lane by lane.  16-byte copies
//     need rows that start on 16 bytes (N % 4 == 0 and an aligned base);
//     otherwise the same kernel (template flag, picked by the wrapper)
//     copies 4 bytes at a time.  Past the chunk's end and past row D both
//     zero-fill.  Only the loads differ, so the sums and their bits are the
//     same on either path.
//   - A block holds KG thread groups (up to 4, as many as 384 threads
//     allow) that each take one 32-instance sub-slab of every step (so a
//     step is 32 KG instances); the groups' sums meet in shared memory in
//     group order.  That gives each SM 12 warps at D=100 and cuts the
//     partial results per N-chunk by KG.
//   - The wrapper (kernels/gram/ops.py, gram_geometry) cuts N into as many
//     chunks as fill one wave of blocks on the card.  Each block writes its
//     partial tile; a second launch sums the partials of every output in a
//     fixed order (8 warps over the chunks, then the warps in order) with
//     many loads in flight, and writes both triangles, so the result is
//     exactly symmetric and the same bits on every run.  A second launch
//     and not a last-arriving block: the partials (chunks x D(D+1)/2
//     floats, ~2.6 MB at D=100) would all go through one SM.
//
// repro_row_gram replaces src/repro/kernels/gram/kernel.py row_gram_pallas
// (B3): out = R v for one N-vector v.
//   Bound: the single read of R (one FMA per 4 bytes), so the design keeps
//   HBM busy with few instructions per byte: a block of 8 warps takes a
//   strip of N, and each lane owns 16-byte column slices of it (up to 8,
//   the strip's width over 128 columns).  The lane holds its slices of v in
//   registers, loaded once, with no shared memory and no barrier before the
//   stream; a warp reads all slices of a row at once (4 KB in flight per
//   warp, ~64 KB per SM at two blocks) and sums the row over the warp once,
//   after the strip.  The wrapper sizes the strip so that the grid is whole
//   waves.  The same unaligned-load rule as gram applies.  The stream loop
//   lives in common.cuh (repro::stream_rows), shared with the commit
//   kernel of sweep.cu (B7/B8), which streams R against delta the same
//   way.  Block b writes
//   the row sums of its strip; the last block to arrive (an integer counter
//   per trial, in a workspace the wrapper keeps zeroed; it resets it) sums
//   them in block order in the same launch, with 16-byte loads of 4 rows at
//   once.  The atomic only picks that block: no float atomics, the same
//   bits on every run.  The counters assume one stream at a time, as the
//   port runs.
//
// repro_gram_batched and repro_row_gram_batched replace
// gram_pallas_batched (B2) and row_gram_pallas_batched (B4): the same
// products for B independent Monte-Carlo trials, R (B, D, N).  The trial is
// one more grid dimension of the same kernels (blockIdx.z for gram,
// blockIdx.y for row_gram), with its own partials and counter, and the
// launch geometry depends on (D, N) and the card only: slice b of a
// batched result is the single-trial result on trial b, bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

constexpr int kTile = 128;        // gram tile edge
constexpr int kMicro = 8;         // micro-tile edge (outputs per thread: 8 x 8)
constexpr int kGroups = kTile / kMicro;
constexpr int kBk = 32;           // instances per thread group per step
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kGramMaxThreads = 384;
constexpr int kGramMaxShared = 232448;   // an H100 block's shared-memory limit
constexpr int kRowThreads = repro::kStreamThreads;   // row_gram: 8 warps
constexpr int kRowSlices = repro::kStreamSlices;     // most 16-byte slices per lane per row

// 4-byte copy into shared memory (cp.async.ca); valid == false writes zero.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ int groups_in_tile(int d, int t) {
  return min(kGroups, (d - t * kTile + kMicro - 1) / kMicro);
}

// Floats of one slab: `groups` 8-row groups of RS floats a row, 4 floats
// of padding after each group.  Row lr of a slab starts at
// lr * RS + 4 * (lr / 8): rows 8 apart then start on different banks, and
// a thread's reads of its 8 rows are one base register plus immediates.
template <int KG>
__device__ __forceinline__ int slab_floats(int groups) {
  return groups * (kMicro * kBk * KG + 4);
}

// One step of the ring: the slab of tile ti (rows_a rows), then that of
// tile tj (none for a diagonal pair), instances [k0, k0 + 32 KG).  A warp
// copies whole rows, its lanes on consecutive 16-byte (or 4-byte) pieces.
template <bool ALIGNED, int KG>
__device__ __forceinline__ void gram_load(uint32_t dst, const float* __restrict__ r, int d,
                                          int n, int k0, int k_end, int ti, int tj,
                                          int rows_a, int rows) {
  constexpr int RS = kBk * KG;                    // floats per slab row
  constexpr int PER_ROW = ALIGNED ? RS / 4 : RS;  // copies per row
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int b_base = slab_floats<KG>(rows_a / kMicro);
  for (int ls = threadIdx.x >> 5; ls < rows; ls += warps) {
    const bool in_a = ls < rows_a;
    const int lr = in_a ? ls : ls - rows_a;       // row in its own slab
    const int grow = (in_a ? ti : tj) * kTile + lr;
    const float* src_row = r + (size_t)min(grow, d - 1) * n;
    const uint32_t dst_row = dst + 4u * ((in_a ? 0 : b_base) + lr * RS + 4 * (lr >> 3));
#pragma unroll
    for (int e = lane; e < PER_ROW; e += 32) {
      const int k = k0 + (ALIGNED ? 4 * e : e);
      const bool ok = grow < d && k < k_end;
      const float* src = ok ? src_row + k : r;
      const uint32_t at = dst_row + 4u * (ALIGNED ? 4 * e : e);
      if (ALIGNED)
        cp_async16(at, src, ok);
      else
        cp_async4(at, src, ok);
    }
  }
}

template <bool ALIGNED, int KG>
__global__ void __launch_bounds__(kGramMaxThreads)
gram_partial_kernel(const float* __restrict__ r, float* __restrict__ part, int d, int n,
                    int chunk, int tiles) {
  constexpr int RS = kBk * KG;              // floats per slab row; instances per step
  constexpr int GROUP = kMicro * RS + 4;    // floats of an 8-row group
  r += (size_t)blockIdx.z * d * n;                                // the trial
  part += ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * d * d;  // its chunk's slice
  int p = blockIdx.x, ti = 0;                                     // tile pair ti <= tj
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  const int tj = ti + p;
  const bool diag = ti == tj;
  const int ga = groups_in_tile(d, ti), gb = groups_in_tile(d, tj);
  const int rows_a = ga * kMicro, rows = rows_a + (diag ? 0 : gb * kMicro);
  const int stage = slab_floats<KG>(ga) + (diag ? 0 : slab_floats<KG>(gb));

  // this thread's group (a 32-instance sub-slab) and micro-tile (a, b)
  const int gt = blockDim.x / KG, grp = threadIdx.x / gt, t = threadIdx.x % gt;
  int a = 0, b = 0;
  bool active;
  if (diag) {
    // the triangle in bands of 8 columns, rows in turn within a band: a
    // warp's threads then read at most 8 distinct rows of each operand
    active = false;
    for (int b0 = 0, q = t; b0 < ga && !active; b0 += 8) {
      const int b1 = min(b0 + 8, ga);
      for (int aa = 0; aa < b1 && !active; ++aa) {
        const int lo = max(aa, b0);
        if (q < b1 - lo) {
          active = true;
          a = aa;
          b = lo + q;
        }
        q -= b1 - lo;
      }
    }
  } else {
    active = t < ga * gb;
    a = t / gb;
    b = t % gb;
  }

  extern __shared__ __align__(16) float smem[];
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(smem);
  const int k_begin = blockIdx.y * chunk, k_end = min(n, k_begin + chunk);
  const int steps = (k_end - k_begin + RS - 1) / RS;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int u = 0; u < kMicro; ++u)
#pragma unroll
    for (int v = 0; v < kMicro; ++v) acc[u][v] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      gram_load<ALIGNED, KG>(s_base + 4u * s * stage, r, d, n, k_begin + s * RS, k_end, ti, tj,
                             rows_a, rows);
    cp_async_commit();
  }
  const int a_off = a * GROUP + grp * kBk;
  const int b_off = (diag ? 0 : slab_floats<KG>(ga)) + b * GROUP + grp * kBk;
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step it has landed; step it - 1 is no longer read
    const int nx = it + kStages - 1;
    if (nx < steps)
      gram_load<ALIGNED, KG>(s_base + 4u * (nx % kStages) * stage, r, d, n, k_begin + nx * RS,
                             k_end, ti, tj, rows_a, rows);
    cp_async_commit();
    if (active) {
      const float* st = smem + (it % kStages) * stage;
      const float* sa = st + a_off;
      const float* sb = st + b_off;
      // float2 steps along k (the compiler pairs them into LDS.128); each
      // output adds its products in k order
#pragma unroll
      for (int c = 0; c < kBk / 2; ++c) {
        float2 av[kMicro];
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
          av[u] = *reinterpret_cast<const float2*>(sa + u * RS + 2 * c);
#pragma unroll
        for (int v = 0; v < kMicro; ++v) {
          const float2 bv = *reinterpret_cast<const float2*>(sb + v * RS + 2 * c);
#pragma unroll
          for (int u = 0; u < kMicro; ++u)
            acc[u][v] = fmaf(av[u].y, bv.y, fmaf(av[u].x, bv.x, acc[u][v]));
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring is free: it holds the groups' sums now

  if (KG > 1) {
    if (grp > 0 && active) {
#pragma unroll
      for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v)
          smem[((grp - 1) * kMicro * kMicro + u * kMicro + v) * gt + t] = acc[u][v];
    }
    __syncthreads();
    if (grp == 0 && active) {
#pragma unroll
      for (int g = 1; g < KG; ++g)
#pragma unroll
        for (int u = 0; u < kMicro; ++u)
#pragma unroll
          for (int v = 0; v < kMicro; ++v)
            acc[u][v] += smem[((g - 1) * kMicro * kMicro + u * kMicro + v) * gt + t];
    }
  }
  if (grp != 0 || !active) return;
#pragma unroll
  for (int u = 0; u < kMicro; ++u) {
    const int i = ti * kTile + kMicro * a + u;
#pragma unroll
    for (int v = 0; v < kMicro; ++v) {
      const int j = tj * kTile + kMicro * b + v;
      if (i < d && j < d) part[(size_t)i * d + j] = acc[u][v];
    }
  }
}

// out[i][j] = out[j][i] = the sum over chunks of partial entry (i, j), i <= j
// (the upper-triangle tiles hold every such entry).  A block takes 32
// consecutive entries; warp w sums chunks w, w + 8, ... and the warps'
// sums add in warp order.  blockIdx.y is the trial.
__global__ void __launch_bounds__(256)
gram_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int d,
                   int splits) {
  const size_t dd = (size_t)d * d;
  part += blockIdx.y * splits * dd;
  out += blockIdx.y * dd;
  __shared__ float red[8][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int idx = blockIdx.x * 32 + lane;
  const int i = idx / d, j = idx % d;
  const bool ok = idx < d * d && i <= j;
  float s = 0.f;
  if (ok) {
#pragma unroll 8
    for (int q = warp; q < splits; q += 8) s += __ldcg(part + q * dd + idx);
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && ok) {
    float tot = red[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) tot += red[w][lane];
    out[(size_t)i * d + j] = tot;
    out[(size_t)j * d + i] = tot;
  }
}

// part: (trial, d, nbp) with nbp = nb rounded up to 4; arrivals: one int
// per trial, zero on entry and on exit.
template <bool ALIGNED>
__global__ void __launch_bounds__(kRowThreads, 2)
row_gram_kernel(const float* __restrict__ r, const float* __restrict__ v,
                float* __restrict__ part, int* __restrict__ arrivals, float* __restrict__ out,
                int d, int n, int strip, int v_stride) {
  const int trial = blockIdx.y, nb = gridDim.x, nbp = (nb + 3) & ~3;
  r += (size_t)trial * d * n;
  v += (size_t)trial * v_stride;   // 0: one v shared by every trial
  part += (size_t)trial * d * nbp;
  out += (size_t)trial * d;
  const int col = blockIdx.x * strip + 4 * (threadIdx.x & 31);   // this lane's first column
  const int slices = strip / 128;

  float4 vr[kRowSlices];
  repro::load_strip<ALIGNED>(v, col, slices, n, vr);
  repro::stream_rows<ALIGNED>(r, vr, col, slices, d, n, part, nbp);

  // the last block of this trial to arrive sums the strips in block order
  if (!repro::last_to_arrive(arrivals + trial, nb)) return;
  repro::fold_rows(part, nbp, nb, d, out);
  if (threadIdx.x == 0) arrivals[trial] = 0;   // ready for the next call
}

// Let gram_partial_kernel<ALIGNED, KG> take a block's largest dynamic shared
// memory (set once: a per-call attribute call costs host time).
template <bool ALIGNED, int KG>
cudaError_t allow_shared_memory() {
  static const cudaError_t done = cudaFuncSetAttribute(
      gram_partial_kernel<ALIGNED, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGramMaxShared);
  return done;
}

template <bool ALIGNED, int KG>
int launch_gram(const float* r, float* part, float* out, int d, int n, int chunk, int splits,
                int threads, int smem, int batch, cudaStream_t st) {
  const int tiles = (d + kTile - 1) / kTile;
  if (threads > kGramMaxThreads || threads % (32 * KG) || smem > kGramMaxShared)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_shared_memory<ALIGNED, KG>();
  if (err != cudaSuccess) return err;
  gram_partial_kernel<ALIGNED, KG><<<dim3(tiles * (tiles + 1) / 2, splits, batch), threads,
                                     smem, st>>>(r, part, d, n, chunk, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_reduce_kernel<<<dim3((d * d + 31) / 32, batch), 256, 0, st>>>(part, out, d, splits);
  return cudaGetLastError();
}

template <bool ALIGNED>
int gram_by_groups(int kg, const float* r, float* part, float* out, int d, int n, int chunk,
                   int splits, int threads, int smem, int batch, cudaStream_t st) {
  switch (kg) {
    case 1: return launch_gram<ALIGNED, 1>(r, part, out, d, n, chunk, splits, threads, smem, batch, st);
    case 2: return launch_gram<ALIGNED, 2>(r, part, out, d, n, chunk, splits, threads, smem, batch, st);
    case 3: return launch_gram<ALIGNED, 3>(r, part, out, d, n, chunk, splits, threads, smem, batch, st);
    case 4: return launch_gram<ALIGNED, 4>(r, part, out, d, n, chunk, splits, threads, smem, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool ALIGNED>
int launch_row_gram(const float* r, const float* v, float* part, int* arrivals, float* out,
                    int d, int n, int strip, int v_stride, int batch, cudaStream_t st) {
  if (strip % 128 || strip > 128 * kRowSlices || strip < 128) return cudaErrorInvalidValue;
  const int nb = (n + strip - 1) / strip;
  row_gram_kernel<ALIGNED><<<dim3(nb, batch), kRowThreads, 0, st>>>(r, v, part, arrivals, out,
                                                                   d, n, strip, v_stride);
  return cudaGetLastError();
}

}  // namespace

// r (batch, d, n) fp32 (batch 1: one trial); part (batch, splits, d, d)
// scratch; out (batch, d, d).  The wrapper picks the block (threads, kg
// thread groups, smem bytes) and the N-chunk (a multiple of 32 kg
// instances, splits = ceil(n / chunk)) from (d, n) and the card, never
// from the batch; aligned != 0 only if n % 4 == 0 and r is 16-byte aligned.
extern "C" int repro_gram_batched(const float* r, float* part, float* out, int d, int n,
                                  int chunk, int splits, int threads, int kg, int smem,
                                  int aligned, int batch, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return aligned ? gram_by_groups<true>(kg, r, part, out, d, n, chunk, splits, threads, smem, batch, st)
                 : gram_by_groups<false>(kg, r, part, out, d, n, chunk, splits, threads, smem, batch, st);
}

extern "C" int repro_gram(const float* r, float* part, float* out, int d, int n, int chunk,
                          int splits, int threads, int kg, int smem, int aligned,
                          void* stream) {
  return repro_gram_batched(r, part, out, d, n, chunk, splits, threads, kg, smem, aligned, 1,
                            stream);
}

// r (batch, d, n); v (batch, n) with v_stride = n, or (n,) shared by every
// trial with v_stride = 0; part (batch, d, ceil(n / strip) rounded up to
// 4) scratch; arrivals (>= batch ints, zero); out (batch, d).  strip: a
// multiple of 128 columns, at most 1024; aligned != 0 only if n % 4 == 0
// and r and v are 16-byte aligned.
extern "C" int repro_row_gram_batched(const float* r, const float* v, float* part,
                                      int* arrivals, float* out, int d, int n, int strip,
                                      int v_stride, int aligned, int batch, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  return aligned ? launch_row_gram<true>(r, v, part, arrivals, out, d, n, strip, v_stride, batch, st)
                 : launch_row_gram<false>(r, v, part, arrivals, out, d, n, strip, v_stride, batch, st);
}

extern "C" int repro_row_gram(const float* r, const float* v, float* part, int* arrivals,
                              float* out, int d, int n, int strip, int aligned, void* stream) {
  return repro_row_gram_batched(r, v, part, arrivals, out, d, n, strip, 0, aligned, 1, stream);
}

template <int KG>
int gram_occupancy(int threads, int smem) {
  int blocks = 0;
  cudaError_t err = allow_shared_memory<true, KG>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gram_partial_kernel<true, KG>,
                                                        threads, smem);
  return err == cudaSuccess ? blocks : 0;
}

// Blocks of each kernel an SM holds at once (kind 0: gram's partial kernel
// with kg thread groups in `threads` threads and `smem` bytes; kind 1:
// row_gram), for the wrapper's geometry; 0 on error.
extern "C" int repro_gram_blocks_per_sm(int kind, int kg, int threads, int smem) {
  if (kind == 0) {
    switch (kg) {
      case 1: return gram_occupancy<1>(threads, smem);
      case 2: return gram_occupancy<2>(threads, smem);
      case 3: return gram_occupancy<3>(threads, smem);
      case 4: return gram_occupancy<4>(threads, smem);
      default: return 0;
    }
  }
  int blocks = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, row_gram_kernel<true>, kRowThreads, 0);
  return err == cudaSuccess ? blocks : 0;
}
