// Grouped-query flash attention of the LM prefill: two kernels, one contract.
//
// Both replace src/repro/kernels/flash_attention/kernel.py
// flash_attention_pallas (B9, body _flash_kernel):
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(dh)) v[b, j, h / G]
//   over the positions j the mask admits (causal: j <= i; sliding window:
//   j > i - window; always j < Skv), with q (B, Sq, Hq, dh),
//   k and v (B, Skv, Hkv, dh), G = Hq / Hkv, bf16 or fp32 in, q's dtype out,
//   fp32 scores, softmax and sums.  The TPU kernel walked the KV blocks as a
//   sequential grid axis with the online-softmax state (m, l, acc) in VMEM
//   scratch.  Here a block owns a (batch, query head, query tile) and loops
//   over 64-key tiles itself.  Key tiles wholly above the causal diagonal or
//   before the window are skipped (the TPU grid could not skip them), and the
//   ragged edges of Sq and Skv are masked in the kernel, so no caller pads.
//   A masked score is the kernel's finite -1e30 and its probability is set
//   to 0, so a tile that a row sees wholly masked adds nothing and gives no
//   NaN in exp(m_prev - m_cur).  The wrapper (kernels/flash_attention/ops.py)
//   picks the kernel from an explicit (dtype, dh) table.
//
// repro_flash_attention_tc, bf16 at dh 64 and 128 (the serving path).
//   Bound on an H100: the two matrix products, 4 dh Sq(Sq+1)/2 FLOPs per
//   (b, h) over the causal half, against 989 TFLOP/s of bf16 tensor cores;
//   the bytes (q, k, v read once) are far below.  Beside the products, one
//   exp per score runs on a unit of 16 lanes per SM (~1/250 of the tensor
//   rate), so the softmax, not the MMAs, is the first wall.  The design:
//   - Both products are warpgroup MMAs (wgmma, inline PTX).  A block is two
//     warpgroups of 64 query rows (a 128-row tile), two blocks per SM at
//     dh 64.  S = Q K^T is m64n64k16 with Q (resident for the block) and K
//     read from shared memory in the 128-byte-swizzled K-major layout (a
//     bf16 row of 64 is one 128-byte line; dh 128 is two column blocks).
//     O += P V takes P from registers as the A operand and V from shared
//     memory MN-major (the descriptor's transpose bit): no transpose
//     anywhere.
//   - The online softmax runs on the fp32 accumulator fragment in
//     registers: row max and sum by fixed trees in the thread and a fixed
//     xor butterfly over the 4 lanes of a row, exp2 with the 1/sqrt(dh)
//     scale folded into one FMA.  Only tiles that cross the diagonal, the
//     window's edge or the ragged Skv edge pay for the mask; O is rescaled
//     only when a row's max moved.
//   - Within a warpgroup, S of tile t+1 is issued before O += P_t V_t and
//     its softmax runs while P_t V_t is on the tensor cores.
//   - P is rounded to bf16 with integer ops (to nearest, ties away from
//     zero), since the card's fp32 -> bf16 conversion shares the exp unit.
//   - K and V tiles arrive by cp.async 16-byte copies into a 4-stage ring
//     (tiles t and t+1 resident, two more in flight); each thread's copy
//     offsets are computed once.
//   - Query tiles are launched longest causal rows first, so that the last
//     wave is not all short rows; a warpgroup skips a key tile none of its
//     rows can see.
//   Rounding: P is rounded to bf16 before P V, which the TPU kernel and the
//   plain version do not do (the usual flash-attention trade); l is summed
//   from the fp32 p before rounding, and O accumulates in fp32.
//
// repro_flash_attention, fp32 at dh 64/80/128 and bf16 at dh 80 (the smoke
//   config's heads, whose 80 columns do not fill the 128-byte swizzle).
//   The first, simple kernel, kept for its fp32 exactness (TF32 tensor
//   cores would break the 1e-5 parity): fp32 FMA on the CUDA cores from
//   shared memory, one block per (batch, head, 64-query tile), 4x4 scores
//   and 4 x dh/16 outputs per thread (the S and O rows of a thread coincide,
//   so the per-row rescale needs no exchange).  It is bound by the
//   shared-memory pipe (2 FMAs per shared load), far below either peak.
//
// The backward (dQ, dK, dV, for training) follows the forward kernels, on
// the same two routes: see "The backward" and "The tensor-core backward"
// below.
//
// Every sum over lanes uses a fixed xor butterfly and the MMAs a fixed
// order: the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// ---------------------------------------------------------------------------
// The fp32-FMA kernel.

namespace {

constexpr int kBq = 64;          // query rows per block
constexpr int kBk = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads: 4 rows x 4 keys each
constexpr int kPs = kBk + 1;     // padded row of the P tile
constexpr float kNeg = -1e30f;   // the TPU kernel's finite mask value

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int DH>
constexpr int smem_bytes() {
  return (3 * kBq * (DH + 1) + kBq * kPs) * (int)sizeof(float);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int sq, int skv, int hq, int hkv,
                       int causal, int window, float scale) {
  constexpr int DP = DH + 1;     // padded rows: conflict-free column reads
  constexpr int NC = DH / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [kBq][DP], pre-scaled
  float* sK = sQ + kBq * DP;     // [kBk][DP]
  float* sV = sK + kBk * DP;     // [kBk][DP]
  float* sP = sV + kBk * DP;     // [kBq][kPs]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBq;
  const int hk = h / (hq / hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  for (int e = threadIdx.x; e < kBq * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, s = q0 + r;
    float x = 0.f;
    if (s < sq) x = repro::to_f32(q[(((size_t)b * sq + s) * hq + h) * DH + d]) * scale;
    sQ[r * DP + d] = x;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  // key positions this query tile can see
  const int q_lo = q0;
  const int q_hi = min(q0 + kBq, sq) - 1;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  for (int kv0 = (kv_begin / kBk) * kBk; kv0 < kv_end; kv0 += kBk) {
    __syncthreads();             // the previous tile's K, V and P are consumed
    for (int e = threadIdx.x; e < kBk * DH; e += kThreads) {
      const int r = e / DH, d = e % DH, s = kv0 + r;
      float xk = 0.f, xv = 0.f;
      if (s < skv) {
        const size_t off = (((size_t)b * skv + s) * hkv + hk) * DH + d;
        xk = repro::to_f32(k[off]);
        xv = repro::to_f32(v[off]);
      }
      sK[r * DP + d] = xk;
      sV[r * DP + d] = xv;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], c[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qp = q_lo + row;
      bool ok[4];
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = kv0 + tx + 16 * j;
        ok[j] = kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
        if (!ok[j]) sc[i][j] = kNeg;
        tmax = fmaxf(tmax, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(tmax));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        psum += p;
        sP[row * kPs + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha + psum;      // this thread's share of the row sum
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = sV[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * kPs + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(sum16(l[i]), 1e-30f);
    const int s = q0 + ty + 16 * i;
    if (s < sq) {
      T* dst = o + (((size_t)b * sq + s) * hq + h) * DH;
#pragma unroll
      for (int j = 0; j < NC; ++j) dst[tx + 16 * j] = repro::from_f32<T>(acc[i][j] / denom);
      if (lse != nullptr && tx == 0) lse[((size_t)b * hq + h) * sq + s] = m[i] + logf(denom);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
           int sq, int skv, int hq, int hkv, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr int bytes = smem_bytes<DH>();
  auto* kern = flash_attention_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + kBq - 1) / kBq, hq, b);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, hq, hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, void* o, float* lse,
             int b, int sq, int skv, int hq, int hkv, int causal, int window,
             float scale, cudaStream_t st) {
  switch (dh) {
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The bf16 tensor-core kernel.

namespace tc {

constexpr int kBq = 128;             // query rows per block: two warpgroups of 64
constexpr int kBk = 64;              // keys per tile
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;       // the TPU kernel's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct Cfg {
  static constexpr int kStages = 4;    // K/V ring: tiles t, t+1 resident, t+2.. landing
  static constexpr int kQBytes = kBq * DH * 2;
  static constexpr int kTileBytes = kBk * DH * 2;      // one K or V tile
  static constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes + 1024;  // + alignment
};

// Byte offset of 16-byte chunk j (8 bf16 columns) of row r in a tile of
// `rows` rows, 128-byte swizzled: column block j / 8 holds rows of 128 bytes,
// chunk j % 8 of row r stored at position (j % 8) ^ (r % 8).  Tiles start on
// 1024-byte boundaries, so this is the layout wgmma's 128B swizzle reads.
__device__ __forceinline__ uint32_t swz(int r, int j, int rows) {
  return (uint32_t)((j >> 3) * rows * 128 + r * 128 + (((j & 7) ^ (r & 7)) << 4));
}

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

// Rows [row0, row0 + rows) of a bf16 matrix with row stride ld (elements)
// into the swizzled tile at dst; rows >= limit are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, size_t ld,
                                          int row0, int rows, int limit) {
  constexpr int C = DH / 8;
  for (int e = threadIdx.x; e < rows * C; e += kThreads) {
    const int r = e / C, j = e % C, s = row0 + r;
    const bool ok = s < limit;
    cp_async16(dst + swz(r, j, rows), ok ? src + (size_t)s * ld + j * 8 : src, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving register accesses across the async MMAs
// (and from reusing the registers of an A fragment an MMA still reads).
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}
// Max and sum of 16 values as a fixed tree (short dependency chains).
__device__ __forceinline__ float tree_max16(float (&x)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = fmaxf(x[j], x[j + 8]);
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = fmaxf(x[j], x[j + 4]);
#pragma unroll
  for (int j = 0; j < 2; ++j) x[j] = fmaxf(x[j], x[j + 2]);
  return fmaxf(x[0], x[1]);
}
__device__ __forceinline__ float tree_sum16(float (&x)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] += x[j + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] += x[j + 4];
#pragma unroll
  for (int j = 0; j < 2; ++j) x[j] += x[j + 2];
  return x[0] + x[1];
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 64, fp32) {=, +=} A (64 x 16, smem) B^T (64 x 16, smem), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 registers) B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(o, a, b);
}

// Two p in [0, 1] to a bf16 pair (lo in the low half), rounded to nearest
// (ties away from zero) with integer ops: the card's fp32 -> bf16 conversion
// shares its 16-per-clock unit with ex2, the integer pipe does not.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo) + 0x8000u, __float_as_uint(hi) + 0x8000u, 0x7632);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 64 ? 2 : 1)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int sq, int skv, int hq, int hkv,
                          int causal, int window, float scale_log2) {
  using C = Cfg<DH>;
  constexpr int NO = DH / 2;         // O accumulator floats per thread
  constexpr int KS = DH / 16;        // k-steps of Q K^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                          // [DH / 64][kBq][128 B]
  const uint32_t sKV = base + C::kQBytes;            // stage s: K, then V

  const int h = blockIdx.x % hq, b = blockIdx.x / hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;   // longest causal rows first
  const int hk = h / (hq / hkv);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;

  const size_t ldq = (size_t)hq * DH, ldk = (size_t)hkv * DH;
  const __nv_bfloat16* qb = q + (size_t)b * sq * ldq + (size_t)h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * skv * ldk + (size_t)hk * DH;
  const __nv_bfloat16* vb = v + (size_t)b * skv * ldk + (size_t)hk * DH;

  // key tiles of the block, and the keys this warpgroup's rows can see
  const int q_last = min(q0 + kBq, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kBk;
  const int n_tiles = kv_end > t_first * kBk ? (kv_end - t_first * kBk + kBk - 1) / kBk : 0;
  const int w_lo = q0 + wg * 64;                 // first row of this warpgroup
  const int w_hi = min(w_lo + 63, sq - 1);       // last (< w_lo: no rows)
  const int wk_begin = window > 0 ? max(0, w_lo - window + 1) : 0;
  const int wk_end = causal ? min(skv, w_hi + 1) : skv;

  auto key0 = [&](int t) { return (t_first + t) * kBk; };
  auto stage = [&](int t) { return sKV + (t % C::kStages) * 2 * C::kTileBytes; };
  // This thread's 16-byte chunks of a K or V tile: one chunk column j0 of
  // rows row0 + i RP.  RP is a multiple of 8 and the swizzle repeats every 8
  // rows, so the shared offsets are soff0 + i RP 128.
  constexpr int CPR = DH / 8, RP = kThreads / CPR, NCH = kBk / RP;
  const int row0 = threadIdx.x / CPR, j0 = threadIdx.x % CPR;
  const uint32_t soff0 = swz(row0, j0, kBk);
  const int goff0 = row0 * (int)ldk + j0 * 8;
  auto load_kv = [&](int t) {        // K and V of tile t into its ring slot
    const int kv0 = key0(t);
    const __nv_bfloat16* kt = kb + (size_t)kv0 * ldk;
    const __nv_bfloat16* vt = vb + (size_t)kv0 * ldk;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const bool ok = kv0 + row0 + i * RP < skv;
      const int off = goff0 + i * RP * (int)ldk;
      const uint32_t dst = stage(t) + soff0 + i * RP * 128;
      cp_async16(dst, ok ? kt + off : kb, ok);
      cp_async16(dst + C::kTileBytes, ok ? vt + off : vb, ok);
    }
  };

  load_tile<DH>(sQ, qb, ldq, q0, kBq, sq);
#pragma unroll
  for (int t = 0; t < C::kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();               // group t (group 0 also holds Q)
  }

  float acc[NO], sc[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  uint32_t pa[4][4];                 // P of the tile whose P V is next, bf16 pairs
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];
  const int r0 = w_lo + warp * 16 + (lane >> 2);   // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);                    // and columns c0, c0 + 1 of each 8
  auto visible = [&](int t) {        // does any row of this warpgroup see tile t?
    const int kv0 = key0(t);
    return w_lo <= w_hi && kv0 + kBk > wk_begin && kv0 < wk_end;
  };
  // S = Q K^T, both K-major: a k-step of 16 columns is 32 bytes into the line
  auto issue_s = [&](int t) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(sc, desc(sQ + (kk >> 2) * kBq * 128 + wg * 64 * 128 + off, 16, 1024),
                   desc(stage(t) + (kk >> 2) * kBk * 128 + off, 16, 1024), kk > 0);
    }
  };
  // Online softmax of tile t on the fragment: sc[4j + e] is row r0 + 8 (e >> 1),
  // key key0(t) + 8 j + c0 + (e & 1).  m is kept in the log2 domain; sc
  // becomes p (fp32), l takes the fp32 p, alpha the rescale of O.  Only a
  // tile that crosses a mask edge pays for the mask.
  auto softmax = [&](int t) {
    const int kv0 = key0(t);
    const bool edge = kv0 + kBk > skv || (causal && kv0 + kBk - 1 > w_lo) ||
                      (window > 0 && kv0 <= w_hi - window);
    uint32_t okbits = 0xffffffffu;
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int kp = kv0 + 8 * (i >> 2) + c0 + (i & 1);
        const int qp = r0 + 8 * ((i >> 1) & 1);
        if (!(kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window))) {
          sc[i] = kNeg;
          okbits &= ~(1u << i);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // row r0 + 8 r: sc[4 j + 2 r + {0, 1}]
      float x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = sc[4 * (j >> 1) + 2 * r + (j & 1)];
      float mx = tree_max16(x);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        sc[i] = (okbits >> i) & 1u ? ex2(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1])) : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = ex2(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // l from the fp32 p, before rounding
      float x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) x[j] = sc[4 * (j >> 1) + 2 * r + (j & 1)];
      l[r] = l[r] * alpha[r] + tree_sum16(x);
    }
  };
  // O *= alpha, then P (bf16) into the A fragment: k-step kk is keys
  // 16 kk.., fragment registers 8 kk..8 kk + 7
  auto rescale_pack = [&]() {
    if (alpha[0] != 1.f || alpha[1] != 1.f) {   // no row max moved: nothing to do
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
  };

  // Per visible tile t: S of tile t+1 is issued before O += P_t V_t, and its
  // softmax runs while P_t V_t is on the tensor cores.
  bool have_p = false;               // pa holds P of tile t, O is rescaled for it
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<C::kStages - 3>();   // tiles t and t+1 have landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // visible to wgmma
    __syncthreads();                 // everyone's copies; tile t-1's slot consumed by all
    if (t + C::kStages - 1 < n_tiles) load_kv(t + C::kStages - 1);
    cp_async_commit();
    if (!visible(t)) continue;
    if (!have_p) {                   // the first visible tile: S_t alone
      hold(sc);
      wg_fence();
      issue_s(t);
      wg_commit();
      wg_wait<0>();
      hold(sc);
      softmax(t);
      rescale_pack();
    }
    const bool next = t + 1 < n_tiles && visible(t + 1);
    hold(sc);
    hold(acc);
    hold(pa);
    wg_fence();
    if (next) {
      issue_s(t + 1);
      wg_commit();
    }
    // O += P V, V MN-major: 16 keys are 2 KB down the tile; the next 64
    // columns (dh 128) are the next column block, kBk * 128 bytes on
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<DH>(acc, pa[kk], desc(stage(t) + C::kTileBytes + kk * 16 * 128, kBk * 128, 1024));
    wg_commit();
    if (next) {
      wg_wait<1>();                  // S_{t+1} done; P_t V_t may still run
      hold(sc);
      softmax(t + 1);
    }
    wg_wait<0>();
    hold(acc);
    hold(pa);
    if (next) rescale_pack();
    have_p = next;
  }

  // l over the 4 lanes of a row, then O / l for the rows inside Sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    const float inv = 1.f / fmaxf(t, 1e-30f);
    const int row = r0 + 8 * r;
    if (row < sq && w_lo <= w_hi) {
      __nv_bfloat16* dst = o + ((size_t)b * sq + row) * ldq + (size_t)h * DH + c0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
      // the row's natural log-sum-exp of the scaled scores: m is in the
      // log2 domain, l sums the unrounded p
      if (lse != nullptr && (lane & 3) == 0)
        lse[((size_t)b * hq + h) * sq + row] = (m[r] + log2f(fmaxf(t, 1e-30f))) * kLn2;
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
           int skv, int hq, int hkv, int causal, int window, float scale, cudaStream_t st) {
  constexpr int bytes = Cfg<DH>::kSmem;
  auto* kern = flash_attention_tc_kernel<DH>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(b * hq, (sq + kBq - 1) / kBq);
  kern<<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, skv, hq,
      hkv, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The backward: dQ, dK, dV of the same attention.
//
// Nothing of the TPU package is its twin: repro/kernels/flash_attention has
// no backward, and the JAX package's training differentiates XLA's plain
// attention.  The port's training runs B9 on the card, so its gradient is a
// kernel too (kernels/flash_attention/ops.py flash_attention_train, a
// torch.autograd.Function).  With the forward's row log-sum-exp L_i saved:
//   P_ij  = exp(scale q_i . k_j - L_i)            (0 where masked)
//   D_i   = dO_i . O_i                             (the pre-pass below)
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dV_j  = sum_i P_ij dO_i,  dK_j = scale sum_i dS_ij q_i,
//   dQ_i  = scale sum_j dS_ij k_j,
// sums over the query heads of k_j's group too.  P is recomputed in fp32
// from L.  Two routes, one table (kernels/flash_attention/ops.py
// BWD_ROUTES): the tensor-core backward (namespace tc below, bf16 at dh 64
// and 128, every config that trains) and this one, fp32 at every head dim
// and bf16 at dh 80.  Each is three launches, in this order:
//   delta_kernel  D (b, hq, sq) fp32, one warp a row, a fixed butterfly;
//   dkdv_kernel   a block per (batch, KV head, 64-key tile) that loops over
//                 the group's G query heads and then its visible query tiles
//                 in order: dK and dV stay in registers and are summed in a
//                 fixed order inside the block, with no atomics;
//   dq_kernel     a block per (batch, query head, 64-query tile) over its
//                 visible key tiles, in order.
// Bound on an H100: the five products of 2 dh FLOPs per visible (i, j) and
// query head (S and dP recomputed, dV, dK, dQ), against the inputs' type's
// peak; the bytes (q, k, v, o, dO, L read once; dQ, dK, dV written once)
// are far below.  These kernels are the forward FMA kernel's shape, fp32
// FMA on the CUDA cores from shared memory: bound by the shared-memory pipe,
// far below either peak (3.2485 ms in fp32 at smollm's training shape, B=8,
// S=1024, 15/5 heads of 64, against a bound of 0.6016; chip_smoke phase 12
// on an H100 80GB HBM3 at 700 W).  They keep fp32's 1e-4 parity, which TF32
// tensor cores would break.  dkdv_kernel and dq_kernel each recompute S and
// dP; fp32 accumulation, the gradients written in the inputs' dtype.
namespace bwd {

constexpr int kB = 64;           // queries or keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads: 4 x 4 scores each
constexpr int kPs = kB + 1;      // padded row of the P and dS tiles

template <int DH>
constexpr int smem_bytes() {
  return (4 * kB * (DH + 1) + 2 * kB * kPs + 2 * kB) * (int)sizeof(float);
}

__device__ __forceinline__ bool visible(int i, int j, int sq, int skv, int causal, int window) {
  return i < sq && j < skv && (!causal || j <= i) && (window <= 0 || j > i - window);
}

// rows [row0, row0 + kB) of (b, S, H, DH) tensor x at head h into tile dst
// [kB][DH + 1] as fp32; rows >= limit are zero
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ x, int b, int row0,
                                          int limit, int heads, int h) {
  constexpr int DP = DH + 1;
  for (int e = threadIdx.x; e < kB * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, s = row0 + r;
    dst[r * DP + d] =
        s < limit ? repro::to_f32(x[(((size_t)b * limit + s) * heads + h) * DH + d]) : 0.f;
  }
}

// D = rowsum(dO o O) in fp32: one warp a (b, i, h) row of (b, sq, hq, DH)
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int rows, int sq, int hq, int dh) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                      // the whole warp leaves together
  const T* po = o + (size_t)row * dh;
  const T* pd = dout + (size_t)row * dh;
  float acc = 0.f;
  for (int d = lane; d < dh; d += 32) acc = fmaf(repro::to_f32(pd[d]), repro::to_f32(po[d]), acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) {
    const int h = row % hq, i = (row / hq) % sq, b = row / (hq * sq);
    delta[((size_t)b * hq + h) * sq + i] = acc;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int sq,
            int skv, int hq, int hkv, int causal, int window, float scale) {
  constexpr int DP = DH + 1;
  constexpr int NC = DH / 16;    // gradient columns per thread
  extern __shared__ float smem[];
  float* sK = smem;              // [kB][DP]
  float* sV = sK + kB * DP;
  float* sQ = sV + kB * DP;
  float* sO = sQ + kB * DP;      // dO
  float* sP = sO + kB * DP;      // P^T  [key][query]
  float* sS = sP + kB * kPs;     // dS^T [key][query]
  float* sL = sS + kB * kPs;     // L of the query tile
  float* sD = sL + kB;           // D of the query tile

  const int b = blockIdx.z, hk = blockIdx.y, kv0 = blockIdx.x * kB;
  const int g = hq / hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<T, DH>(sK, k, b, kv0, skv, hkv, hk);
  load_rows<T, DH>(sV, v, b, kv0, skv, hkv, hk);

  float gk[4][NC], gv[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) gk[a][n] = gv[a][n] = 0.f;

  // the queries that can see a key of this tile
  const int kv_last = min(kv0 + kB, skv) - 1;
  const int q_begin = causal ? kv0 : 0;
  const int q_end = window > 0 ? min(sq, kv_last + window) : sq;
  for (int gi = 0; gi < g; ++gi) {
    const int h = hk * g + gi;
    for (int q0 = (q_begin / kB) * kB; q0 < q_end; q0 += kB) {
      __syncthreads();           // the previous tile's Q, dO, P, dS are consumed
      load_rows<T, DH>(sQ, q, b, q0, sq, hq, h);
      load_rows<T, DH>(sO, dout, b, q0, sq, hq, h);
      if (threadIdx.x < kB) {
        const int i = q0 + threadIdx.x;
        sL[threadIdx.x] = i < sq ? lse[((size_t)b * hq + h) * sq + i] : 0.f;
        sD[threadIdx.x] = i < sq ? delta[((size_t)b * hq + h) * sq + i] : 0.f;
      }
      __syncthreads();

      // keys ty + 16 a against queries tx + 16 c: S and dP
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float kk[4], vv[4], qq[4], oo[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kk[a] = sK[(ty + 16 * a) * DP + d];
          vv[a] = sV[(ty + 16 * a) * DP + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qq[c] = sQ[(tx + 16 * c) * DP + d];
          oo[c] = sO[(tx + 16 * c) * DP + d];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            sc[a][c] = fmaf(kk[a], qq[c], sc[a][c]);
            dp[a][c] = fmaf(vv[a], oo[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int jl = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int il = tx + 16 * c;
          const bool ok = visible(q0 + il, kv0 + jl, sq, skv, causal, window);
          const float p = ok ? expf(fmaf(sc[a][c], scale, -sL[il])) : 0.f;
          sP[jl * kPs + il] = p;
          sS[jl * kPs + il] = p * (dp[a][c] - sD[il]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q: keys ty + 16 a, columns tx + 16 n
#pragma unroll 4
      for (int i = 0; i < kB; ++i) {
        float pp[4], ss[4], oo[NC], qq[NC];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pp[a] = sP[(ty + 16 * a) * kPs + i];
          ss[a] = sS[(ty + 16 * a) * kPs + i];
        }
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          oo[n] = sO[i * DP + tx + 16 * n];
          qq[n] = sQ[i * DP + tx + 16 * n];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            gv[a][n] = fmaf(pp[a], oo[n], gv[a][n]);
            gk[a][n] = fmaf(ss[a], qq[n], gk[a][n]);
          }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = kv0 + ty + 16 * a;
    if (j < skv) {
      const size_t off = (((size_t)b * skv + j) * hkv + hk) * DH;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        dk[off + tx + 16 * n] = repro::from_f32<T>(gk[a][n] * scale);
        dv[off + tx + 16 * n] = repro::from_f32<T>(gv[a][n]);
      }
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int sq, int skv, int hq,
          int hkv, int causal, int window, float scale) {
  constexpr int DP = DH + 1;
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* sQ = smem;              // [kB][DP]
  float* sO = sQ + kB * DP;      // dO
  float* sK = sO + kB * DP;
  float* sV = sK + kB * DP;
  float* sS = sV + kB * DP;      // dS [query][key]
  float* sL = sS + 2 * kB * kPs; // (the layout of dkdv_kernel's smem_bytes)
  float* sD = sL + kB;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kB;
  const int hk = h / (hq / hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_rows<T, DH>(sQ, q, b, q0, sq, hq, h);
  load_rows<T, DH>(sO, dout, b, q0, sq, hq, h);
  if (threadIdx.x < kB) {
    const int i = q0 + threadIdx.x;
    sL[threadIdx.x] = i < sq ? lse[((size_t)b * hq + h) * sq + i] : 0.f;
    sD[threadIdx.x] = i < sq ? delta[((size_t)b * hq + h) * sq + i] : 0.f;
  }

  float gq[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int n = 0; n < NC; ++n) gq[a][n] = 0.f;

  // the keys this query tile can see (the forward kernel's range)
  const int q_hi = min(q0 + kB, sq) - 1;
  const int kv_end = causal ? min(skv, q_hi + 1) : skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int kv0 = (kv_begin / kB) * kB; kv0 < kv_end; kv0 += kB) {
    __syncthreads();             // the previous tile's K, V and dS are consumed
    load_rows<T, DH>(sK, k, b, kv0, skv, hkv, hk);
    load_rows<T, DH>(sV, v, b, kv0, skv, hkv, hk);
    __syncthreads();

    // queries ty + 16 a against keys tx + 16 c
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qq[4], oo[4], kk[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qq[a] = sQ[(ty + 16 * a) * DP + d];
        oo[a] = sO[(ty + 16 * a) * DP + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kk[c] = sK[(tx + 16 * c) * DP + d];
        vv[c] = sV[(tx + 16 * c) * DP + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[a][c] = fmaf(qq[a], kk[c], sc[a][c]);
          dp[a][c] = fmaf(oo[a], vv[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = tx + 16 * c;
        const bool ok = visible(q0 + il, kv0 + jl, sq, skv, causal, window);
        const float p = ok ? expf(fmaf(sc[a][c], scale, -sL[il])) : 0.f;
        sS[il * kPs + jl] = p * (dp[a][c] - sD[il]);
      }
    }
    __syncthreads();

    // dQ += dS K: queries ty + 16 a, columns tx + 16 n
#pragma unroll 4
    for (int j = 0; j < kB; ++j) {
      float ss[4], kk[NC];
#pragma unroll
      for (int a = 0; a < 4; ++a) ss[a] = sS[(ty + 16 * a) * kPs + j];
#pragma unroll
      for (int n = 0; n < NC; ++n) kk[n] = sK[j * DP + tx + 16 * n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int n = 0; n < NC; ++n) gq[a][n] = fmaf(ss[a], kk[n], gq[a][n]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < sq) {
      const size_t off = (((size_t)b * sq + i) * hq + h) * DH;
#pragma unroll
      for (int n = 0; n < NC; ++n) dq[off + tx + 16 * n] = repro::from_f32<T>(gq[a][n] * scale);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq,
           int skv, int hq, int hkv, int causal, int window, float scale, cudaStream_t st) {
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(dout);
  const int rows = b * sq * hq;
  delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, st>>>(
      static_cast<const T*>(o), to, delta, rows, sq, hq, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int bytes = smem_bytes<DH>();
  auto* kv_kern = dkdv_kernel<T, DH>;
  auto* q_kern = dq_kernel<T, DH>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3((skv + kB - 1) / kB, hkv, b), kThreads, bytes, st>>>(
      tq, tk, tv, to, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, hq, hkv,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((sq + kB - 1) / kB, hq, b), kThreads, bytes, st>>>(
      tq, tk, tv, to, lse, delta, static_cast<T*>(dq), sq, skv, hq, hkv, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, const void* o,
             const void* dout, const float* lse, float* delta, void* dq, void* dk, void* dv,
             int b, int sq, int skv, int hq, int hkv, int causal, int window, float scale,
             cudaStream_t st) {
  switch (dh) {
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, hq,
                                  hkv, causal, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, hq,
                                  hkv, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, hq,
                                    hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// The tensor-core backward: bf16 at dh 64 and 128, the same function on
// wgmma, redesigned for the H100 from the FMA kernels above.
// Bound: the five products against 989 TFLOP/s of bf16 tensor cores (0.0408
//   ms at smollm's training shape; the bytes are far below).  Besides the
//   products, one exp per score (both kernels recompute P) on the 16-lane
//   unit, and the elementwise P / dS work on the fragments.
// Design: each product is one of the forward's two shapes, built from its
//   pieces (swizzled tiles, descriptors, the cp.async ring, wgmma_ss_n64
//   and wgmma_pv):
//   dkdv_tc_kernel  a block per (batch, KV head, 128-key tile), two
//                   warpgroups of 64 keys.  K and V stay in shared memory;
//                   Q, dO, L and D of 64-query tiles stream through a 3-stage
//                   ring, for each of the group's G query heads, then each
//                   visible tile, in order (GQA's sum stays in the block).
//                   S^T = K Q^T and dP^T = V dO^T read both operands from
//                   shared memory (the forward's Q K^T); P^T and dS^T are
//                   formed on the fp32 fragments and packed to bf16 A
//                   fragments; dV += P^T dO and dK += dS^T Q read dO and Q
//                   through the transposed descriptor (the forward's P V).
//   dq_tc_kernel    a block per (batch, query head, 128-query tile), two
//                   blocks an SM at dh 64: Q and dO stay, K and V stream;
//                   S = Q K^T, dP = dO V^T, then dQ += dS K with K read as
//                   the forward reads V.
//   D = rowsum(dO o O) stays a pre-pass of its own: the dK/dV launch, which
//   runs before dQ's, reads every row's D, so folding D into dQ would need
//   dQ first and dK/dV after it, for a pass that reads O and dO once.  It is
//   delta_tc_kernel, bwd::delta_kernel with 16-byte loads (DH / 8 lanes a
//   row): the FMA route's warp a row of 2-byte loads is far from the
//   memory's rate.
//   Rounding: P and dS are carried as two bf16 halves each, hi = x rounded
//   to bf16 and lo = (x - hi) rounded again, with two wgmma per product:
//   rounding P alone to bf16 (what the forward does) already breaks the
//   gradient's bound (twice the plain bf16 version's own rounding) on short
//   rows, where a gradient is one or two terms
//   (tests/test_torch_train_kernels.py).  With both halves the products
//   carry ~16 bits of P and dS; all sums are fp32.
//   Causal grids launch their heaviest tiles first: key tile 0 first in
//   dK/dV, the last query tile first in dQ.  No float atomics, fixed orders:
//   the same bits on every call.
// Measured (chip_smoke phase 12, H100 80GB HBM3, 700 W): 0.3181 ms at
//   smollm's training shape (the FMA kernels 3.2573 before; SDPA's backward
//   0.2143), 1.6888 ms at dh 128 (B=4, S=2048, 32/8 heads; SDPA's 0.9287).
//   Each warpgroup runs its products and its elementwise work in turn, so
//   the tensor cores idle while P and dS are formed: the next step is to
//   overlap one tile's products with the next tile's exp.
namespace tc {

constexpr int kBwdKeys = 128;        // keys a dK/dV block: two warpgroups of 64
constexpr int kBwdQ = 64;            // queries a tile streamed through dK/dV

template <int DH>
struct BwdCfg {
  static constexpr int kStages = 3;                  // tile t resident, t+1 and t+2 landing
  static constexpr int kBig = kBwdKeys * DH * 2;     // a 128-row tile (K, V of dK/dV; Q, dO of dQ)
  static constexpr int kTile = 64 * DH * 2;          // a 64-row tile
  static constexpr int kStageKV = 2 * kTile + 1024;  // Q, dO, L and D (64 floats each), 1 KB aligned
  static constexpr int kSmemKV = 2 * kBig + kStages * kStageKV + 1024;
  static constexpr int kSmemQ = 2 * kBig + kStages * 2 * kTile + 1024;
};

// 4-byte cp.async; valid == false writes zero and reads nothing.
__device__ __forceinline__ void cp_async4z(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// x0, x1 as two bf16 pairs: hi = each rounded to bf16 (to nearest, ties away
// from zero, by integer ops), lo = the remainders x - hi rounded the same way.
__device__ __forceinline__ void pack_split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const uint32_t b0 = (__float_as_uint(x0) + 0x8000u) & 0xffff0000u;
  const uint32_t b1 = (__float_as_uint(x1) + 0x8000u) & 0xffff0000u;
  hi = __byte_perm(b0, b1, 0x7632);
  lo = pack_bf16(x0 - __uint_as_float(b0), x1 - __uint_as_float(b1));
}

// A 64 x 64 fp32 fragment as the A operands of four k-steps, hi and lo.
__device__ __forceinline__ void pack_frag(const float (&x)[32], uint32_t (&fr)[2][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pack_split(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], fr[0][kk][e], fr[1][kk][e]);
}

__device__ __forceinline__ void hold(uint32_t (&a)[2][4][4]) {
  hold(a[0]);
  hold(a[1]);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int sq, int skv,
               int hq, int hkv, int causal, int window, float scale_log2, float scale) {
  using C = BwdCfg<DH>;
  constexpr int NO = DH / 2;         // dK or dV accumulator floats per thread
  constexpr int KS = DH / 16;        // k-steps of K Q^T
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw0);
  const uint32_t sK = base, sV = base + C::kBig, ring = base + 2 * C::kBig;

  const int b = blockIdx.x / hkv, hk = blockIdx.x % hkv;
  const int kv0 = blockIdx.y * kBwdKeys;             // key tile 0 (the heaviest) first
  const int g = hq / hkv;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const size_t ldq = (size_t)hq * DH, ldk = (size_t)hkv * DH;
  const __nv_bfloat16* kb = k + (size_t)b * skv * ldk + (size_t)hk * DH;
  const __nv_bfloat16* vb = v + (size_t)b * skv * ldk + (size_t)hk * DH;

  // the queries that can see a key of the block, in 64-row tiles
  const int kv_last = min(kv0 + kBwdKeys, skv) - 1;
  const int q_begin = causal ? kv0 : 0;
  const int q_end = window > 0 ? min(sq, kv_last + window) : sq;
  const int qt0 = q_begin / kBwdQ;
  const int n_qt = q_end > qt0 * kBwdQ ? (q_end - qt0 * kBwdQ + kBwdQ - 1) / kBwdQ : 0;
  const int n_items = g * n_qt;                      // (query head, query tile) in order
  const int w_lo = kv0 + wg * 64;                    // this warpgroup's keys
  const int w_hi = min(w_lo + 63, skv - 1);

  auto item_h = [&](int t) { return hk * g + t / n_qt; };
  auto item_q0 = [&](int t) { return (qt0 + t % n_qt) * kBwdQ; };
  auto stage = [&](int t) { return ring + (t % C::kStages) * C::kStageKV; };
  // this thread's 16-byte chunks of a 64-row tile (the forward's load_kv)
  constexpr int CPR = DH / 8, RP = kThreads / CPR, NCH = 64 / RP;
  const int row0 = threadIdx.x / CPR, j0 = threadIdx.x % CPR;
  const uint32_t soff0 = swz(row0, j0, 64);
  auto load_item = [&](int t) {
    const int h = item_h(t), q0 = item_q0(t);
    const size_t head = (size_t)b * sq * ldq + (size_t)h * DH;
    const uint32_t st = stage(t);
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int row = q0 + row0 + i * RP;
      const bool ok = row < sq;
      const size_t off = head + (size_t)row * ldq + j0 * 8;
      const uint32_t dst = st + soff0 + i * RP * 128;
      cp_async16(dst, ok ? q + off : q, ok);
      cp_async16(dst + C::kTile, ok ? dout + off : dout, ok);
    }
    if (threadIdx.x < 2 * kBwdQ) {                   // L, then D, of the tile's rows
      const int e = threadIdx.x & (kBwdQ - 1), row = q0 + e;
      const bool ok = row < sq;
      const float* src = (threadIdx.x < kBwdQ ? lse : delta) + ((size_t)b * hq + h) * sq + row;
      cp_async4z(st + 2 * C::kTile + (threadIdx.x / kBwdQ) * 256 + 4 * e, ok ? src : lse, ok);
    }
  };
  auto visible = [&](int t) {        // does any key of this warpgroup see tile t?
    const int q0 = item_q0(t), q_hi = min(q0 + kBwdQ, sq) - 1;
    return w_lo <= w_hi && (!causal || q_hi >= w_lo) && (window <= 0 || q0 < w_hi + window);
  };

  load_tile<DH>(sK, kb, ldk, kv0, kBwdKeys, skv);
  load_tile<DH>(sV, vb, ldk, kv0, kBwdKeys, skv);
#pragma unroll
  for (int t = 0; t < C::kStages - 1; ++t) {
    if (t < n_items) load_item(t);
    cp_async_commit();               // group t (group 0 also holds K and V)
  }

  float dka[NO], dva[NO], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  uint32_t fr[2][4][4];
  const int r0 = w_lo + warp * 16 + (lane >> 2);     // this thread's keys: r0, r0 + 8
  const int c0 = 2 * (lane & 3);                     // and queries c0, c0 + 1 of each 8

  for (int t = 0; t < n_items; ++t) {
    cp_async_wait<C::kStages - 2>();                 // item t has landed (this thread's copies)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                                 // everyone's; item t-1's slot consumed
    if (t + C::kStages - 1 < n_items) load_item(t + C::kStages - 1);
    cp_async_commit();
    if (!visible(t)) continue;
    const uint32_t st = stage(t);
    // S^T = K Q^T and dP^T = V dO^T, all K-major: 16 columns are 32 bytes
    hold(sc);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(sc, desc(sK + (kk >> 2) * kBwdKeys * 128 + wg * 64 * 128 + off, 16, 1024),
                   desc(st + (kk >> 2) * 64 * 128 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(dp, desc(sV + (kk >> 2) * kBwdKeys * 128 + wg * 64 * 128 + off, 16, 1024),
                   desc(st + C::kTile + (kk >> 2) * 64 * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    hold(sc);
    hold(dp);
    // P^T and dS^T on the fragment: sc[4j + e] is key r0 + 8 (e >> 1), query
    // q0 + 8 j + c0 + (e & 1); only a tile crossing a mask edge pays for the mask
    const int q0 = item_q0(t);
    const float* sl = reinterpret_cast<const float*>(gbase + (st - base) + 2 * C::kTile);
    const float* sd = sl + kBwdQ;
    const bool edge = q0 + kBwdQ > sq || w_lo + 64 > skv || (causal && w_lo + 63 > q0) ||
                      (window > 0 && w_lo <= q0 + 63 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(sl + 8 * j + c0);
      const float2 dd = *reinterpret_cast<const float2*>(sd + 8 * j + c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = ex2(fmaf(sc[i], scale_log2, -((e & 1) ? lv.y : lv.x) * kLog2e));
        if (edge) {
          const int kp = r0 + 8 * (e >> 1), qp = q0 + 8 * j + c0 + (e & 1);
          if (!(qp < sq && kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window)))
            p = 0.f;
        }
        sc[i] = p;
        dp[i] = p * (dp[i] - ((e & 1) ? dd.y : dd.x));
      }
    }
    // dV += P^T dO (hi, then lo), then dK += dS^T Q; dO and Q MN-major: 16
    // queries are 2 KB down the tile, the next 64 columns (dh 128) the next
    // column block, 64 * 128 bytes on
    pack_frag(sc, fr);
    hold(fr);
    hold(dva);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc(st + C::kTile + kk * 16 * 128, 64 * 128, 1024);
      wgmma_pv<DH>(dva, fr[0][kk], d);
      wgmma_pv<DH>(dva, fr[1][kk], d);
    }
    wg_commit();
    wg_wait<0>();
    hold(dva);
    hold(fr);
    pack_frag(dp, fr);
    hold(fr);
    hold(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc(st + kk * 16 * 128, 64 * 128, 1024);
      wgmma_pv<DH>(dka, fr[0][kk], d);
      wgmma_pv<DH>(dka, fr[1][kk], d);
    }
    wg_commit();
    wg_wait<0>();
    hold(dka);
    hold(fr);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < skv && w_lo <= w_hi) {
      const size_t off = ((size_t)b * skv + row) * ldk + (size_t)hk * DH + c0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
            __floats2bfloat162_rn(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
            __floats2bfloat162_rn(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, DH == 64 ? 2 : 1)
dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int sq, int skv, int hq, int hkv, int causal,
             int window, float scale_log2, float scale) {
  using C = BwdCfg<DH>;
  constexpr int NO = DH / 2;
  constexpr int KS = DH / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sO = base + C::kBig, ring = base + 2 * C::kBig;

  const int h = blockIdx.x % hq, b = blockIdx.x / hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;   // the longest causal rows first
  const int hk = h / (hq / hkv);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const size_t ldq = (size_t)hq * DH, ldk = (size_t)hkv * DH;
  const __nv_bfloat16* qb = q + (size_t)b * sq * ldq + (size_t)h * DH;
  const __nv_bfloat16* ob = dout + (size_t)b * sq * ldq + (size_t)h * DH;
  const __nv_bfloat16* kb = k + (size_t)b * skv * ldk + (size_t)hk * DH;
  const __nv_bfloat16* vb = v + (size_t)b * skv * ldk + (size_t)hk * DH;

  // the forward's key tiles of the block and this warpgroup's visible keys
  const int q_last = min(q0 + kBq, sq) - 1;
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int t_first = (window > 0 ? max(0, q0 - window + 1) : 0) / kBk;
  const int n_tiles = kv_end > t_first * kBk ? (kv_end - t_first * kBk + kBk - 1) / kBk : 0;
  const int w_lo = q0 + wg * 64;
  const int w_hi = min(w_lo + 63, sq - 1);
  const int wk_begin = window > 0 ? max(0, w_lo - window + 1) : 0;
  const int wk_end = causal ? min(skv, w_hi + 1) : skv;

  auto key0 = [&](int t) { return (t_first + t) * kBk; };
  auto stage = [&](int t) { return ring + (t % C::kStages) * 2 * C::kTile; };
  constexpr int CPR = DH / 8, RP = kThreads / CPR, NCH = kBk / RP;
  const int row0 = threadIdx.x / CPR, j0 = threadIdx.x % CPR;
  const uint32_t soff0 = swz(row0, j0, kBk);
  const int goff0 = row0 * (int)ldk + j0 * 8;
  auto load_kv = [&](int t) {
    const int kv0 = key0(t);
    const __nv_bfloat16* kt = kb + (size_t)kv0 * ldk;
    const __nv_bfloat16* vt = vb + (size_t)kv0 * ldk;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const bool ok = kv0 + row0 + i * RP < skv;
      const int off = goff0 + i * RP * (int)ldk;
      const uint32_t dst = stage(t) + soff0 + i * RP * 128;
      cp_async16(dst, ok ? kt + off : kb, ok);
      cp_async16(dst + C::kTile, ok ? vt + off : vb, ok);
    }
  };
  auto visible = [&](int t) {
    const int kv0 = key0(t);
    return w_lo <= w_hi && kv0 + kBk > wk_begin && kv0 < wk_end;
  };

  load_tile<DH>(sQ, qb, ldq, q0, kBq, sq);
  load_tile<DH>(sO, ob, ldq, q0, kBq, sq);
#pragma unroll
  for (int t = 0; t < C::kStages - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  const int r0 = w_lo + warp * 16 + (lane >> 2);     // this thread's rows: r0, r0 + 8
  const int c0 = 2 * (lane & 3);
  float ll[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const size_t o = ((size_t)b * hq + h) * sq + row;
    ll[r] = row < sq ? lse[o] * kLog2e : 0.f;
    dd[r] = row < sq ? delta[o] : 0.f;
  }
  float dqa[NO], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < NO; ++i) dqa[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
  uint32_t fr[2][4][4];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<C::kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t + C::kStages - 1 < n_tiles) load_kv(t + C::kStages - 1);
    cp_async_commit();
    if (!visible(t)) continue;
    const uint32_t st = stage(t);
    hold(sc);
    hold(dp);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(sc, desc(sQ + (kk >> 2) * kBq * 128 + wg * 64 * 128 + off, 16, 1024),
                   desc(st + (kk >> 2) * kBk * 128 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss_n64(dp, desc(sO + (kk >> 2) * kBq * 128 + wg * 64 * 128 + off, 16, 1024),
                   desc(st + C::kTile + (kk >> 2) * kBk * 128 + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    hold(sc);
    hold(dp);
    // dS on the fragment: sc[4j + e] is row r0 + 8 (e >> 1), key key0(t) + 8 j + c0 + (e & 1)
    const int kv0 = key0(t);
    const bool edge = kv0 + kBk > skv || (causal && kv0 + kBk - 1 > w_lo) ||
                      (window > 0 && kv0 <= w_hi - window);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = ex2(fmaf(sc[i], scale_log2, -ll[r]));
      if (edge) {
        const int kp = kv0 + 8 * (i >> 2) + c0 + (i & 1), qp = r0 + 8 * r;
        if (!(kp < skv && (!causal || kp <= qp) && (window <= 0 || kp > qp - window))) p = 0.f;
      }
      dp[i] = p * (dp[i] - dd[r]);
    }
    // dQ += dS K (hi, then lo), K MN-major as the forward reads V
    pack_frag(dp, fr);
    hold(fr);
    hold(dqa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc(st + kk * 16 * 128, kBk * 128, 1024);
      wgmma_pv<DH>(dqa, fr[0][kk], d);
      wgmma_pv<DH>(dqa, fr[1][kk], d);
    }
    wg_commit();
    wg_wait<0>();
    hold(dqa);
    hold(fr);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < sq && w_lo <= w_hi) {
      __nv_bfloat16* dst = dq + ((size_t)b * sq + row) * ldq + (size_t)h * DH + c0;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
    }
  }
}

// D = rowsum(dO o O) of bf16 rows of DH: DH / 8 lanes a row, one 16-byte
// chunk of O and of dO each, summed in order and then by a fixed butterfly
// over the row's lanes.
template <int DH>
__global__ void __launch_bounds__(kThreads)
delta_tc_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                float* __restrict__ delta, int rows, int sq, int hq) {
  constexpr int L = DH / 8;
  const int row = (blockIdx.x * kThreads + threadIdx.x) / L, c = threadIdx.x % L;
  float acc = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + (size_t)row * DH + 8 * c);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + (size_t)row * DH + 8 * c);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(pa[e]), y = __bfloat1622float2(pd[e]);
      acc = fmaf(y.y, x.y, fmaf(y.x, x.x, acc));
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && c == 0) {
    const int h = row % hq, i = (row / hq) % sq, b = row / (hq * sq);
    delta[((size_t)b * hq + h) * sq + i] = acc;
  }
}

template <int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int sq,
               int skv, int hq, int hkv, int causal, int window, float scale, cudaStream_t st) {
  using C = BwdCfg<DH>;
  using T = __nv_bfloat16;
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(dout);
  const int rows = b * sq * hq;
  const long long lanes = (long long)rows * (DH / 8);
  delta_tc_kernel<DH><<<(unsigned)((lanes + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const T*>(o), to, delta, rows, sq, hq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* kv_kern = dkdv_tc_kernel<DH>;
  auto* q_kern = dq_tc_kernel<DH>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemKV);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemQ);
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3(b * hkv, (skv + kBwdKeys - 1) / kBwdKeys), kThreads, C::kSmemKV, st>>>(
      tq, tk, tv, to, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, hq, hkv,
      causal, window, scale * kLog2e, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  q_kern<<<dim3(b * hq, (sq + kBq - 1) / kBq), kThreads, C::kSmemQ, st>>>(
      tq, tk, tv, to, lse, delta, static_cast<T*>(dq), sq, skv, hq, hkv, causal, window,
      scale * kLog2e, scale);
  return cudaGetLastError();
}

}  // namespace tc

// q (b, sq, hq, dh); k, v (b, skv, hkv, dh); o (b, sq, hq, dh); all
// contiguous, of one dtype: bf16 when is_bf16, else fp32.  dh in {64, 80,
// 128} (the configs' head dims); hq a multiple of hkv.  Query row i sits at
// position i; window <= 0 means no window.  lse (b, hq, sq) fp32, or null:
// when given (training), each row's natural log-sum-exp of its scaled
// scores is written there; o does not depend on it.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, float* lse, int is_bf16,
                                     int b, int sq, int skv, int hq, int hkv,
                                     int dh, int causal, int window,
                                     float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, o, lse, b, sq, skv, hq, hkv, causal,
                                   window, scale, st);
  return dispatch<float>(dh, q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window,
                         scale, st);
}

// The tensor-core kernel: q, k, v, o, lse as for repro_flash_attention, all
// bf16, dh 64 or 128, 16-byte aligned.
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int b, int sq, int skv, int hq, int hkv,
                                        int dh, int causal, int window, float scale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return tc::launch<64>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, scale, st);
    case 128: return tc::launch<128>(q, k, v, o, lse, b, sq, skv, hq, hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The backward: q, k, v, o, dout of the forward's shapes and dtype (bf16
// when is_bf16, else fp32), lse (b, hq, sq) fp32 from the forward, delta a
// (b, hq, sq) fp32 scratch, dq (b, sq, hq, dh) and dk, dv (b, skv, hkv, dh)
// written in the inputs' dtype.  Three launches (delta, dK/dV, dQ), each
// checked.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* delta, void* dq, void* dk, void* dv,
                                         int is_bf16, int b, int sq, int skv, int hq, int hkv,
                                         int dh, int causal, int window, float scale,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return bwd::dispatch<__nv_bfloat16>(dh, q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq,
                                        skv, hq, hkv, causal, window, scale, st);
  return bwd::dispatch<float>(dh, q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, hq,
                              hkv, causal, window, scale, st);
}

// The tensor-core backward: the operands of repro_flash_attention_bwd, all
// bf16, dh 64 or 128, 16-byte aligned.  Three launches (delta, dK/dV, dQ),
// each checked.
extern "C" int repro_flash_attention_bwd_tc(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const float* lse,
                                            float* delta, void* dq, void* dk, void* dv, int b,
                                            int sq, int skv, int hq, int hkv, int dh, int causal,
                                            int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64: return tc::launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, hq,
                                       hkv, causal, window, scale, st);
    case 128: return tc::launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv,
                                         hq, hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
