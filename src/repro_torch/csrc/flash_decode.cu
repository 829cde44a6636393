// One-token grouped-query attention over a KV cache (the LM decode step).
//
// repro_flash_decode replaces src/repro/kernels/flash_decode/kernel.py
// flash_decode_pallas (B10, body _decode_kernel):
//   out[b, h] = softmax_p(q[b, h] . k[b, p, h / G] / sqrt(dh)) v[b, p, h / G]
//   over the cache positions lo <= p <= idx (lo = idx - window + 1 with a
//   sliding window, else 0), q (B, Hq, dh), k and v (B, S, Hkv, dh), G =
//   Hq / Hkv, bf16 or fp32 in, q's dtype out, fp32 softmax and sums.  As in
//   the TPU kernel, all G query heads of a KV head ride along in one pass,
//   so the cache is read once per group.
// Bound on an H100: the bytes.  One token does 4 G dh FLOPs per 2 dh cache
//   elements read, far below the card's ops-per-byte balance, so the time is
//   the read of K and V over the filled positions, and the design's one job
//   is to keep enough of that read in flight (Little's law: 3.35 TB/s times
//   ~0.6 us of latency is ~15 KB per SM) with few instructions per byte.
//   The TPU kernel walked the cache as a sequential grid axis; here
//   (flash-decoding) a block of 8 warps owns one chunk of positions of one
//   (batch, KV head), and:
//   - K and V tiles of the chunk stream into shared memory by cp.async
//     16-byte copies, through a ring of 4 stages: 3 tiles (~48 KB) are in
//     flight per block while one is consumed.  The wrapper sizes the chunks
//     (kernels/flash_decode/ops.py, decode_geometry) so that every SM holds
//     at least two such blocks.
//   - A lane owns a 16-byte column slice of dh (8 bf16 or 4 fp32): dh/8
//     lanes (a lane group) cover one K or V row, so one warp instruction
//     reads 32/(dh/8) whole rows.  The lane keeps its q slice and its acc
//     slice of the G heads in registers, sized by a tier (G <= 2, 4 or 8)
//     so that small groups leave room for more warps per SM; a score is its
//     partial dot product summed over the group by a fixed xor butterfly,
//     and since every lane of the group then holds the same p, P V needs no
//     exchange at all.
//   - A group of 9 to 16 heads (llama3-405b's 128 query heads on 8 KV
//     heads) does not fit a lane's registers: 16 heads of q and acc slices
//     are 256 floats at bf16 dh 128.  The block then splits its warps into
//     two halves, each holding half of the group in the G <= 8 tier's
//     registers, and each half reads every row of every tile from shared
//     memory, so the cache still leaves device memory once per group.  The
//     merge scratch stays at 8 heads a warp, within the ring it reuses, and
//     each head is merged over its own half's warps in index order.  A
//     group of at most 8 takes the one-half instantiation, whose code and
//     sums are the earlier kernel's.
//   - Each lane group runs its own online softmax over the rows it reads,
//     rescaling its state only when the max rises; at the end of the chunk
//     the groups of a warp merge by xor butterfly and the warps in index
//     order, and then the chunks of a (batch, KV head) are merged in chunk
//     order by the last of its blocks to finish, in the same launch: an
//     integer arrival counter per (batch, KV head), in a workspace the
//     wrapper keeps zeroed, picks that block, which resets it for the next
//     call.  The atomic only picks the merging block; the sum order is
//     fixed, and there are no float atomics: the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;         // ring depth (tiles)
constexpr int kMaxG = 16;          // query heads per KV head (two halves above kRegG)
constexpr int kRegG = 8;           // query heads a warp holds in registers
constexpr float kNeg = -1e30f;     // the TPU kernel's finite mask value

template <typename T, int DH>
struct Cfg {
  static constexpr int VN = 16 / (int)sizeof(T);   // elements of a 16-byte slice
  static constexpr int CH = DH / VN;               // slices per row
  static constexpr int GS = CH <= 8 ? 8 : CH <= 16 ? 16 : 32;   // lanes per row
  static constexpr int RPW = 32 / GS;              // rows per warp instruction
  // positions per tile: 8 KB of K (5 KB at dh 80); repro_flash_decode_tile
  static constexpr int TP = (DH == 64 ? 64 : 32) * 2 / (int)sizeof(T);
  static constexpr int STEPS = TP / (kWarps * RPW);   // row steps per warp per tile
  static constexpr int TILE = TP * DH * (int)sizeof(T);
  static constexpr int SMEM = kStages * 2 * TILE;
  static_assert(DH % VN == 0 && CH <= 32 && STEPS * kWarps * RPW == TP, "decode geometry");
  static_assert(kWarps * kRegG * (DH + 2) * 4 <= SMEM, "merge scratch");
};

using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;

template <typename T>
__device__ __forceinline__ void unpack16(const uint4 raw, float* dst) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) dst[i] = repro::to_f32(e[i]);
}

// Positions [p, p + TP) of K and V (rows >= p1 not copied) into a stage.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(uint32_t sk, uint32_t sv, const T* kb, const T* vb,
                                          size_t ld, int p, int p1) {
  using C = Cfg<T, DH>;
  for (int e = threadIdx.x; e < C::TP * C::CH; e += kThreads) {
    const int r = e / C::CH, j = e % C::CH;
    if (p + r < p1) {
      const size_t off = (size_t)(p + r) * ld + j * C::VN;
      const uint32_t so = (uint32_t)((r * DH + j * C::VN) * sizeof(T));
      cp_async16(sk + so, kb + off);
      cp_async16(sv + so, vb + off);
    }
  }
}

// Merge softmax state b into a: (m, l, acc) over two disjoint position sets.
template <int VN>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[VN], float mb, float lb,
                                      const float (&accb)[VN]) {
  const float mx = fmaxf(m, mb);
  const float wa = expf(m - mx), wb = expf(mb - mx);
  m = mx;
  l = l * wa + lb * wb;
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = acc[e] * wa + accb[e] * wb;
}

// GT: register slots a warp holds for its query heads.  HALVES: 1, every
// warp holds all G <= GT heads; 2, warps [0, 4) hold heads [0, gh) and warps
// [4, 8) heads [gh, G), gh = ceil(G / 2) <= GT, each half over all rows.
template <typename T, int DH, int GT, int HALVES>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    float* __restrict__ part, int* __restrict__ arrivals, T* __restrict__ out,
                    int s, int hkv, int g, int lo, int hi, int chunk, int nsplit, float scale) {
  using C = Cfg<T, DH>;
  constexpr int VN = C::VN, GS = C::GS;
  constexpr int PW = DH + 2;                 // a partial: m, l, acc[DH]
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(smem);
  __shared__ int s_last;

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int pair = b * hkv + hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane / GS, c = lane % GS;  // lane group (a row) and slice
  const bool has = c < C::CH;                // dh 80: the group's last lanes idle
  constexpr int WH = kWarps / HALVES;        // warps of a half
  const int wh = warp % WH;                  // this warp's place in its half
  const int gh = HALVES == 1 ? g : (g + 1) / 2;   // heads a half holds
  const int g0 = (warp / WH) * gh;           // this warp's first head
  const int gn = HALVES == 1 ? g : min(gh, g - g0);   // and its count
  const size_t ld = (size_t)hkv * DH;
  const T* kb = k + (size_t)b * s * ld + (size_t)hk * DH;
  const T* vb = v + (size_t)b * s * ld + (size_t)hk * DH;
  const int p0 = lo + sp * chunk;
  const int p1 = min(hi, p0 + chunk);
  const int n_tiles = (p1 - p0 + C::TP - 1) / C::TP;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles)
      load_tile<T, DH>(s_base + st * 2 * C::TILE, s_base + st * 2 * C::TILE + C::TILE, kb, vb,
                       ld, p0 + st * C::TP, p1);
    cp_async_commit();
  }

  // this lane's q slice of the G heads, pre-scaled, and its running state
  float qf[GT][VN], acc[GT][VN], m[GT], l[GT];
#pragma unroll
  for (int gg = 0; gg < GT; ++gg) {
    m[gg] = kNeg;
    l[gg] = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) qf[gg][e] = acc[gg][e] = 0.f;
    if (gg < gn && has) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + ((size_t)pair * g + g0 + gg) * DH + c * VN);
      unpack16<T>(raw, qf[gg]);
#pragma unroll
      for (int e = 0; e < VN; ++e) qf[gg][e] *= scale;
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();            // tile t has landed (this thread's copies)
    __syncthreads();                         // everyone's; tile t-1 consumed by all
    {
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        const uint32_t sk = s_base + (tn % kStages) * 2 * C::TILE;
        load_tile<T, DH>(sk, sk + C::TILE, kb, vb, ld, p0 + tn * C::TP, p1);
      }
      cp_async_commit();
    }
    const uint8_t* sk = smem + (t % kStages) * 2 * C::TILE;
    const uint8_t* sv = sk + C::TILE;
#pragma unroll
    for (int step = 0; step < C::STEPS * HALVES; ++step) {
      const int row = (wh * C::STEPS * HALVES + step) * C::RPW + grp;
      const bool ok = p0 + t * C::TP + row < p1;     // the same for the whole group
      float kf[VN], vf[VN];
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = kraw;
      if (ok && has) {
        const int so = (row * DH + c * VN) * (int)sizeof(T);
        kraw = *reinterpret_cast<const uint4*>(sk + so);
        vraw = *reinterpret_cast<const uint4*>(sv + so);
      }
      unpack16<T>(kraw, kf);
      unpack16<T>(vraw, vf);
#pragma unroll
      for (int gg = 0; gg < GT; ++gg) {
        if (gg < gn) {
          float sc = 0.f;
#pragma unroll
          for (int e = 0; e < VN; ++e) sc = fmaf(qf[gg][e], kf[e], sc);
#pragma unroll
          for (int off = GS / 2; off > 0; off >>= 1)
            sc += __shfl_xor_sync(0xffffffffu, sc, off);
          if (ok) {
            if (sc > m[gg]) {                // a new max: rescale the state (rare)
              const float alpha = expf(m[gg] - sc);
              m[gg] = sc;
              l[gg] *= alpha;
#pragma unroll
              for (int i = 0; i < VN; ++i) acc[gg][i] *= alpha;
            }
            const float p = expf(sc - m[gg]);
            l[gg] += p;
#pragma unroll
            for (int i = 0; i < VN; ++i) acc[gg][i] = fmaf(p, vf[i], acc[gg][i]);
          }
        }
      }
    }
  }

  // merge the lane groups of each warp (xor butterfly over the group bits),
  // then the warps in index order; the ring is free scratch after the loop
#pragma unroll
  for (int off = GS; off < 32; off <<= 1) {
#pragma unroll
    for (int gg = 0; gg < GT; ++gg) {
      if (gg < gn) {
        float accb[VN];
#pragma unroll
        for (int e = 0; e < VN; ++e) accb[e] = __shfl_xor_sync(0xffffffffu, acc[gg][e], off);
        const float mb = __shfl_xor_sync(0xffffffffu, m[gg], off);
        const float lb = __shfl_xor_sync(0xffffffffu, l[gg], off);
        merge<VN>(m[gg], l[gg], acc[gg], mb, lb, accb);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);      // [warp][gh][m, l, acc]
  if (grp == 0) {
#pragma unroll
    for (int gg = 0; gg < GT; ++gg) {
      if (gg < gn) {
        float* dst = red + (warp * gh + gg) * PW;
        if (c == 0) {
          dst[0] = m[gg];
          dst[1] = l[gg];
        }
        if (has) {
#pragma unroll
          for (int e = 0; e < VN; ++e) dst[2 + c * VN + e] = acc[gg][e];
        }
      }
    }
  }
  __syncthreads();
  float* mine = part + ((size_t)pair * nsplit + sp) * g * PW;   // (pair, sp, g, PW)
  for (int it = threadIdx.x; it < g * DH; it += kThreads) {
    const int gg = it / DH, d = it % DH;
    const int hf = HALVES == 1 ? 0 : gg / gh;       // the half holding head gg
    const int lg = gg - hf * gh, w0 = hf * WH;
    float mx = kNeg;
    for (int w = w0; w < w0 + WH; ++w) mx = fmaxf(mx, red[(w * gh + lg) * PW]);
    float den = 0.f, num = 0.f;
    for (int w = w0; w < w0 + WH; ++w) {
      const float* src = red + (w * gh + lg) * PW;
      const float wt = expf(src[0] - mx);
      den = fmaf(src[1], wt, den);
      num = fmaf(src[2 + d], wt, num);
    }
    if (nsplit == 1) {
      out[((size_t)pair * g + gg) * DH + d] = repro::from_f32<T>(num / fmaxf(den, 1e-30f));
    } else {
      if (d == 0) {
        mine[gg * PW] = mx;
        mine[gg * PW + 1] = den;
      }
      mine[gg * PW + 2 + d] = num;
    }
  }
  if (nsplit == 1) return;

  // the last block of this (batch, KV head) to arrive merges the chunks
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrivals + pair, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* first = part + (size_t)pair * nsplit * g * PW;
  for (int it = threadIdx.x; it < g * DH; it += kThreads) {
    const int gg = it / DH, d = it % DH;
    float mx = kNeg;
    for (int j = 0; j < nsplit; ++j) mx = fmaxf(mx, __ldcg(first + ((size_t)j * g + gg) * PW));
    float den = 0.f, num = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const float* src = first + ((size_t)j * g + gg) * PW;
      const float wt = expf(__ldcg(src) - mx);
      den = fmaf(__ldcg(src + 1), wt, den);
      num = fmaf(__ldcg(src + 2 + d), wt, num);
    }
    out[((size_t)pair * g + gg) * DH + d] = repro::from_f32<T>(num / fmaxf(den, 1e-30f));
  }
  if (threadIdx.x == 0) arrivals[pair] = 0;        // ready for the next call
}

template <typename T, int DH, int GT, int HALVES>
int launch(const void* q, const void* k, const void* v, float* part, int* arrivals, void* out,
           int b, int s, int hkv, int g, int lo, int hi, int chunk, int nsplit, float scale,
           cudaStream_t st) {
  constexpr int bytes = Cfg<T, DH>::SMEM;
  auto* kern = flash_decode_kernel<T, DH, GT, HALVES>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nsplit, hkv, b), kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part,
      arrivals, static_cast<T*>(out), s, hkv, g, lo, hi, chunk, nsplit, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
int by_group(int g, const void* q, const void* k, const void* v, float* part, int* arrivals,
             void* out, int b, int s, int hkv, int lo, int hi, int chunk, int nsplit,
             float scale, cudaStream_t st) {
  if (g <= 2) return launch<T, DH, 2, 1>(q, k, v, part, arrivals, out, b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
  if (g <= 4) return launch<T, DH, 4, 1>(q, k, v, part, arrivals, out, b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
  if (g <= kRegG) return launch<T, DH, kRegG, 1>(q, k, v, part, arrivals, out, b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
  return launch<T, DH, kRegG, 2>(q, k, v, part, arrivals, out, b, s, hkv, g, lo, hi, chunk, nsplit, scale, st);
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, float* part, int* arrivals,
             void* out, int b, int s, int hkv, int g, int lo, int hi, int chunk, int nsplit,
             float scale, cudaStream_t st) {
  switch (dh) {
    case 64: return by_group<T, 64>(g, q, k, v, part, arrivals, out, b, s, hkv, lo, hi, chunk, nsplit, scale, st);
    case 80: return by_group<T, 80>(g, q, k, v, part, arrivals, out, b, s, hkv, lo, hi, chunk, nsplit, scale, st);
    case 128: return by_group<T, 128>(g, q, k, v, part, arrivals, out, b, s, hkv, lo, hi, chunk, nsplit, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, hkv * g, dh); k, v (b, s, hkv, dh), contiguous and 16-byte aligned,
// of one dtype (bf16 when is_bf16, else fp32); out like q.  Positions
// [lo, hi) are attended (hi = idx + 1), split into nsplit chunks of `chunk`
// positions (a multiple of the tile; no chunk empty).  part: fp32 scratch of
// b * hkv * nsplit * g * (dh + 2) floats (unused when nsplit == 1); arrivals:
// b * hkv ints, zero on entry and left zero.  dh in {64, 80, 128}, 1 <= g <= 16.
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v, float* part,
                                  int* arrivals, void* out, int is_bf16, int b, int s, int hkv,
                                  int g, int dh, int lo, int hi, int chunk, int nsplit,
                                  float scale, void* stream) {
  if (g < 1 || g > kMaxG) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(dh, q, k, v, part, arrivals, out, b, s, hkv, g, lo, hi,
                                   chunk, nsplit, scale, st);
  return dispatch<float>(dh, q, k, v, part, arrivals, out, b, s, hkv, g, lo, hi, chunk, nsplit,
                         scale, st);
}

// Positions per K/V tile of the kernel for (dh, itemsize 2 = bf16 or 4 =
// fp32), 0 for a pair it does not serve: the wrapper cuts chunks in whole
// tiles of this size.
extern "C" int repro_flash_decode_tile(int dh, int itemsize) {
  if (itemsize != 2 && itemsize != 4) return 0;
  const bool b = itemsize == 2;
  switch (dh) {
    case 64: return b ? Cfg<__nv_bfloat16, 64>::TP : Cfg<float, 64>::TP;
    case 80: return b ? Cfg<__nv_bfloat16, 80>::TP : Cfg<float, 80>::TP;
    case 128: return b ? Cfg<__nv_bfloat16, 128>::TP : Cfg<float, 128>::TP;
    default: return 0;
  }
}

// The most query heads per KV head one launch serves.
extern "C" int repro_flash_decode_max_group() { return kMaxG; }
