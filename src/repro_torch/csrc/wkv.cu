// The RWKV-6 WKV recurrence of the rwkv6 prefill, fp32 in and out.
//
// repro_wkv replaces src/repro/kernels/wkv/kernel.py wkv_chunked_pallas
// (B11, body _wkv_kernel): per (batch, head), with the (dh, dh) state S
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T
//   for r, k, v, w (B, S, H, dh) and u (H, dh); it also writes the final
//   state S_T (B, H, dh, dh), state[b, h, i, j] = S[i][j], which the prefill
//   hands to the decode cache (the JAX package replays the recurrence for it).
//
// Bound on an H100: 20 B H S dh bytes (r, k, v, w read once, out written
//   once) plus the final state, against 4 B H S dh^2 operations of the exact
//   recurrence: the bytes bound it (0.1014 ms at the rwkv6 serving shape).
//   The per-token recurrence cannot reach them: it needs at least 3 fp32
//   instructions per state entry and token, 0.11-0.15 ms on the FP32 pipe
//   before any load.  So this kernel leaves it, as the TPU kernel did.
//
// Design: the chunked form, overflow-safe, with its products on the tensor
//   cores.
//   - Chunks of kC = 16 tokens.  Every decay factor is a product of w's in
//     (0, 1] formed by multiplication inside the chunk, never a quotient:
//       Pex_t = prod_{u<t} w_u, Sfx_s = prod_{u>s} w_u, Pall = prod_u w_u,
//       out_t = (r_t * Pex_t)^T S + sum_{s<=t} A[t][s] v_s,
//       A[t][s] = sum_i r_t[i] k_s[i] prod_{s<u<t} w_u[i] (s < t),
//       A[t][t] = sum_i r_t[i] u[i] k_t[i] (the bonus, once per token),
//       S <- diag(Pall) S + sum_s (k_s * Sfx_s) v_s^T.
//     Inside each half of a chunk A comes from a running product walked
//     from s = t - 1 down; across the halves it is a dot of two factors
//     taken through the midpoint, r_t prod_{8<=u<t} w_u and k_s
//     prod_{s<u<8} w_u.  A factor can only underflow to 0, within 1e-38 of
//     its true value; it cannot overflow, where the TPU kernel's exp(-log P)
//     passes the fp32 range once a chunk's summed log-decay passes about
//     -88.  No logarithm or exponential is taken, so no factor is the
//     exponential of a difference of two long cumulative sums.
//   - The three products of a chunk, (C x dh)(dh x dv), (dh x C)(C x dv) and
//     (C x C)(C x dv), run as mma.sync m16n8k8 TF32 with the 3xTF32 split
//     (x = big + small, both TF32; big*big + big*small + small*big), which
//     keeps fp32 accuracy; the split is two integer operations and a
//     subtraction, done as the fragments are loaded.  The MMA warps keep S
//     transposed (value column j as the MMA row) in their accumulator
//     registers for the whole sequence; the product r S reads those
//     registers as its A operand by permuting the key index inside each
//     8-wide k-step (its B operand is read under the same permutation), so S
//     never goes through memory.
//   - One block per (batch, head): dh/16 MMA warps, each owning 16 value
//     columns, consume chunk c - 1 while dh/16 prep warps turn chunk c into
//     operands, one __syncthreads a chunk.  The prep warps work in two
//     halves side by side (the decay products of a column; the in-half
//     scores, reduced across lanes in a fixed order), then together on the
//     scores across the halves.  The value columns are split over warps, not
//     over blocks, so that the scores and the decay products are formed once
//     per chunk and head.
//   - r, k, v, w arrive by cp.async (16-byte copies; 4-byte ones when an
//     operand does not start on 16 bytes) into three raw stages: chunk c + 1
//     loads, chunk c is prepared, and the MMA warps read chunk c - 1's V
//     straight from its stage.  The prep warps issue chunk c + 1's copies
//     once chunk c has landed, not before their wait: copies issued earlier
//     stall them for as long as the copies take at the memory's rate.  A
//     ragged tail is masked in shared memory (r = k = v = 0, w = 1: the
//     state is left as it was).
//   Every sum has a fixed order and no float atomics are used: the same bits
//   on every run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kC = 16;      // tokens per chunk (the MMA row tile)
constexpr int kH = kC / 2;  // tokens per half chunk
constexpr int kPA = 20;     // padded row of the score tile (conflict-free B loads)
constexpr int kAhead = 1;   // chunks loading ahead of the one being prepared
constexpr int kRaw = kAhead + 2;   // raw stages: loading, prepared, V read by the MMAs

template <int DH>
struct Wkv {
  static constexpr int warps = DH / 16;            // prep warps = MMA warps
  static constexpr int prep = 32 * warps;          // prep threads (2 DH)
  static constexpr int threads = 2 * prep;
  static constexpr int lanes = DH / 8;             // lanes of a score group, 8 keys each
  static constexpr int P = DH + 8;                 // padded row (conflict-free fragments)
  static constexpr int tile = kC * P;              // one chunk tile (r, k, v, w, rd or kd)
  static constexpr int raw_stage = 4 * tile;       // r, k, v, w
  static constexpr int stage = 2 * tile + 2 * kC * kPA + DH;   // rd, kd, A big/small, Pall
  static constexpr int cross = 2 * kH * P;         // r and k factors across the halves
  static constexpr int floats = kRaw * raw_stage + 2 * stage + cross + DH;   // + u
  static constexpr size_t bytes = sizeof(float) * floats;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// x = big + small: big is x rounded to TF32 (10 fraction bits, ties away
// from zero, as cvt.rna.tf32.f32 rounds, in two integer operations), small
// = x - big exactly; the MMA reads small to TF32 precision, so big + small
// holds x to about 2^-21 relative, and the dropped small x small term of a
// product is below 2^-22 of it.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a b to fp32 accuracy, with a and b split into big + small and
// the small x small term dropped; the correction terms go first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(d, as, bb[0], bb[1]);
  mma(d, ab, bs[0], bs[1]);
  mma(d, ab, bb[0], bb[1]);
}

__device__ __forceinline__ void split2(float x0, float x1, uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  split(x0, big[0], small[0]);
  split(x1, big[1], small[1]);
}

__device__ __forceinline__ void bar_prep(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Sum of x over the L lanes of an aligned lane group, on every lane.
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sums of v[0..8) over the L lanes (4 or 8) of an aligned lane group,
// scattered: afterwards lane li holds in v[m] the sum of entry li * (8 / L)
// + m, for m < 8 / L.  Each level keeps half of the entries (7 shuffles at
// L = 8 where 8 separate sums would take 24); the halves are swapped by an
// xor of bit patterns, so no entry is indexed at run time.
template <int L>
__device__ __forceinline__ void reduce_scatter8(float (&v)[8], int li) {
  static_assert(L == 4 || L == 8, "groups of 4 or 8 lanes");
  constexpr int levels = L == 8 ? 3 : 2;
#pragma unroll
  for (int lvl = 0; lvl < levels; ++lvl) {
    const int o = L >> (lvl + 1);
    const int half = 4 >> lvl;
    const uint32_t up = (li & o) ? 0xffffffffu : 0u;
#pragma unroll
    for (int m = 0; m < half; ++m) {
      const uint32_t a = __float_as_uint(v[m]), b = __float_as_uint(v[m + half]);
      const uint32_t x = (a ^ b) & up;                 // up: keep b, send a
      v[m] = __uint_as_float(a ^ x) + __shfl_xor_sync(0xffffffffu, __uint_as_float(b ^ x), o);
    }
  }
}

// The operands one chunk's MMAs read: r * Pex and k * Sfx in fp32, the C x C
// scores A (strict upper triangle zero) split into TF32 halves, and Pall.
template <int DH>
struct Stage {
  float *rd, *kd, *pall;
  uint32_t *ab, *as;
  __device__ explicit Stage(float* base) {
    using W = Wkv<DH>;
    rd = base;
    kd = base + W::tile;
    ab = reinterpret_cast<uint32_t*>(base + 2 * W::tile);
    as = ab + kC * kPA;
    pall = reinterpret_cast<float*>(as + kC * kPA);
  }
};

// Chunk c's r, k, v, w into a raw stage (rows of P floats; rows past n
// masked: r = k = v = 0, w = 1), issued by the prep threads as one group of
// cp.async copies: 16-byte copies, or 4-byte ones on the unaligned path.
template <int DH, bool ALIGNED>
__device__ __forceinline__ void load_chunk(float* raw, const float* r, const float* k,
                                           const float* v, const float* w, size_t head0,
                                           size_t tok, int n, int pt) {
  using W = Wkv<DH>;
  constexpr int per = ALIGNED ? 4 : 1;             // floats a copy
  constexpr int row = DH / per;                    // copies a row
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
#pragma unroll
    for (int e = pt; e < kC * row; e += W::prep) {
      const int t = e / row, d = (e % row) * per;
      float* to = raw + a * W::tile + t * W::P + d;
      if (t < n) {
        const float* from = src + head0 + (size_t)t * tok + d;
        if constexpr (ALIGNED) repro::cp_async16(smem_addr(to), from);
        else cp_async4(smem_addr(to), from);
      } else {
#pragma unroll
        for (int q = 0; q < per; ++q) to[q] = a == 3 ? 1.f : 0.f;
      }
    }
  }
  repro::cp_async_commit();
}

// The prep warps: one raw chunk -> the operands of its MMAs, in two halves
// that run side by side: the first DH threads form the decay products of
// their column, the other DH the scores A[t][s] (s < t) inside each half of
// the chunk (t, s < 8 or t, s >= 8) by a running product walked from s = t - 1
// down.  Then all of them form the scores across the halves (t >= 8 > s)
// through the midpoint, as dots of r_t prod_{8<=u<t} w_u and k_s
// prod_{s<u<8} w_u, both factors <= 1.
// WS is the tile slot of w in the raw stage (the forward's stage holds r, k,
// v, w; the backward's r, k, w).
template <int DH, int WS = 3>
__device__ __forceinline__ void prep_chunk(const float* raw, Stage<DH> st, float* cross,
                                           const float* su, int pt) {
  using W = Wkv<DH>;
  constexpr int P = W::P;
  const float* R = raw;
  const float* K = raw + W::tile;
  const float* Wd = raw + WS * W::tile;
  float* R8 = cross;                                 // rows t = 8 .. 15
  float* K8 = cross + kH * W::P;                    // rows s = 0 .. 7

  if (pt < DH) {
    // column i: r * Pex, Pall and r's cross factor running forward, k * Sfx
    // and k's cross factor running backward, each a product of the column's w
    const int i = pt;
    float x[kC], y[kC], wt[kC];
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      x[t] = R[t * P + i];
      y[t] = K[t * P + i];
      wt[t] = Wd[t * P + i];
    }
    float run = 1.f, run8 = 1.f, back = 1.f, back8 = 1.f;
#pragma unroll
    for (int t = 0; t < kC; ++t) {
      const int tb = kC - 1 - t;
      st.rd[t * P + i] = x[t] * run;
      st.kd[tb * P + i] = y[tb] * back;
      if (t >= kH) {
        R8[(t - kH) * W::P + i] = x[t] * run8;
        run8 *= wt[t];
      }
      if (tb < kH) {
        K8[tb * W::P + i] = y[tb] * back8;
        back8 *= wt[tb];
      }
      run *= wt[t];
      back *= wt[tb];
    }
    st.pall[i] = run;
  } else {
    // scores inside the halves: group g of L lanes (keys 4 li .. 4 li + 3 and
    // the same DH / 2 on, on lane li) in half hf takes the rows tA = 8 hf + gg + 1 and tB = 8 hf +
    // 7 - gg (8 entries in all; gg = 3 takes row 8 hf + 4 and the bonus of
    // row 8 hf), walking s down from t - 1 with h = r_t prod_{s<u<t} w_u
    constexpr int L = W::lanes;
    const int q0 = pt - DH, g = q0 / L, li = q0 % L, hf = g / 4, gg = g % 4;
    const int nA = gg < 3 ? gg + 1 : 4;              // entries of row tA
    const int tA = kH * hf + nA;
    const int tB = gg < 3 ? kH * hf + kH - 1 - gg : kH * hf;
    auto ld8 = [&](const float* rowp, float4& a, float4& b) {
      a = *reinterpret_cast<const float4*>(rowp + 4 * li);
      b = *reinterpret_cast<const float4*>(rowp + 4 * li + DH / 2);
    };
    float4 u0, u1, rA0, rA1, rB0, rB1, kA0, kA1, kB0, kB1;
    ld8(su, u0, u1);
    ld8(R + tA * P, rA0, rA1);
    ld8(R + tB * P, rB0, rB1);
    ld8(K + tA * P, kA0, kA1);
    ld8(K + tB * P, kB0, kB1);
    auto mul4 = [](float4 a, float4 b) {
      return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
    };
    const float dA = group_sum<L>(
        repro::dot4(rA1, mul4(u1, kA1), repro::dot4(rA0, mul4(u0, kA0), 0.f)));
    const float dB = group_sum<L>(
        repro::dot4(rB1, mul4(u1, kB1), repro::dot4(rB0, mul4(u0, kB0), 0.f)));
    if (li == 0) split(dA, st.ab[tA * kPA + tA], st.as[tA * kPA + tA]);
    if (li == 1) split(dB, st.ab[tB * kPA + tB], st.as[tB * kPA + tB]);

    float vals[kH];
    float4 h0 = rA0, h1 = rA1;
#pragma unroll
    for (int q = 0; q < kH; ++q) {
      if (q == nA) {
        h0 = rB0;
        h1 = rB1;
      }
      const int s = q < nA ? tA - 1 - q : kH * hf + kH - 1 - q;
      float4 k0, k1, w0, w1;
      ld8(K + s * P, k0, k1);
      ld8(Wd + s * P, w0, w1);
      vals[q] = repro::dot4(h1, k1, repro::dot4(h0, k0, 0.f));
      h0 = mul4(h0, w0);
      h1 = mul4(h1, w1);
    }
    reduce_scatter8<L>(vals, li);
#pragma unroll
    for (int m = 0; m < kH / L; ++m) {
      const int q = li * (kH / L) + m;
      if (gg == 3 && q >= 4) continue;               // row 8 hf has no s < t
      const int t = q < nA ? tA : tB;
      const int s = q < nA ? tA - 1 - q : kH * hf + kH - 1 - q;
      split(vals[m], st.ab[t * kPA + s], st.as[t * kPA + s]);
    }
  }
  // scores across the halves, once every prep thread's factors are in:
  // entry (t, s) = (8 + e / 8, e % 8) by two lanes (keys 8c + 4 hb .. + 3)
  bar_prep(W::prep);
#pragma unroll
  for (int e2 = pt; e2 < 2 * kH * kH; e2 += W::prep) {
    const int e = e2 >> 1, hb = e2 & 1;
    const float* rr = R8 + (e / kH) * W::P + 4 * hb;
    const float* kk = K8 + (e % kH) * W::P + 4 * hb;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int c = 0; c < DH / 8; c += 2) {
      a0 = repro::dot4(*reinterpret_cast<const float4*>(rr + 8 * c),
                       *reinterpret_cast<const float4*>(kk + 8 * c), a0);
      a1 = repro::dot4(*reinterpret_cast<const float4*>(rr + 8 * c + 8),
                       *reinterpret_cast<const float4*>(kk + 8 * c + 8), a1);
    }
    float total = a0 + a1;
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    if (hb == 0) {
      const int t = kH + e / kH, s = e % kH;
      split(total, st.ab[t * kPA + s], st.as[t * kPA + s]);
    }
  }
}

// One MMA warp: out of the chunk for its 16 value columns, then the state.
// S[p] is the accumulator tile of S^T rows j0 .. j0 + 15 (value columns),
// columns 8p .. 8p + 7 (keys): S[p][0] = S[8p + 2 tig][j0 + gid], [1] key + 1,
// [2] value + 8, [3] both.  rd, kd and V are fp32 in shared memory and are
// split into TF32 halves as their fragments are loaded.
template <int DH>
__device__ __forceinline__ void mma_chunk(Stage<DH> st, const float* V, float (&S)[DH / 8][4],
                                          float* out, size_t tok, int n, int j0, int lane) {
  using W = Wkv<DH>;
  constexpr int P = W::P;
  const int gid = lane >> 2, tig = lane & 3;

  // V^T as the A operand (rows j, k-steps over s), both halves, both k-steps
  uint32_t vb[2][4], vs[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const float* v0 = V + (8 * kk + tig) * P + j0 + gid;
    split(v0[0], vb[kk][0], vs[kk][0]);
    split(v0[8], vb[kk][1], vs[kk][1]);
    split(v0[4 * P], vb[kk][2], vs[kk][2]);
    split(v0[4 * P + 8], vb[kk][3], vs[kk][3]);
  }

  // out^T (rows j, columns t) = S^T (r * Pex)^T + V^T A^T, the big part and
  // the correction terms in separate accumulators
  float ob[2][4] = {}, os[2][4] = {};
#pragma unroll
  for (int p = 0; p < DH / 8; ++p) {
    // S^T's accumulator tile as an A operand: k = tig <-> key 8p + 2 tig,
    // k = tig + 4 <-> key 8p + 2 tig + 1 (the B loads below follow it)
    uint32_t sb[4], ss[4];
    split(S[p][0], sb[0], ss[0]);
    split(S[p][2], sb[1], ss[1]);
    split(S[p][1], sb[2], ss[2]);
    split(S[p][3], sb[3], ss[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float2 x = *reinterpret_cast<const float2*>(st.rd + (8 * nt + gid) * P + 8 * p +
                                                        2 * tig);
      uint32_t rb[2], rs[2];
      split2(x.x, x.y, rb, rs);
      mma(os[nt], ss, rb[0], rb[1]);
      mma(os[nt], sb, rs[0], rs[1]);
      mma(ob[nt], sb, rb[0], rb[1]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int o = (8 * nt + gid) * kPA + 8 * kk + tig;
      const uint32_t ab[2] = {st.ab[o], st.ab[o + 4]}, as[2] = {st.as[o], st.as[o + 4]};
      mma(os[nt], vs[kk], ab[0], ab[1]);
      mma(os[nt], vb[kk], as[0], as[1]);
      mma(ob[nt], vb[kk], ab[0], ab[1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 8 * nt + 2 * tig + (e & 1), j = j0 + gid + 8 * (e >> 1);
      if (t < n) out[(size_t)t * tok + j] = ob[nt][e] + os[nt][e];
    }
  }

  // S^T <- S^T diag(Pall) + V^T (k * Sfx)
#pragma unroll
  for (int p = 0; p < DH / 8; ++p) {
    const float2 pa = *reinterpret_cast<const float2*>(st.pall + 8 * p + 2 * tig);
    S[p][0] *= pa.x; S[p][1] *= pa.y; S[p][2] *= pa.x; S[p][3] *= pa.y;
  }
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int p = 0; p < DH / 8; ++p) {
      const float* k0 = st.kd + (8 * kk + tig) * P + 8 * p + gid;
      uint32_t kb[2], ks[2];
      split2(k0[0], k0[4 * P], kb, ks);
      mma3(S[p], vb[kk], vs[kk], kb, ks);
    }
  }
}

template <int DH, bool ALIGNED>
__global__ void __launch_bounds__(Wkv<DH>::threads, 2)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ out,
           float* __restrict__ state_out, int s, int h) {
  using W = Wkv<DH>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* raw = sm;                                   // kRaw raw stages
  float* der = sm + kRaw * W::raw_stage;             // 2 operand stages
  float* cross = der + 2 * W::stage;                 // the cross factors (prep only)
  float* su = cross + W::cross;
  const int hh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool is_prep = warp < W::warps;
  const int nch = (s + kC - 1) / kC;
  const size_t tok = (size_t)h * DH;                 // stride of one token
  const size_t head0 = (size_t)b * s * tok + (size_t)hh * DH;

  // the strict upper triangles of the score tiles stay zero
  for (int e = threadIdx.x; e < 2 * kC * kPA; e += W::threads) {
    Stage<DH> st(der + (e / (kC * kPA)) * W::stage);
    st.ab[e % (kC * kPA)] = 0u;
    st.as[e % (kC * kPA)] = 0u;
  }
  auto load = [&](int c) {                          // chunk c's copies, one group
    if (c < nch)
      load_chunk<DH, ALIGNED>(raw + (c % kRaw) * W::raw_stage, r, k, v, w,
                              head0 + (size_t)c * kC * tok, tok, min(kC, s - c * kC),
                              threadIdx.x);
    else
      repro::cp_async_commit();                    // an empty group keeps the count
  };
  if (is_prep) {
    if (threadIdx.x < DH) su[threadIdx.x] = u[(size_t)hh * DH + threadIdx.x];
#pragma unroll
    for (int c = 0; c < kAhead; ++c) load(c);
  }
  __syncthreads();

  float S[DH / 8][4];
#pragma unroll
  for (int p = 0; p < DH / 8; ++p) S[p][0] = S[p][1] = S[p][2] = S[p][3] = 0.f;
  const int j0 = 16 * (warp - W::warps);

  // iteration c: the prep warps issue chunk c + kAhead's copies and prepare
  // chunk c, while the MMA warps consume chunk c - 1 (its operands and its
  // raw V)
  for (int c = 0; c <= nch; ++c) {
    if (is_prep) {
      if (c < nch) {
        repro::cp_async_wait<kAhead - 1>();          // chunk c has landed (own copies)
        bar_prep(W::prep);                           // ... and every prep thread's
        load(c + kAhead);
        prep_chunk<DH>(raw + (c % kRaw) * W::raw_stage, Stage<DH>(der + (c & 1) * W::stage),
                       cross, su, threadIdx.x);
      }
    } else if (c > 0) {
      const int c0 = c - 1;
      mma_chunk<DH>(Stage<DH>(der + (c0 & 1) * W::stage),
                    raw + (c0 % kRaw) * W::raw_stage + 2 * W::tile, S,
                    out + head0 + (size_t)c0 * kC * tok, tok, min(kC, s - c0 * kC), j0, lane);
    }
    __syncthreads();
  }

  if (!is_prep) {
    float* dst = state_out + ((size_t)b * h + hh) * DH * DH;
    const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int p = 0; p < DH / 8; ++p) {
      const int i = 8 * p + 2 * tig, j = j0 + gid;
      dst[(size_t)i * DH + j] = S[p][0];
      dst[(size_t)(i + 1) * DH + j] = S[p][1];
      dst[(size_t)i * DH + j + 8] = S[p][2];
      dst[(size_t)(i + 1) * DH + j + 8] = S[p][3];
    }
  }
}

template <int DH, bool ALIGNED>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           float* out, float* state, int b, int s, int h, cudaStream_t st) {
  using W = Wkv<DH>;
  auto kern = wkv_kernel<DH, ALIGNED>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)W::bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(h, b), W::threads, W::bytes, st>>>(r, k, v, w, u, out, state, s, h);
  return cudaGetLastError();
}

template <int DH>
int launch_dh(const float* r, const float* k, const float* v, const float* w, const float* u,
              float* out, float* state, int b, int s, int h, int aligned, cudaStream_t st) {
  return aligned ? launch<DH, true>(r, k, v, w, u, out, state, b, s, h, st)
                 : launch<DH, false>(r, k, v, w, u, out, state, b, s, h, st);
}

}  // namespace

// r, k, v, w, out (b, s, h, dh); u (h, dh); state (b, h, dh, dh) with
// state[b, h, i, j] = S[i][j] (key i, value j); all fp32 and contiguous.
// dh in {32, 64} (the rwkv configs' head dims); aligned != 0 when r, k, v
// and w all start on 16 bytes (the 16-byte copy path).  Grid (h, b), 4 dh
// threads a block, repro_wkv_smem(dh) bytes of dynamic shared memory.
extern "C" int repro_wkv(const float* r, const float* k, const float* v, const float* w,
                         const float* u, float* out, float* state, int b, int s, int h,
                         int dh, int aligned, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return launch_dh<32>(r, k, v, w, u, out, state, b, s, h, aligned, st);
    case 64: return launch_dh<64>(r, k, v, w, u, out, state, b, s, h, aligned, st);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel's dynamic shared memory per block at head dim dh (0: no kernel).
extern "C" int repro_wkv_smem(int dh) {
  switch (dh) {
    case 32: return (int)Wkv<32>::bytes;
    case 64: return (int)Wkv<64>::bytes;
    default: return 0;
  }
}


// ---------------------------------------------------------------------------
// The backward: dr, dk, dv, dw, du of the same recurrence, given dO.
//
// Nothing of the TPU package is its twin: repro/kernels/wkv has no backward,
// and the JAX package's training differentiates its plain scan.  The port's
// training runs B11 on the card, so its gradient is a kernel too
// (kernels/wkv/ops.py wkv_train, a torch.autograd.Function).  With G_t =
// dL/dS_t (zero after the last token: the final state is not an output of
// the training call) and g_t = dO_t, the reverse form is
//   G_{t-1} = diag(w_t) G_t + r_t g_t^T,   a_t = v_t . g_t,
//   dr_t = S_{t-1} g_t + u k_t a_t,   dk_t = G_t v_t + r_t u a_t,
//   dv_t = G_t^T k_t + g_t b_t (b_t the bonus score),
//   dw_t = rowsum(G_t o S_{t-1}),     du = sum_b sum_t r_t k_t a_t.
//
// Bound on an H100: 36 B H S dh bytes (r, k, v, w, dO read once; dr, dk,
//   dv, dw written once) against ~10 B H S dh^2 FLOPs of the reverse form:
//   the bytes bound it (0.0902 ms at rwkv6's training shape, B=4, S=1024,
//   32 heads of 64).  A walk token by token cannot get near it: every token
//   is a dependent step through a dh x dh state.
//
// Design: the chunked form of the reverse recurrence, the mirror of the
//   forward's, chunks of kC = 16 tokens walked from the last, with G = dL/dS
//   carried backward across chunks by one product a chunk:
//     G_start = diag(Pall) G_end + (r o Pex)^T g.
//   - Rows i of S and G evolve independently given w[i], r[i], k[i] and all
//     of v and g, so a block owns kI = 32 key rows of one (batch, head):
//     dh / 32 blocks a head (two at dh 64: 256 blocks at rwkv6's training
//     shape, two an SM).  dr, dk, dw and du are then row-local and final;
//     dv = sum_i G[i] k[i] is a sum over the blocks, written per block and
//     summed in block order by a last launch.  (Splitting the value columns
//     instead would leave dr, dk and dw partial, three arrays to sum, and
//     every block would form the whole chunk's scores.)
//   - Per chunk of n tokens, with S0 the state before it (saved by a first
//     launch, wkv_states_kernel) and G_end from the chunk after it, the
//     tensor-core products (mma.sync m16n8k8 TF32, 3xTF32 split as in the
//     forward) are X = g S0^T, Y = v G_end^T, B = g v^T (C x C), dv's
//     kS G_end + A^T g (A: the block's rows' share of the forward's scores,
//     bonus on the diagonal, formed by the forward's prep_chunk) and the G
//     update, whose accumulators start from diag(Pall) G_end.
//   - What remains is per row i and needs no other row: over the chunk's
//     tokens t, two recursions, Q[s] <- w_t Q[s] + k_t B[s][t] (from X[s])
//     and Z <- w_t Z + k_t Y_t (from c0 = rowsum(G_end o S0)), and an upward
//     walk h = prod_{t<u<s} w_u:
//       dr_t = Q[t] + u k_t a_t,  dk_t = Sfx_t Y_t + sum_{s>t} h r_s B[s][t] + r_t u a_t,
//       dw_t = Sfx_t Z + sum_{s>t} h r_s Q[s]   (Sfx_t = the walk's last h).
//     Every decay factor is a product of w's inside the chunk; dw_t's
//     factors leave w_t out (Q holds the factors before t, h those after),
//     so w = 0 needs no care: nothing is divided by w or by a product of w.
//     Four threads per row take the tokens t = 0, 1, 2, 3 mod 4.
//   - Two prep warps turn chunk c's r, k, w into the forward's operands
//     (r Pex, k Sfx, Pall, the scores) while four consumer warps run chunk
//     c + 1's products (G double-buffered in shared memory, so that each
//     warp takes its share of every product) and then its walks; r, k, w
//     arrive by cp.async in three raw stages (loading, prepared, walked),
//     v, g and S0 in two.  Two blocks an SM (168 registers a thread).
//   - The chunk-start states come from wkv_states_kernel, a block per 32
//     rows and 16 columns of a head's state: 134 MB at rwkv6's training
//     shape, half the former every-8-token scratch.
//   Every sum has a fixed order and no float atomics are used: the same bits
//   on every run.
// Measured (chip_smoke phase 12, H100 80GB HBM3, 700 W): 0.5515 ms at
//   rwkv6's training shape (the sequential kernel 2.7259 before); by launch
//   (tools/wkv_bwd_ablate.py, which also times the reverse pass with parts
//   switched off) the states 0.108 ms, their 268 MB of traffic near the
//   memory's rate, the reverse pass 0.410, dv's sum 0.033.  The reverse pass
//   is bound by its consumer warps' dependent chains, the walks first, then
//   the products' 3xTF32 mma.sync sequences; the prep warps hide behind
//   them.
namespace wkvb {

constexpr int kI = 32;                 // key rows of a block
constexpr int kCP = Wkv<kI>::P;        // padded row of the r, k, w slices (40)
constexpr int kXP = kI + 4;            // padded row of X and Y
constexpr int kBP = 20;                // padded row of B

template <int DH>
struct Bwd {
  static constexpr int NS = DH / kI;                  // blocks a head
  static constexpr int NT = DH / 8;                   // 8-column tiles of v, g, G
  static constexpr int VP = DH + 8;                   // padded row of v, g, S0, G
  static constexpr int threads = 192;                 // 2 prep warps, 4 consumer warps
  static constexpr int rkw = 3 * Wkv<kI>::tile;       // a raw stage: r, k, w
  static constexpr int cons = 2 * kC * VP + kI * VP;  // a consumer stage: v, g, S0
  static constexpr int floats = kRaw * rkw + 2 * cons + 2 * Wkv<kI>::stage + Wkv<kI>::cross +
                                kI /* u */ + 2 * kI * VP /* G, two buffers */ +
                                2 * kC * kXP /* X, Y */ + kC * kBP /* B */ + kI /* c0 */ +
                                4 * kI /* du */;
  static constexpr size_t bytes = sizeof(float) * floats;
  // the first launch: 16 value columns a block, three stages of the k, w
  // slices and those columns of v (2 chunks loading ahead), then k Sfx, Pall
  static constexpr int NJ = DH / 16;
  static constexpr int st_stage = 2 * kC * kCP + kC * 24;
  static constexpr size_t st_bytes = sizeof(float) * (3 * st_stage + kC * kCP + kI);
};

__device__ __forceinline__ void bar_cons() {
  asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

__device__ __forceinline__ void split4(float x0, float x1, float x2, float x3, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(x0, big[0], small[0]);
  split(x1, big[1], small[1]);
  split(x2, big[2], small[2]);
  split(x3, big[3], small[3]);
}

// A chunk's slices of `nsrc` (B, S, H, DH) tensors (columns [col, col + kI)
// of a token row) into tiles of kC rows of kCP floats at dst; rows past n
// are filled with fill[a].  One cp.async group, by `nt` threads from t0.
template <int NSRC>
__device__ __forceinline__ void load_slices(float* dst, const float* const (&src)[NSRC],
                                            const float (&fill)[NSRC], size_t base, size_t tok,
                                            int n, int tid, int nt) {
  constexpr int row = kI / 4;
#pragma unroll
  for (int a = 0; a < NSRC; ++a)
    for (int e = tid; e < kC * row; e += nt) {
      const int t = e / row, d = (e % row) * 4;
      float* to = dst + a * kC * kCP + t * kCP + d;
      if (t < n) {
        repro::cp_async16(smem_addr(to), src[a] + base + (size_t)t * tok + d);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) to[q] = fill[a];
      }
    }
}

// A chunk's rows of v and g (all DH columns, zero past n) into tiles of kC
// rows of VP floats at dst.
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* v, const float* g, size_t base,
                                          size_t tok, int n, int tid, int nt) {
  constexpr int VP = Bwd<DH>::VP, row = DH / 4;
  for (int e = tid; e < 2 * kC * row; e += nt) {
    const int a = e / (kC * row), t = (e / row) % kC, d = (e % row) * 4;
    const float* src = a == 0 ? v : g;
    const bool ok = t < n;
    repro::cp_async16(smem_addr(dst + a * kC * VP + t * VP + d),
                      ok ? src + base + (size_t)t * tok + d : src, ok);
  }
}

// First launch: the state S0 at the start of every chunk, for the block's
// kI rows and 16 of the DH columns, into states (B, H, NS, nch, kI, DH).
// Two warps, each holding 16 rows of S in MMA accumulators: S <- diag(Pall)
// S + (k Sfx)^T v per chunk, Sfx and Pall running products of w by one
// thread a row.  Rows and columns of S evolve independently, so a head's
// state is split over NS x NJ blocks: enough loads in flight to stream the
// states out at the memory's rate.
template <int DH>
__global__ void __launch_bounds__(64)
wkv_states_kernel(const float* __restrict__ k, const float* __restrict__ w,
                  const float* __restrict__ v, float* __restrict__ states, int s, int h) {
  using C = Bwd<DH>;
  constexpr int VJ = 24;                             // padded row of v's 16 columns
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* kd = sm + 3 * C::st_stage;                  // k Sfx [t][i]
  float* pall = kd + kC * kCP;
  const int jb = blockIdx.x % C::NJ, is = (blockIdx.x / C::NJ) % C::NS;
  const int hh = blockIdx.x / (C::NJ * C::NS), b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int nch = (s + kC - 1) / kC;
  const size_t tok = (size_t)h * DH;
  const size_t head0 = (size_t)b * s * tok + (size_t)hh * DH;
  float* out = states + ((size_t)(b * h + hh) * C::NS + is) * nch * kI * DH + 16 * jb;

  auto load = [&](int c) {
    float* stg = sm + (c % 3) * C::st_stage;
    const int n = min(kC, s - c * kC);
    const float* const src[2] = {k, w};
    const float fill[2] = {0.f, 1.f};
    load_slices<2>(stg, src, fill, head0 + (size_t)c * kC * tok + kI * is, tok, n, threadIdx.x, 64);
    const int t = threadIdx.x >> 2, d = (threadIdx.x & 3) * 4;   // 16 rows of 4 copies
    const bool ok = t < n;
    repro::cp_async16(smem_addr(stg + 2 * kC * kCP + t * VJ + d),
                      ok ? v + head0 + (size_t)(c * kC + t) * tok + 16 * jb + d : v, ok);
    repro::cp_async_commit();
  };

  float S[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n) S[n][0] = S[n][1] = S[n][2] = S[n][3] = 0.f;
  const int i0 = 16 * warp + gid;
  load(0);
  if (nch > 1) load(1);
  else repro::cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    if (c + 2 < nch) load(c + 2);
    else repro::cp_async_commit();
    repro::cp_async_wait<2>();
    __syncthreads();
    const float* K = sm + (c % 3) * C::st_stage;
    const float* Wt = K + kC * kCP;
    const float* V = K + 2 * kC * kCP;
    if (threadIdx.x < kI) {
      const int i = threadIdx.x;
      float back = 1.f;
#pragma unroll
      for (int t = kC - 1; t >= 0; --t) {
        kd[t * kCP + i] = K[t * kCP + i] * back;
        back *= Wt[t * kCP + i];
      }
      pall[i] = back;
    }
    float* dst = out + (size_t)c * kI * DH;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      *reinterpret_cast<float2*>(dst + (size_t)i0 * DH + 8 * n + 2 * tig) = make_float2(S[n][0], S[n][1]);
      *reinterpret_cast<float2*>(dst + (size_t)(i0 + 8) * DH + 8 * n + 2 * tig) =
          make_float2(S[n][2], S[n][3]);
    }
    __syncthreads();
    const float pl = pall[i0], ph = pall[i0 + 8];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      S[n][0] *= pl; S[n][1] *= pl; S[n][2] *= ph; S[n][3] *= ph;
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* a0 = kd + (8 * kk + tig) * kCP + 16 * warp + gid;
      uint32_t ab[4], as[4];
      split4(a0[0], a0[8], a0[4 * kCP], a0[4 * kCP + 8], ab, as);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float* b0 = V + (8 * kk + tig) * VJ + 8 * n + gid;
        uint32_t bb[2], bs[2];
        split2(b0[0], b0[4 * VJ], bb, bs);
        mma3(S[n], ab, as, bb, bs);
      }
    }
    __syncthreads();                   // kd and pall are consumed
  }
}

template <int DH>
__global__ void __launch_bounds__(Bwd<DH>::threads, 2)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ dout,
               const float* __restrict__ states, float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dw, float* __restrict__ dv_part, float* __restrict__ du_part,
               int bsz, int s, int h) {
  using Wk = Wkv<kI>;
  using C = Bwd<DH>;
  constexpr int VP = C::VP, NS = C::NS;
  constexpr int NC = C::threads - 64;                // consumer threads
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);      // kRaw stages of r, k, w
  float* cons = raw + kRaw * C::rkw;                 // 2 stages of v, g, S0
  float* ops = cons + 2 * C::cons;                   // 2 operand stages
  float* cross = ops + 2 * Wk::stage;
  float* su = cross + Wk::cross;
  float* sG = su + kI;                               // 2 buffers of G [i][j]
  float* sX = sG + 2 * kI * VP;                      // X [t][i]
  float* sY = sX + kC * kXP;                         // Y [t][i]
  float* sB = sY + kC * kXP;                         // B [t][s]
  float* sc0 = sB + kC * kBP;
  float* sdu = sc0 + kI;

  const int is = blockIdx.x % NS, hh = blockIdx.x / NS, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const bool is_prep = warp < 2;
  const int cw = warp - 2;                           // consumer warp 0 .. 3
  const int ct = threadIdx.x - 64;                   // consumer thread
  const int nch = (s + kC - 1) / kC;
  const size_t tok = (size_t)h * DH;
  const size_t head0 = (size_t)b * s * tok + (size_t)hh * DH;
  const float* st_bh = states + ((size_t)(b * h + hh) * NS + is) * nch * kI * DH;

  for (int e = threadIdx.x; e < 2 * kC * kPA; e += C::threads) {
    Stage<kI> st(ops + (e / (kC * kPA)) * Wk::stage);
    st.ab[e % (kC * kPA)] = 0u;
    st.as[e % (kC * kPA)] = 0u;
  }
  for (int e = threadIdx.x; e < kI * VP; e += C::threads) sG[e] = 0.f;   // G after the last token
  auto n_of = [&](int c) { return min(kC, s - c * kC); };
  auto load_rkw = [&](int c, int slot) {            // prep threads
    const float* const src[3] = {r, k, w};
    const float fill[3] = {0.f, 0.f, 1.f};
    load_slices<3>(raw + slot * C::rkw, src, fill, head0 + (size_t)c * kC * tok + kI * is, tok,
                   n_of(c), threadIdx.x, 64);
    repro::cp_async_commit();
  };
  auto load_cons = [&](int c, int slot) {           // consumer threads
    float* dst = cons + slot * C::cons;
    load_rows<DH>(dst, v, dout, head0 + (size_t)c * kC * tok, tok, n_of(c), ct, NC);
    const float* s0 = st_bh + (size_t)c * kI * DH;
    constexpr int row = DH / 4;
    for (int e = ct; e < kI * row; e += NC) {
      const int i = e / row, d = (e % row) * 4;
      repro::cp_async16(smem_addr(dst + 2 * kC * VP + i * VP + d), s0 + (size_t)i * DH + d);
    }
    repro::cp_async_commit();
  };
  if (is_prep) {
    if (threadIdx.x < kI) su[threadIdx.x] = u[(size_t)hh * DH + kI * is + threadIdx.x];
    load_rkw(nch - 1, 0);
  } else {
    load_cons(nch - 1, 0);
  }
  __syncthreads();
  float du_acc = 0.f;

  // iteration it: the prep warps prepare chunk nch - 1 - it; the consumer
  // warps consume chunk nch - it, prepared in iteration it - 1
  for (int it = 0; it <= nch; ++it) {
    if (is_prep) {
      if (it < nch) {
        const int c = nch - 1 - it;
        repro::cp_async_wait<0>();                   // chunk c has landed (own copies)
        bar_prep(64);                                // ... and every prep thread's
        if (c > 0) load_rkw(c - 1, (it + 1) % kRaw);
        prep_chunk<kI, 2>(raw + (it % kRaw) * C::rkw, Stage<kI>(ops + (it & 1) * Wk::stage),
                          cross, su, threadIdx.x);
      }
    } else if (it > 0) {
      const int c = nch - it, n = n_of(c), t0 = c * kC;
      if (c > 0) load_cons(c - 1, it & 1);
      else repro::cp_async_commit();                 // an empty group keeps the count
      repro::cp_async_wait<1>();                     // chunk c's v, g, S0 (own copies)
      bar_cons();                                    // ... and the other consumer warps'
      const float* R = raw + ((it - 1) % kRaw) * C::rkw;
      const float* Kr = R + Wk::tile;
      const float* Wr = R + 2 * Wk::tile;
      Stage<kI> op(ops + ((it - 1) & 1) * Wk::stage);
      const float* V = cons + ((it - 1) & 1) * C::cons;
      const float* Gt = V + kC * VP;                 // dO
      const float* S0 = V + 2 * kC * VP;
      const float* Ge = sG + ((it - 1) & 1) * kI * VP;   // G_end of chunk c
      float* Gs = sG + (it & 1) * kI * VP;               // G_start of chunk c

      // c0 = rowsum(G_end o S0): four threads a row, a quarter of the columns each
      {
        const int i = ct >> 2, j0 = (ct & 3) * (DH / 4);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < DH / 4; j += 4) {
          const float4 a = *reinterpret_cast<const float4*>(Ge + i * VP + j0 + j);
          const float4 bb = *reinterpret_cast<const float4*>(S0 + i * VP + j0 + j);
          acc = repro::dot4(a, bb, acc);
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if ((ct & 3) == 0) sc0[i] = acc;
      }

      // Y = v G_end^T (warps 0, 1) or X = g S0^T and B = g v^T (warps 2, 3):
      // (t x i) tiles 2 (cw & 1), 2 (cw & 1) + 1; B's (t x s) tile cw & 1;
      // k-steps over the value columns j
      {
        const bool is_y = cw < 2;
        const float* A = is_y ? V : Gt;              // v or g rows
        const float* Bm = is_y ? Ge : S0;            // G_end or S0 rows i
        float acc[2][4] = {}, bq[4] = {};
#pragma unroll
        for (int kk = 0; kk < DH / 8; ++kk) {
          const float* a0 = A + gid * VP + 8 * kk + tig;
          uint32_t ab[4], as[4], bb[2], bs[2];
          split4(a0[0], a0[8 * VP], a0[4], a0[8 * VP + 4], ab, as);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float* b0 = Bm + (8 * (2 * (cw & 1) + q) + gid) * VP + 8 * kk + tig;
            split2(b0[0], b0[4], bb, bs);
            mma3(acc[q], ab, as, bb, bs);
          }
          if (!is_y) {
            const float* b0 = V + (8 * (cw & 1) + gid) * VP + 8 * kk + tig;
            split2(b0[0], b0[4], bb, bs);
            mma3(bq, ab, as, bb, bs);
          }
        }
        float* out = is_y ? sY : sX;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = 8 * (2 * (cw & 1) + q) + 2 * tig;
          *reinterpret_cast<float2*>(out + gid * kXP + i) = make_float2(acc[q][0], acc[q][1]);
          *reinterpret_cast<float2*>(out + (gid + 8) * kXP + i) = make_float2(acc[q][2], acc[q][3]);
        }
        if (!is_y) {
          const int sc = 8 * (cw & 1) + 2 * tig;
          *reinterpret_cast<float2*>(sB + gid * kBP + sc) = make_float2(bq[0], bq[1]);
          *reinterpret_cast<float2*>(sB + (gid + 8) * kBP + sc) = make_float2(bq[2], bq[3]);
        }
      }

      // dv's share of this block, kS G_end + A^T g: value tiles 2 cw, 2 cw + 1
      {
        uint32_t kb[4][4], ks[4][4], tb[2][4], ts[2][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* a0 = op.kd + gid * kCP + 8 * kk + tig;
          split4(a0[0], a0[8 * kCP], a0[4], a0[8 * kCP + 4], kb[kk], ks[kk]);
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int o = (8 * kk + tig) * kPA + gid;
          tb[kk][0] = op.ab[o]; tb[kk][1] = op.ab[o + 8];
          tb[kk][2] = op.ab[o + 4 * kPA]; tb[kk][3] = op.ab[o + 4 * kPA + 8];
          ts[kk][0] = op.as[o]; ts[kk][1] = op.as[o + 8];
          ts[kk][2] = op.as[o + 4 * kPA]; ts[kk][3] = op.as[o + 4 * kPA + 8];
        }
        float* dvp = dv_part + (size_t)is * bsz * s * tok + head0 + (size_t)t0 * tok;
#pragma unroll
        for (int q = 0; q < DH / 32; ++q) {
          const int nn = (DH / 32) * cw + q;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float* b0 = Ge + (8 * kk + tig) * VP + 8 * nn + gid;
            uint32_t bb[2], bs[2];
            split2(b0[0], b0[4 * VP], bb, bs);
            mma3(d, kb[kk], ks[kk], bb, bs);
          }
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            const float* b0 = Gt + (8 * kk + tig) * VP + 8 * nn + gid;
            uint32_t bb[2], bs[2];
            split2(b0[0], b0[4 * VP], bb, bs);
            mma3(d, tb[kk], ts[kk], bb, bs);
          }
          const int j = 8 * nn + 2 * tig;
          if (gid < n) *reinterpret_cast<float2*>(dvp + (size_t)gid * tok + j) = make_float2(d[0], d[1]);
          if (gid + 8 < n)
            *reinterpret_cast<float2*>(dvp + (size_t)(gid + 8) * tok + j) = make_float2(d[2], d[3]);
        }
      }

      // G_start = diag(Pall) G_end + (r Pex)^T g: rows 16 (cw >> 1) + [0, 16),
      // value tiles (cw & 1) DH / 16 + [0, DH / 16)
      {
        constexpr int NQ = DH / 16;
        const int i0 = 16 * (cw >> 1) + gid;
        const float pl = op.pall[i0], ph = op.pall[i0 + 8];
        float g4[NQ][4];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int j = 8 * ((cw & 1) * NQ + q) + 2 * tig;
          const float2 lo = *reinterpret_cast<const float2*>(Ge + i0 * VP + j);
          const float2 hi = *reinterpret_cast<const float2*>(Ge + (i0 + 8) * VP + j);
          g4[q][0] = lo.x * pl; g4[q][1] = lo.y * pl; g4[q][2] = hi.x * ph; g4[q][3] = hi.y * ph;
        }
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const float* a0 = op.rd + (8 * kk + tig) * kCP + i0;
          uint32_t ab[4], as[4];
          split4(a0[0], a0[8], a0[4 * kCP], a0[4 * kCP + 8], ab, as);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const float* b0 = Gt + (8 * kk + tig) * VP + 8 * ((cw & 1) * NQ + q) + gid;
            uint32_t bb[2], bs[2];
            split2(b0[0], b0[4 * VP], bb, bs);
            mma3(g4[q], ab, as, bb, bs);
          }
        }
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int j = 8 * ((cw & 1) * NQ + q) + 2 * tig;
          *reinterpret_cast<float2*>(Gs + i0 * VP + j) = make_float2(g4[q][0], g4[q][1]);
          *reinterpret_cast<float2*>(Gs + (i0 + 8) * VP + j) = make_float2(g4[q][2], g4[q][3]);
        }
      }
      bar_cons();                                    // sX, sY, sB, sc0

      // the walks of row il, tokens t = cw mod 4 (one copy of the code for
      // the four: a copy per parity, pruned, ran slower)
      {
        const int il = lane, par = cw;
        float rr[kC], kk_[kC], ww[kC], yy[kC], q[kC];
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          rr[t] = R[t * kCP + il];
          kk_[t] = Kr[t * kCP + il];
          ww[t] = Wr[t * kCP + il];
          yy[t] = sY[t * kXP + il];
          q[t] = sX[t * kXP + il];
        }
        const float ui = su[il];
        float z = sc0[il];
        const size_t col = head0 + (size_t)t0 * tok + kI * is + il;
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          float bc[kC];
#pragma unroll
          for (int s2 = t + 1; s2 < kC; ++s2) bc[s2] = sB[s2 * kBP + t];
          const float at = sB[t * kBP + t];
          if ((t & 3) == par) {
            float hw = 1.f, ak = 0.f, aw = 0.f;
#pragma unroll
            for (int s2 = t + 1; s2 < kC; ++s2) {
              const float hr = hw * rr[s2];
              ak = fmaf(hr, bc[s2], ak);
              aw = fmaf(hr, q[s2], aw);
              hw *= ww[s2];
            }
            if (t < n) {
              const size_t o = col + (size_t)t * tok;
              dr[o] = fmaf(ui * kk_[t], at, q[t]);
              dk[o] = fmaf(rr[t] * ui, at, fmaf(hw, yy[t], ak));
              dw[o] = fmaf(hw, z, aw);
            }
            du_acc = fmaf(rr[t] * kk_[t], at, du_acc);
          }
          z = fmaf(ww[t], z, kk_[t] * yy[t]);
#pragma unroll
          for (int s2 = t + 1; s2 < kC; ++s2) q[s2] = fmaf(ww[t], q[s2], kk_[t] * bc[s2]);
        }
      }
    }
    __syncthreads();
  }
  if (!is_prep) {
    sdu[cw * kI + lane] = du_acc;
    bar_cons();
    if (cw == 0)
      du_part[((size_t)b * h + hh) * DH + kI * is + lane] =
          ((sdu[lane] + sdu[kI + lane]) + sdu[2 * kI + lane]) + sdu[3 * kI + lane];
  }
}

// dv = the blocks' shares summed in block order (float4 at a time); du =
// du_part summed over the batch in order.
template <int NS>
__global__ void wkv_bwd_finish_kernel(const float4* __restrict__ dv_part, float4* __restrict__ dv,
                                      size_t n4, const float* __restrict__ du_part,
                                      float* __restrict__ du, int bsz, int hdh) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n4) {
    float4 acc = dv_part[e];
#pragma unroll
    for (int q = 1; q < NS; ++q) {
      const float4 x = dv_part[(size_t)q * n4 + e];
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    dv[e] = acc;
  } else if (e - n4 < (size_t)hdh) {
    const int j = (int)(e - n4);
    float acc = 0.f;
    for (int q = 0; q < bsz; ++q) acc += du_part[(size_t)q * hdh + j];
    du[j] = acc;
  }
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u,
           const float* dout, float* states, float* dv_part, float* du_part, float* dr, float* dk,
           float* dv, float* dw, float* du, int b, int s, int h, cudaStream_t st) {
  using C = Bwd<DH>;
  auto* skern = wkv_states_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(skern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::st_bytes);
  if (err != cudaSuccess) return err;
  skern<<<dim3(C::NJ * C::NS * h, b), 64, C::st_bytes, st>>>(k, w, v, states, s, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto* kern = wkv_bwd_kernel<DH>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (err != cudaSuccess) return err;
  kern<<<dim3(C::NS * h, b), C::threads, C::bytes, st>>>(r, k, v, w, u, dout, states, dr, dk, dw,
                                                        dv_part, du_part, b, s, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n4 = (size_t)b * s * h * DH / 4;
  const int hdh = h * DH;
  const size_t total = n4 + hdh;
  wkv_bwd_finish_kernel<C::NS><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(dv_part), reinterpret_cast<float4*>(dv), n4, du_part, du,
      b, hdh);
  return cudaGetLastError();
}

}  // namespace wkvb

// The backward of repro_wkv: r, k, v, w, dout, dr, dk, dv, dw (b, s, h, dh);
// u, du (h, dh); all fp32, contiguous and 16-byte aligned, dh in {32, 64}.
// Scratch: states (b, h, dh / 32, ceil(s / 16), 32, dh), dv_part (dh / 32,
// b, s, h, dh) and du_part (b, h, dh).  Three launches (the chunk-start
// states, the reverse pass, the sums of dv over row blocks and of du over
// the batch), each checked.
extern "C" int repro_wkv_bwd(const float* r, const float* k, const float* v, const float* w,
                             const float* u, const float* dout, float* states, float* dv_part,
                             float* du_part, float* dr, float* dk, float* dv, float* dw,
                             float* du, int b, int s, int h, int dh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return wkvb::launch<32>(r, k, v, w, u, dout, states, dv_part, du_part, dr, dk, dv,
                                     dw, du, b, s, h, st);
    case 64: return wkvb::launch<64>(r, k, v, w, u, dout, states, dv_part, du_part, dr, dk, dv,
                                     dw, du, b, s, h, st);
    default: return cudaErrorInvalidValue;
  }
}

// The reverse pass's dynamic shared memory per block at head dim dh (0: no kernel).
extern "C" int repro_wkv_bwd_smem(int dh) {
  switch (dh) {
    case 32: return (int)wkvb::Bwd<32>::bytes;
    case 64: return (int)wkvb::Bwd<64>::bytes;
    default: return 0;
  }
}
