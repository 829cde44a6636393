// The fused ICOA agent update (alpha = 1): one probe pass and one commit pass
// over the residual matrix R (D, N), each with an epilogue that evaluates the
// O(D^2) closed-form algebra: the commit's in fp32, the probe's (and its
// ||cross||^2) in float64, where the fp32 algebra alone moves an eta near a
// pole of the step schedule by ~1e-4 of the largest.
//
// repro_probe_sweep replaces src/repro/kernels/sweep/kernel.py
// probe_sweep_pallas (B5) and its epilogue _probe_finalize:
//   cross = s^T R (N,), p = R cross (D,), ||cross||^2, then the whole K-step
//   back-search schedule against m_inv.  cross and p are two orthogonal
//   reductions of the same tile, so R is read once.  Bound on an H100: that
//   one read of R, about 2 FMAs per 4 bytes.  Two routes, chosen by D in the
//   wrapper (kernels/sweep/ops.py::probe_route), each with one geometry that
//   depends on (D, N) and the card only:
//
//   * registers (D <= 128, the main path): a block of 8 warps takes
//     128-column strips of its chunk of N, each lane 4 adjacent columns
//     with one 16-byte load per row; warp w holds rows w, w + 8, ... in
//     registers (at most 16 float4 a lane) and issues all of them before it
//     uses any, so ~6.6 KB a warp are in flight at D=100.  Each warp writes
//     its rows' share of cross to shared memory (double-buffered, one
//     barrier a strip), every warp sums the 8 shares in warp order, and then
//     forms its rows' p from the registers against that cross; p and
//     ||cross||^2 stay in registers across the chunk.  The wrapper cuts N
//     into about one wave of chunks; each block writes one partial per row
//     and one ||cross||^2 partial, and the last block of the trial to arrive
//     (an integer counter per trial in a zeroed workspace, reset by that
//     block) sums them in chunk order and runs the closed form: one launch.
//   * shared (D > 128): each block loads a D x BN tile of R into shared
//     memory once; one thread per column forms cross (and ||cross||^2), then
//     one warp per row forms the partial p from the tile; a second, one-block
//     launch sums the partials in block order and runs the closed form.  BN
//     is chosen by the wrapper so that the tile fits the 227 KB of shared
//     memory.
//
// repro_commit_sweep replaces kernel.py commit_sweep_pallas (B7) and its
// epilogue _commit_finalize:
//   w = R delta / m and <delta, delta>, then u, z1 = m_inv[i], z2 = m_inv u,
//   the SMW pivots, obj_post, accept = (obj_post > threshold) && can_tx, and
//   the rank-2 m_inv / s update selected by accept, so a reject leaves m_inv
//   and s bitwise unchanged.  Bound: the one read of R.  One launch on
//   row_gram's streaming scheme (common.cuh, repro::stream_rows, the same
//   loop): a block of 8 warps streams a strip of N (the geometry of
//   row_gram_geometry, one wave of 1024-column strips at N = 262144), each
//   lane holding its 16-byte slices of delta in registers, and warp 0 forms
//   the strip's <delta, delta> from those registers.  Each row is an
//   independent dot product, so one kernel serves every D (rows round-robin
//   over the warps).  The partials go to a (d + 1, strips) scratch; the last
//   block of the trial to arrive folds them in strip order (repro::fold_rows)
//   and runs the epilogue in the same launch, in fp32 as the TPU kernel
//   does: z2 one warp per 8 rows, k22 and t2 by one warp, then the d^2
//   update or, on a reject, a 16-byte copy.  eta, threshold and can_tx come
//   as device tensors or by value (a Python number in the wrapper), so a
//   commit needs no host round trip and no fill launch; accept is written
//   as one byte (a torch.bool).
//
// repro_probe_sweep_batched and repro_commit_sweep_batched replace
// probe_sweep_pallas_batched (B6) and commit_sweep_pallas_batched (B8): the
// same agent update for B independent Monte-Carlo trials, every operand with
// a leading trial axis (R (B, D, N), m_inv (B, D, D), s (B, D); eta,
// threshold and can_tx (B,) device tensors, or one value for all) while
// the step schedule is shared by the batch, and agent i is too unless a
// (B,) int32 device vector gives each trial its own (a budget policy that
// orders each trial's agents; a null pointer: i for every trial, the
// by-value path).  The trial is one more grid dimension of the same kernels
// (blockIdx.y), with its own partial rows (and, on the probe's register
// route and in the commit, its own arrival counter), and a one-block
// epilogue runs per trial (the last arrival of the trial, or blockIdx.x of
// the probe's finish launch) against that trial's m_inv, s and eta.  The
// geometry depends on (D, N) and the card only.  A trial therefore sums the same blocks in the same order as the
// single-trial launch: slice b of a batched launch equals the single-trial
// launch on trial b bit for bit, and a rejected trial keeps its m_inv and s
// bitwise while its neighbours commit.  Bound: B times the one read of R.
//
// All cross-block sums are in a fixed order (no float atomics; the one
// integer atomic only picks the block that sums): the accept/reject and
// first-improving-step decisions must not flicker between runs.  The rank-2
// update forms each outer-product entry with non-contracted multiplies so
// that m_inv stays exactly symmetric.  The arrival counters assume one
// stream at a time, as the port runs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#include "common.cuh"

namespace {

constexpr int kFinishThreads = 512;
constexpr int kProbeThreads = 256;      // register route: 8 warps
constexpr int kProbeWarps = kProbeThreads / 32;
constexpr int kProbeStrip = 128;        // columns a block takes at once: 4 a lane
constexpr int kProbeMaxRows = 16;       // rows a warp holds in registers
constexpr int kProbeMaxD = kProbeWarps * kProbeMaxRows;

// ------------------------------------------------------- probe closed form
// The back-search schedule of one trial, by the whole block, from p = R cross
// (d floats of shared memory, complete before the call) and ||cross||^2.
// The algebra runs in float64: near a pole of the schedule (det -> 0) the
// fp32 algebra alone moves an eta by ~1e-4 of the largest, as much as the
// tests allow between kernel and plain version, while the sums it starts
// from are good to an ulp or two.  q is d doubles of shared scratch, red 33.
// Writes p_out = R g_unit / m, the K etas and gnorm in fp32.
__device__ __noinline__ void probe_closed_form(const float* p, double* q, double* red,
                                               double gg_cross,
                                               const float* __restrict__ minv,
                                               const float* __restrict__ s, float eta,
                                               const float* __restrict__ steps,
                                               int k_steps, int d, int i, float m,
                                               float* __restrict__ etas,
                                               float* __restrict__ p_out,
                                               float* __restrict__ gnorm_out) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int warp = t >> 5, lane = t & 31, nw = nt >> 5;
  const double s_i = s[i];
  const double scale = 2.0 * s_i / m;
  const double gnorm = sqrt(gg_cross) * fabs(scale) + 1e-30;
  const double coef = scale / (m * gnorm);                  // p_hat = coef * p
  for (int k = t; k < d; k += nt) p_out[k] = (float)(coef * p[k]);   // R g_unit / m
  // q = m_inv p_hat: a warp takes 8 rows at once, lanes over columns, so
  // the loads of 8 rows are in flight together
  constexpr int kRows = 8;
  for (int row0 = warp; row0 < d; row0 += nw * kRows) {
    double acc[kRows];
#pragma unroll
    for (int g = 0; g < kRows; ++g) acc[g] = 0.0;
#pragma unroll 4
    for (int c = lane; c < d; c += 32) {
      const double ph = coef * p[c];
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        const int row = row0 + nw * g;
        const float mv = row < d ? minv[(size_t)row * d + c] : 0.f;
        acc[g] = fma((double)mv, ph, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const double tot = repro::warp_sum(acc[g]);
      if (lane == 0 && row0 + nw * g < d) q[row0 + nw * g] = tot;
    }
  }
  double pa = 0.0, pe = 0.0;
  __syncthreads();
  for (int k = t; k < d; k += nt) {
    const double ph = coef * p[k];
    pa = fma(ph, q[k], pa);
    pe = fma(ph, (double)s[k], pe);
  }
  const double a = repro::block_sum(pa, red);               // <p_hat, q>
  const double e = repro::block_sum(pe, red);               // <p_hat, s>
  const double b = q[i];
  const double c = minv[(size_t)i * d + i];
  const double t1 = s_i;
  const double ratio = scale / gnorm;
  const double gg = ratio * ratio * gg_cross;               // <g_unit, g_unit>
  const double c2h = gg / (2.0 * m);
  for (int k = t; k < k_steps; k += nt) {
    const double st = steps[k];
    const double beta = c2h * st * st;                      // alpha = 1: c1h = 0
    const double k12 = 1.0 - st * b + beta * c;
    const double k22 = st * st * a - 2.0 * st * beta * b + beta * beta * c;
    const double t2 = -st * e + beta * t1;
    const double det = c * k22 - k12 * k12;
    etas[k] = (float)(eta - (k22 * t1 * t1 - 2.0 * k12 * t1 * t2 + c * t2 * t2) / det);
  }
  if (t == 0) gnorm_out[0] = (float)gnorm;
}

// Sum of nb fp32 partials in float64, by one warp (lanes over the
// partials, then the lanes in a fixed order); every lane returns it.
__device__ __forceinline__ double fold_f64(const float* __restrict__ part, int nb) {
  double g = 0.0;
#pragma unroll 8
  for (int b = threadIdx.x & 31; b < nb; b += 32) g += (double)__ldcg(part + b);
  return repro::warp_sum(g);
}

// ------------------------------------------------ probe, register route
template <bool ALIGNED>
__device__ __forceinline__ void store4(float* __restrict__ row, int col, int n, float4 x) {
  if constexpr (ALIGNED) {
    if (col < n) *reinterpret_cast<float4*>(row + col) = x;
  } else {
    if (col < n) row[col] = x.x;
    if (col + 1 < n) row[col + 1] = x.y;
    if (col + 2 < n) row[col + 2] = x.z;
    if (col + 3 < n) row[col + 3] = x.w;
  }
}

// Grid (chunks, trials); block kProbeThreads.  RPW = ceil(d / 8) rows a
// warp.  chunk: columns a block takes, a multiple of kProbeStrip.
// part_p: (trial, d, ncp) and part_gg: (trial, ncp) scratch, ncp = chunks
// rounded up to 4; arrivals: one int per trial, zero on entry and on exit.
template <bool ALIGNED, int RPW>
__global__ void __launch_bounds__(kProbeThreads, 2)
probe_rows_kernel(const float* __restrict__ r, const float* __restrict__ minv,
                  const float* __restrict__ s, const float* __restrict__ eta,
                  const float* __restrict__ steps, float* __restrict__ cross,
                  float* __restrict__ part_p, float* __restrict__ part_gg,
                  int* __restrict__ arrivals, float* __restrict__ etas,
                  float* __restrict__ p_out, float* __restrict__ gnorm_out, int d,
                  int n, int chunk, int k_steps, int i_all, const int* __restrict__ agents) {
  const int trial = blockIdx.y, nc = gridDim.x, ncp = (nc + 3) & ~3;
  const int i = agents ? agents[trial] : i_all;
  r += (size_t)trial * d * n;
  s += (size_t)trial * d;
  cross += (size_t)trial * n;
  part_p += (size_t)trial * d * ncp;
  part_gg += (size_t)trial * ncp;
  __shared__ float4 shares[2][kProbeWarps][32];   // each warp's share of cross
  __shared__ float p_s[kProbeMaxD];               // R cross; q, red: closed-form scratch
  __shared__ double q_s[kProbeMaxD];
  __shared__ double red[33];
  __shared__ double gg_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float sr[RPW], acc[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = warp + kProbeWarps * j;
    sr[j] = row < d ? s[row] : 0.f;
    acc[j] = 0.f;
  }
  double gg = 0.0;                                // ||cross||^2 (warp 0), float64
  const int c0 = blockIdx.x * chunk, c1 = min(c0 + chunk, n);
  int buf = 0;
  for (int c = c0; c < c1; c += kProbeStrip, buf ^= 1) {
    const int col = c + 4 * lane;
    float4 x[RPW];
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int row = warp + kProbeWarps * j;
      x[j] = row < d ? repro::load4<ALIGNED, true>(r + (size_t)row * n, col, n) : zero;
    }
    float4 cw = zero;
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      cw.x = fmaf(sr[j], x[j].x, cw.x);
      cw.y = fmaf(sr[j], x[j].y, cw.y);
      cw.z = fmaf(sr[j], x[j].z, cw.z);
      cw.w = fmaf(sr[j], x[j].w, cw.w);
    }
    shares[buf][warp][lane] = cw;
    __syncthreads();   // one barrier a strip: buf was last read two strips ago
    float4 cr = shares[buf][0][lane];
#pragma unroll
    for (int w = 1; w < kProbeWarps; ++w) {
      const float4 o = shares[buf][w][lane];
      cr.x += o.x;
      cr.y += o.y;
      cr.z += o.z;
      cr.w += o.w;
    }
    if (warp == 0) {
      store4<ALIGNED>(cross, col, n, cr);
      gg = fma((double)cr.x, (double)cr.x, gg);
      gg = fma((double)cr.y, (double)cr.y, gg);
      gg = fma((double)cr.z, (double)cr.z, gg);
      gg = fma((double)cr.w, (double)cr.w, gg);
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) acc[j] = repro::dot4(x[j], cr, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int row = warp + kProbeWarps * j;
    const float tot = repro::warp_sum(acc[j]);
    if (lane == 0 && row < d) part_p[(size_t)row * ncp + blockIdx.x] = tot;
  }
  if (warp == 0) {
    gg = repro::warp_sum(gg);
    if (lane == 0) part_gg[blockIdx.x] = (float)gg;
  }

  // the last block of this trial to arrive sums the chunks in chunk order
  if (!repro::last_to_arrive(arrivals + trial, nc)) return;
  repro::fold_rows(part_p, ncp, nc, d, p_s);
  if (warp == 0) {
    const double tot = fold_f64(part_gg, nc);
    if (lane == 0) gg_s = tot;
  }
  __syncthreads();
  probe_closed_form(p_s, q_s, red, gg_s,
                    minv + (size_t)trial * d * d, s, eta[trial], steps, k_steps, d, i,
                    (float)n, etas + (size_t)trial * k_steps, p_out + (size_t)trial * d,
                    gnorm_out + trial);
  if (threadIdx.x == 0) arrivals[trial] = 0;                // ready for the next call
}

using RowsKernel = decltype(&probe_rows_kernel<true, 1>);

template <bool ALIGNED, int... R>
RowsKernel rows_kernel(int rpw, std::integer_sequence<int, R...>) {
  static const RowsKernel table[] = {probe_rows_kernel<ALIGNED, R + 1>...};
  return table[rpw - 1];
}

// probe_rows_kernel for d rows (rpw = ceil(d / 8) <= kProbeMaxRows).
template <bool ALIGNED>
RowsKernel rows_kernel_for(int d) {
  return rows_kernel<ALIGNED>((d + kProbeWarps - 1) / kProbeWarps,
                              std::make_integer_sequence<int, kProbeMaxRows>{});
}

// -------------------------------------------------- probe, shared route
// blockDim.x = bn (a multiple of 32); dynamic shared memory holds the
// (d, bn) tile, cross for the bn columns, s, and reduction scratch.
__global__ void probe_pass_kernel(const float* __restrict__ r,
                                  const float* __restrict__ s,
                                  float* __restrict__ cross,
                                  float* __restrict__ part_p,
                                  float* __restrict__ part_gg, int d, int n) {
  extern __shared__ float smem[];
  const int bn = blockDim.x;
  // blockIdx.y is the trial: its own R, s, cross and partial rows
  r += (size_t)blockIdx.y * d * n;
  s += (size_t)blockIdx.y * d;
  cross += (size_t)blockIdx.y * n;
  part_p += (size_t)blockIdx.y * gridDim.x * d;
  part_gg += (size_t)blockIdx.y * gridDim.x;
  float* tile = smem;              // d * bn
  float* cs = tile + (size_t)d * bn;  // bn
  float* ss = cs + bn;             // d
  float* red = ss + d;             // 33
  const int t = threadIdx.x;
  for (int k = t; k < d; k += bn) ss[k] = s[k];
  __syncthreads();

  const int col = blockIdx.x * bn + t;
  const bool valid = col < n;
  float c = 0.f;
#pragma unroll 4
  for (int row = 0; row < d; ++row) {
    const float x = valid ? r[(size_t)row * n + col] : 0.f;
    tile[(size_t)row * bn + t] = x;
    c = fmaf(ss[row], x, c);
  }
  cs[t] = c;
  if (valid) cross[col] = c;
  const float gg = repro::block_sum(c * c, red);  // also orders cs/tile writes
  if (t == 0) part_gg[blockIdx.x] = gg;

  const int warp = t >> 5, lane = t & 31, nw = bn >> 5;
  for (int row = warp; row < d; row += nw) {
    const float* tr = tile + (size_t)row * bn;
    float acc = 0.f;
    for (int q = lane; q < bn; q += 32) acc = fmaf(tr[q], cs[q], acc);
    acc = repro::warp_sum(acc);
    if (lane == 0) part_p[(size_t)blockIdx.x * d + row] = acc;
  }
}

// One block of kFinishThreads per trial (blockIdx.x).  Dynamic shared
// memory: q (d doubles), red (33 doubles), gg (1 double), p (d floats).
__global__ void __launch_bounds__(kFinishThreads)
probe_finish_kernel(const float* __restrict__ part_p,
                    const float* __restrict__ part_gg, int nb,
                    const float* __restrict__ minv,
                    const float* __restrict__ s,
                    const float* __restrict__ eta,
                    const float* __restrict__ steps, int k_steps, int d,
                    int i_all, const int* __restrict__ agents, float m,
                    float* __restrict__ etas, float* __restrict__ p_out,
                    float* __restrict__ gnorm_out) {
  extern __shared__ double smem_d[];
  const size_t b_ = blockIdx.x;                             // the trial
  const int i = agents ? agents[b_] : i_all;
  part_p += b_ * nb * d;
  part_gg += b_ * nb;
  double* q = smem_d;
  double* red = q + d;
  double* gg = red + 33;
  float* p = reinterpret_cast<float*>(gg + 1);
  const int t = threadIdx.x, warp = t >> 5, nw = kFinishThreads >> 5;

  repro::reduce_partials(part_p, nb, d, 1.f, p, warp, nw);  // R cross
  if (warp == 0) {
    const double tot = fold_f64(part_gg, nb);
    if ((t & 31) == 0) gg[0] = tot;
  }
  __syncthreads();
  probe_closed_form(p, q, red, gg[0], minv + b_ * d * d, s + b_ * d, eta[b_], steps,
                    k_steps, d, i, m, etas + b_ * k_steps, p_out + b_ * d,
                    gnorm_out + b_);
}

// ------------------------------------------------------------------ commit
// Dynamic shared memory of the commit kernel for d rows: u (d + 1 floats:
// the folded w, then <delta, delta>), z1 (d) and z2 (d).
size_t commit_shared_bytes(int d) { return (3 * (size_t)d + 1) * sizeof(float); }

// The commit's pivots, formed by warp 0 of the epilogue and read by the block.
struct CommitPivots {
  float k11, k12, k22, det, t1, t2;
  bool accept;
};

// The commit epilogue of one trial, by the whole block, once the strips'
// partials are complete: part (d + 1, nbp), rows k < d the partial w_k of
// each strip, row d the partial <delta, delta>.  minv, s and the outputs
// are the trial's own.
__device__ __noinline__ void commit_epilogue(
    const float* __restrict__ part, int nbp, int nb, const float* __restrict__ minv,
    const float* __restrict__ s, float eta, float threshold, bool can_tx, int d, int i,
    float m, float diag_keep, float diag_add, float* __restrict__ minv_out,
    float* __restrict__ s_out, float* __restrict__ u_out, bool* __restrict__ accept_out,
    float* __restrict__ obj_out) {
  extern __shared__ float smem[];
  float* u = smem;          // d + 1
  float* z1 = u + d + 1;    // d
  float* z2 = z1 + d;       // d
  __shared__ CommitPivots pv;
  const int t = threadIdx.x, nt = blockDim.x, warp = t >> 5, lane = t & 31, nw = nt >> 5;

  repro::fold_rows(part, nbp, nb, d + 1, u);                // R delta, <delta, delta>
  for (int k = t; k < d; k += nt) z1[k] = minv[(size_t)i * d + k];   // m_inv e_i (symmetric)
  __syncthreads();
  const float dd_auto = u[d] / (2.0f * m);
  for (int k = t; k < d; k += nt) {
    const float w = u[k] / m;
    u[k] = k == i ? diag_keep * (w + dd_auto) + diag_add : w;
  }
  __syncthreads();
  // z2 = m_inv u: a warp takes 8 rows at once, lanes over columns, so the
  // loads of 8 rows are in flight together
  constexpr int kRows = 8;
  for (int row0 = warp; row0 < d; row0 += nw * kRows) {
    float acc[kRows];
#pragma unroll
    for (int g = 0; g < kRows; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int c = lane; c < d; c += 32) {
      const float uc = u[c];
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        const int row = row0 + nw * g;
        acc[g] = fmaf(row < d ? __ldg(minv + (size_t)row * d + c) : 0.f, uc, acc[g]);
      }
    }
#pragma unroll
    for (int g = 0; g < kRows; ++g) {
      const float tot = repro::warp_sum(acc[g]);
      if (lane == 0 && row0 + nw * g < d) z2[row0 + nw * g] = tot;
    }
  }
  __syncthreads();
  if (warp == 0) {              // k22 = <u, z2> and t2 = <u, s> in one pass of one warp
    float p22 = 0.f, pt2 = 0.f;
    for (int k = lane; k < d; k += 32) {
      p22 = fmaf(u[k], z2[k], p22);
      pt2 = fmaf(u[k], s[k], pt2);
    }
    const float k22 = repro::warp_sum(p22), t2 = repro::warp_sum(pt2);
    if (lane == 0) {
      const float k11 = z1[i], k12 = 1.0f + z2[i], t1 = s[i];
      const float det = k11 * k22 - k12 * k12;
      const float obj = eta - (k22 * t1 * t1 - 2.0f * k12 * t1 * t2 + k11 * t2 * t2) / det;
      const bool accept = obj > threshold && can_tx;
      pv = {k11, k12, k22, det, t1, t2, accept};
      *obj_out = obj;
      *accept_out = accept;
    }
  }
  __syncthreads();

  const CommitPivots p = pv;
  const int dd = d * d;
  const bool vec = (dd & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(minv) | reinterpret_cast<uintptr_t>(minv_out)) &
                    15) == 0;
  const float4* in4 = reinterpret_cast<const float4*>(minv);
  float4* out4 = reinterpret_cast<float4*>(minv_out);
  if (p.accept) {
    // m_inv' = m_inv - corr, each product of an outer-product term formed
    // alone (no FMA contraction), so that entry (a, b) and entry (b, a) get
    // the same bits
    auto updated = [&](int idx, float x) {
      const int ra = idx / d, cb = idx - ra * d;
      const float o11 = __fmul_rn(z1[ra], z1[cb]);
      const float o12 = __fadd_rn(__fmul_rn(z1[ra], z2[cb]), __fmul_rn(z2[ra], z1[cb]));
      const float o22 = __fmul_rn(z2[ra], z2[cb]);
      return x - (p.k22 * o11 - p.k12 * o12 + p.k11 * o22) / p.det;
    };
    if (vec) {
#pragma unroll 4
      for (int q = t; q < dd / 4; q += nt) {
        float4 x = __ldg(in4 + q);
        x.x = updated(4 * q, x.x);
        x.y = updated(4 * q + 1, x.y);
        x.z = updated(4 * q + 2, x.z);
        x.w = updated(4 * q + 3, x.w);
        out4[q] = x;
      }
    } else {
      for (int idx = t; idx < dd; idx += nt) minv_out[idx] = updated(idx, __ldg(minv + idx));
    }
    const float c1 = (p.k22 * p.t1 - p.k12 * p.t2) / p.det;
    const float c2 = (p.k11 * p.t2 - p.k12 * p.t1) / p.det;
    for (int k = t; k < d; k += nt) {
      s_out[k] = s[k] - c1 * z1[k] - c2 * z2[k];
      u_out[k] = u[k];
    }
  } else {                      // a reject: m_inv and s copied bit for bit
    if (vec) {
#pragma unroll 4
      for (int q = t; q < dd / 4; q += nt) out4[q] = __ldg(in4 + q);
    } else {
      for (int idx = t; idx < dd; idx += nt) minv_out[idx] = __ldg(minv + idx);
    }
    for (int k = t; k < d; k += nt) {
      s_out[k] = s[k];
      u_out[k] = 0.f;
    }
  }
}

// Grid (strips, trials), block repro::kStreamThreads, dynamic shared memory
// commit_shared_bytes(d).  strip: columns a block streams, a multiple of 128
// of at most 1024.  part: (trial, d + 1, nbp) scratch, nbp = strips rounded
// up to 4; arrivals: one int per trial, zero on entry and on exit.  A null
// eta_p / threshold_p / can_tx_p / diag_keep_p / diag_add_p means the value
// after it, for every trial; a null agents means agent i_all for every
// trial, else trial b updates agent agents[b].
template <bool ALIGNED>
__global__ void __launch_bounds__(repro::kStreamThreads, 2)
commit_kernel(const float* __restrict__ r, const float* __restrict__ delta,
              const float* __restrict__ minv, const float* __restrict__ s,
              const float* __restrict__ eta_p, float eta,
              const float* __restrict__ threshold_p, float threshold,
              const float* __restrict__ can_tx_p, int can_tx, float* __restrict__ part,
              int* __restrict__ arrivals, float* __restrict__ minv_out,
              float* __restrict__ s_out, float* __restrict__ u_out,
              bool* __restrict__ accept_out, float* __restrict__ obj_out, int d, int n,
              int strip, int i_all, const int* __restrict__ agents,
              const float* __restrict__ diag_keep_p, float diag_keep,
              const float* __restrict__ diag_add_p, float diag_add) {
  const int trial = blockIdx.y, nb = gridDim.x, nbp = (nb + 3) & ~3;
  const int i = agents ? agents[trial] : i_all;
  r += (size_t)trial * d * n;
  delta += (size_t)trial * n;
  part += (size_t)trial * (d + 1) * nbp;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * strip + 4 * lane;            // this lane's first column
  const int slices = strip / 128;

  float4 dr[repro::kStreamSlices];
  repro::load_strip<ALIGNED>(delta, col, slices, n, dr);
  repro::stream_rows<ALIGNED>(r, dr, col, slices, d, n, part, nbp);   // R delta
  if (threadIdx.x < 32) {       // <delta, delta> from the registers, no extra read
    float dd = 0.f;
#pragma unroll
    for (int q = 0; q < repro::kStreamSlices; ++q) dd = repro::dot4(dr[q], dr[q], dd);
    dd = repro::warp_sum(dd);
    if (lane == 0) part[(size_t)d * nbp + blockIdx.x] = dd;
  }

  // the last block of this trial to arrive folds the strips in strip order
  // and runs the epilogue
  if (!repro::last_to_arrive(arrivals + trial, nb)) return;
  const size_t dsq = (size_t)d * d;
  commit_epilogue(part, nbp, nb, minv + trial * dsq, s + (size_t)trial * d,
                  eta_p ? eta_p[trial] : eta, threshold_p ? threshold_p[trial] : threshold,
                  can_tx_p ? can_tx_p[trial] != 0.f : can_tx != 0, d, i, (float)n,
                  diag_keep_p ? diag_keep_p[trial] : diag_keep,
                  diag_add_p ? diag_add_p[trial] : diag_add, minv_out + trial * dsq,
                  s_out + (size_t)trial * d,
                  u_out + (size_t)trial * d, accept_out + trial, obj_out + trial);
  if (threadIdx.x == 0) arrivals[trial] = 0;                // ready for the next call
}

using CommitKernel = decltype(&commit_kernel<true>);

// commit_kernel for one load path, allowed the shared memory of d rows
// (above the 48 KB default only on request).
CommitKernel commit_kernel_for(bool aligned, int d, cudaError_t* err) {
  const CommitKernel kernel = aligned ? commit_kernel<true> : commit_kernel<false>;
  const size_t smem = commit_shared_bytes(d);
  *err = smem > 48 * 1024 ? cudaFuncSetAttribute(
                                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
                          : cudaSuccess;
  return kernel;
}

// route 0 (registers): chunk columns a block, a multiple of kProbeStrip;
// scratch holds part_p (batch, d, ncp) then part_gg (batch, ncp), ncp =
// chunks rounded up to 4; arrivals >= batch zeroed ints.  route 1 (shared):
// chunk = bn, a multiple of 32 of at most 256; scratch holds part_p (batch,
// nb, d) then part_gg (batch, nb); arrivals unused.
int launch_probe(const float* r, const float* minv, const float* s,
                 const float* eta, const float* steps, float* cross,
                 float* scratch, int* arrivals, float* etas, float* p,
                 float* gnorm, int d, int n, int k_steps, int i, const int* agents,
                 int route, int chunk, int aligned, int batch, cudaStream_t st) {
  const int nb = (n + chunk - 1) / chunk;
  float* part_p = scratch;
  float* part_gg = scratch + (size_t)batch * d * (route == 0 ? (nb + 3) & ~3 : nb);
  if (route == 0) {
    if (d > kProbeMaxD || chunk % kProbeStrip) return cudaErrorInvalidValue;
    const RowsKernel kernel = aligned ? rows_kernel_for<true>(d) : rows_kernel_for<false>(d);
    kernel<<<dim3(nb, batch), kProbeThreads, 0, st>>>(r, minv, s, eta, steps, cross, part_p,
                                                      part_gg, arrivals, etas, p, gnorm, d, n,
                                                      chunk, k_steps, i, agents);
    return cudaGetLastError();
  }
  const int bn = chunk;
  if (bn % 32 || bn > 256) return cudaErrorInvalidValue;
  const size_t smem = ((size_t)d * bn + bn + d + 33) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      probe_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  probe_pass_kernel<<<dim3(nb, batch), bn, smem, st>>>(r, s, cross, part_p,
                                                       part_gg, d, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem2 = ((size_t)d + 34) * sizeof(double) + (size_t)d * sizeof(float);
  probe_finish_kernel<<<batch, kFinishThreads, smem2, st>>>(
      part_p, part_gg, nb, minv, s, eta, steps, k_steps, d, i, agents, (float)n, etas,
      p, gnorm);
  return cudaGetLastError();
}

int launch_commit(const float* r, const float* delta, const float* minv, const float* s,
                  const float* eta_p, float eta, const float* threshold_p, float threshold,
                  const float* can_tx_p, int can_tx, float* scratch, int* arrivals,
                  float* minv_out, float* s_out, float* u_out, bool* accept, float* obj_post,
                  int d, int n, int i, const int* agents, const float* diag_keep_p,
                  float diag_keep, const float* diag_add_p, float diag_add, int strip,
                  int aligned, int batch, cudaStream_t st) {
  if (strip % 128 || strip < 128 || strip > 128 * repro::kStreamSlices)
    return cudaErrorInvalidValue;
  cudaError_t err;
  const CommitKernel kernel = commit_kernel_for(aligned != 0, d, &err);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((n + strip - 1) / strip, batch), repro::kStreamThreads, commit_shared_bytes(d),
           st>>>(r, delta, minv, s, eta_p, eta, threshold_p, threshold, can_tx_p, can_tx,
                 scratch, arrivals, minv_out, s_out, u_out, accept, obj_post, d, n, strip, i,
                 agents, diag_keep_p, diag_keep, diag_add_p, diag_add);
  return cudaGetLastError();
}

}  // namespace

// Every operand with a leading trial axis of `batch`: r (batch, d, n),
// m_inv (batch, d, d), s (batch, d), eta (batch,), except steps (k_steps,),
// which every trial shares.  Outputs: cross (batch, n), etas (batch,
// k_steps), p (batch, d), gnorm (batch,).  route, chunk and the scratch as
// in launch_probe; the wrapper picks them from (d, n) and the card, never
// from the batch.  aligned != 0 only if n % 4 == 0 and r is 16-byte aligned.
// agents: null (agent i for every trial) or (batch,) int32, trial b's agent.
extern "C" int repro_probe_sweep_batched(
    const float* r, const float* minv, const float* s, const float* eta,
    const float* steps, float* cross, float* scratch, int* arrivals,
    float* etas, float* p, float* gnorm, int d, int n, int k_steps, int i,
    const int* agents, int route, int chunk, int aligned, int batch, void* stream) {
  return launch_probe(r, minv, s, eta, steps, cross, scratch, arrivals, etas,
                      p, gnorm, d, n, k_steps, i, agents, route, chunk, aligned, batch,
                      static_cast<cudaStream_t>(stream));
}

// The same for one trial: r (d, n), s (d,), m_inv (d, d), eta (1,).
extern "C" int repro_probe_sweep(const float* r, const float* minv,
                                 const float* s, const float* eta,
                                 const float* steps, float* cross,
                                 float* scratch, int* arrivals, float* etas,
                                 float* p, float* gnorm, int d, int n,
                                 int k_steps, int i, int route, int chunk,
                                 int aligned, void* stream) {
  return repro_probe_sweep_batched(r, minv, s, eta, steps, cross, scratch,
                                   arrivals, etas, p, gnorm, d, n, k_steps, i,
                                   nullptr, route, chunk, aligned, 1, stream);
}

// Blocks of the register route's kernel for d rows that one SM holds at
// once, for the wrapper's geometry; 0 on error.
extern "C" int repro_probe_blocks_per_sm(int d) {
  if (d < 1 || d > kProbeMaxD) return 0;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, rows_kernel_for<true>(d), kProbeThreads, 0);
  return err == cudaSuccess ? blocks : 0;
}

// Blocks of the commit kernel for d rows that one SM holds at once, for the
// wrapper's geometry; 0 on error.
extern "C" int repro_commit_blocks_per_sm(int d) {
  if (d < 1) return 0;
  cudaError_t err;
  const CommitKernel kernel = commit_kernel_for(true, d, &err);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, repro::kStreamThreads,
                                                        commit_shared_bytes(d));
  return err == cudaSuccess ? blocks : 0;
}

// Every operand with a leading trial axis of `batch`: r (batch, d, n),
// delta (batch, n), m_inv (batch, d, d), s (batch, d).  eta, threshold and
// can_tx each come as a device vector (batch,) or, with a null pointer, as
// the value after it for every trial (can_tx != 0: may transmit).  Scratch
// (batch, d + 1, ceil(n / strip) rounded up to 4); arrivals >= batch zeroed
// ints.  Outputs: m_inv' (batch, d, d), s' (batch, d), u_eff (batch, d),
// accept (batch,) bytes (a torch.bool), obj_post (batch,).  diag_keep and
// diag_add (u_i = diag_keep * (w_i + <delta, delta> / 2n) + diag_add) come
// the same way as eta.  strip: a multiple of 128 columns, at most 1024,
// picked by the wrapper from n and the card, never from the batch;
// aligned != 0 only if n % 4 == 0 and r and delta are 16-byte aligned.
// agents: null (agent i for every trial) or (batch,) int32, trial b's agent.
extern "C" int repro_commit_sweep_batched(
    const float* r, const float* delta, const float* minv, const float* s, const float* eta_p,
    float eta, const float* threshold_p, float threshold, const float* can_tx_p, int can_tx,
    float* scratch, int* arrivals, float* minv_out, float* s_out, float* u_out, bool* accept,
    float* obj_post, int d, int n, int i, const int* agents, const float* diag_keep_p,
    float diag_keep, const float* diag_add_p, float diag_add, int strip, int aligned,
    int batch, void* stream) {
  return launch_commit(r, delta, minv, s, eta_p, eta, threshold_p, threshold, can_tx_p, can_tx,
                       scratch, arrivals, minv_out, s_out, u_out, accept, obj_post, d, n, i,
                       agents, diag_keep_p, diag_keep, diag_add_p, diag_add, strip, aligned,
                       batch, static_cast<cudaStream_t>(stream));
}

// The same for one trial: r (d, n), delta (n,), m_inv (d, d), s (d,);
// eta, threshold, can_tx, diag_keep, diag_add as one-element device
// tensors or by value; accept (1,), obj_post (1,).
extern "C" int repro_commit_sweep(const float* r, const float* delta, const float* minv,
                                  const float* s, const float* eta_p, float eta,
                                  const float* threshold_p, float threshold,
                                  const float* can_tx_p, int can_tx, float* scratch,
                                  int* arrivals, float* minv_out, float* s_out, float* u_out,
                                  bool* accept, float* obj_post, int d, int n, int i,
                                  const float* diag_keep_p, float diag_keep,
                                  const float* diag_add_p, float diag_add, int strip,
                                  int aligned, void* stream) {
  return repro_commit_sweep_batched(r, delta, minv, s, eta_p, eta, threshold_p, threshold,
                                    can_tx_p, can_tx, scratch, arrivals, minv_out, s_out,
                                    u_out, accept, obj_post, d, n, i, nullptr, diag_keep_p,
                                    diag_keep, diag_add_p, diag_add, strip, aligned, 1, stream);
}
