// The split KL reverse sweep ("B12") for NVIDIA Hopper (sm_90a): CAIS with
// the geffner net at the width of the 1600-D LGCP, whose score and Hessian
// product are inlined.
//
// Replaces the split branch of cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_pallas
// (net_grads_outside: iter_fn_split, final_fn_split and the weight-gradient
// pass after the pallas_call), which the JAX package takes for a net past
// _NET_GRADS_OUTSIDE_BYTES (4 MB; cmcd_tpu/ops/fused_train.py). Inside the
// kernel the sweep carries only the state's cotangents; it writes each stored
// point's net-output cotangent g_sn, and the wrapper
// (cmcd_tpu_torch/ops/kl_split.py::evolve_kl_split) takes the net's weight
// gradients from one batched autograd pass of the plain net over the stored
// trajectory seeded with them, as JAX takes them from one XLA vjp. The
// kernel reads the draws the rollout stored (the port's KL rollout keeps its
// noise: K x N x D x 4 bytes, 1 MB at N=20, K=8), where JAX's float32 split
// path rebuilds xi from the trajectory; the two differ by about an ulp of z
// over the step scale.
//
// The sweep visits each point once, from z_K down to z_0, with the carry
// derivation of kl.cu (its header): point p's score gt_p and net output sn_p
// serve both the backward mean of step p - 1 (formed at z_p) and the forward
// mean of step p (from z_p). Per point, for one chain, with c its cotangent
// of the summed log-weight and fk, direct the carries (the cotangent of step
// p's forward mean, and what z_p gets from step p besides; g_zfinal at z_K):
//   g_gt = g_gq = g_sn = 0; total = direct
//   p <= K - 1:  g_gt += b e fk; g_gq += (1 - b) e fk; g_sn -= e fk
//                d eps_p += fk . (drift_p(z_p) - sn_p);  d beta_p += e fk . (gt - gq)
//   p >= 1:      r = z_{p-1} - (z_p + e drift + e sn_p);  g_mean = c r / (2 e)
//                g_gt += b e g_mean; g_gq += (1 - b) e g_mean; g_sn += e g_mean
//                total += g_mean;  d eps_{p-1} += g_mean . (drift + sn) + c |r|^2 / (2e)^2
//                d beta_{p-1} += e g_mean . (gt - gq)
//   clipped entries pass nothing; vd_mean += g_gq viv; vd_logdiag += -2 g_gq gq
//   total += -viv g_gq + H(z_p) g_gt + J_net(z_p)^T g_sn
//   p >= 1:      d eps_{p-1} += total . xi_{p-1} / sqrt(2 e);  fk = total,
//                direct = total - g_mean;  p = 0: g_z0 = total
// with b, e the step's beta and eps (eps_j = eps0 * slope_j + offset_j, so
// d eps0 = sum_j slope_j d eps_j), drift = b clip(gt) + (1 - b) clip(gq), and
// the net at row min(p, K - 1). So a point costs one score, one net apply,
// one Hessian product and one net VJP in z, and nothing of the weights' size
// is written. In matrix-vector products (M x the chains' vectors):
//   score     Sigma^{-1} rows (whitened: L rows, then L columns)
//   net       W1[:D] columns, W2 columns, the head rows
//   Hessian   Sigma^{-1} rows (whitened: L rows, then L columns)
//   VJP       the head columns, W2 rows, W1[:D] rows
//
// What bounds it: 2 D (D + 2 F) + 2 D^2 operations for the apply and the
// score and as many again for the VJP and the Hessian product (whitened: L
// twice each), ~42 MFLOP a chain-point at LGCP, 7.5 GFLOP a sweep at N=20,
// K=8 (0.112 ms at 67 TFLOP/s). Every matrix element is needed once a point
// for all chains, and the 41.6 MB of matrices stay in the 50 MB L2.
//
// Design: one cooperative launch of as many blocks as are co-resident (one
// an SM) carries every chain through the points together. A point is twelve
// phases with a grid barrier after each:
//   P1 score rows + W1 columns | R1 | P2 (L columns +) W2 columns | R2 |
//   P3 head rows | R3 the elementwise terms | P4 Hessian rows + head columns |
//   R4 | P5 (L columns +) W2 rows | R5 | P6 W1 rows | R6 the carries
// A product phase cuts each matrix into tiles of OT outputs by at most TMAX
// inputs, about one tile a block; a block copies its tile into shared memory
// (cp.async, each element once a point), stages its input slice of every
// chain beside it and multiplies it for every chain group (warps over chain
// quads and input sub-ranges, 4 outputs x 4 chains a lane), writing its
// partial sums to scratch. The reduction phase after it sums each output's
// partials once, in slice order, and applies the epilogue (softplus and
// sigmoid, the score's a e^x, the carry's terms). Chains go in groups of at
// most CW = 32: a group's vectors are one lane a chain, so the elementwise
// phases take an output a warp. The sums: a block's eps and beta terms go
// to its own slot and the kernel adds the slots in block order at its end;
// vd mean and logdiag at dimension k belong to the one warp that takes k.
// No atomics but the grid barrier's: the same inputs give the same bits.

#include <cooperative_groups.h>

#include "cmcd_wide.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace cmcd;
using wide::dispatch_lgcp;
using wide::WideNet;
using wide::WideTarget;

constexpr int THREADS = 512;  // threads of one block
constexpr int NWARP = THREADS / 32;
constexpr int CW = 32;        // chains of a group at most: a lane each
constexpr int OT = 128;       // outputs of a tile: lane + 32 u, u < 4
constexpr int TMAX = 192;     // inputs of a tile at most
// The workspace of one group: vectors of D (gt, ez, tmp, g_gt, g_sn, g_mean,
// total, fk, direct) and of F (h, sigmoid(a1), sigmoid(a2), the VJP's g_h
// and g_a), CW floats an element.
constexpr int SWEEP_ND = 9, SWEEP_NF = 5;
// Shared memory: the tile (OT rows of at most TMAX + 4, or TMAX rows of OT),
// the input slice (TMAX x CW) and the warps' partial sums (NWARP x 4 rows of
// OT + 1; the block sums reuse it).
constexpr int SM_TILE = OT * (TMAX + 4), SM_V = TMAX * CW, SM_RED = NWARP * 4 * (OT + 1);
constexpr size_t SMEM = sizeof(float) * (SM_TILE + SM_V + SM_RED);

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Inputs of a tile of a product with `outs` outputs and `ins` inputs on
// `blocks` blocks: about one tile a block, at most TMAX, a multiple of 4.
__host__ __device__ inline int slice_len(int outs, int ins, int blocks) {
  int want = blocks / cdiv(outs, OT);
  if (want < 1) want = 1;
  const int len = round_up(cdiv(ins, want), 4);
  return len < TMAX ? len : TMAX;
}

__host__ __device__ inline int slices(int outs, int ins, int blocks) {
  return cdiv(ins, slice_len(outs, ins, blocks));
}

// Chain groups of n chains: ceil(n / CW) groups of ceil(n / groups) chains.
__host__ __device__ inline int groups_of(int n) { return cdiv(n, CW); }
__host__ __device__ inline int group_size(int n) { return cdiv(n, groups_of(n)); }

// Floats of a group's workspace and of one partial-sum slot (the largest of
// the products: D x D, F x D, F x F, D x F as outputs x inputs, every group).
__host__ __device__ inline size_t group_floats(int d, int f) {
  return (size_t)CW * (SWEEP_ND * round_up(d, 4) + SWEEP_NF * round_up(f, 4));
}

__host__ __device__ inline size_t slot_floats(int n, int d, int f, int blocks) {
  const int shapes[4][2] = {{d, d}, {f, d}, {f, f}, {d, f}};
  size_t most = 0;
  for (const auto& s : shapes) {
    const size_t v = (size_t)slices(s[0], s[1], blocks) * s[0];
    if (v > most) most = v;
  }
  return (size_t)groups_of(n) * CW * most;
}

// The sums of the output: eps, betas (K), vd mean (D), vd logdiag (D).
__host__ __device__ inline int len_sums(int d, int k) { return 1 + k + 2 * d; }

struct Groups {
  int count, size, n;
  __device__ int valid(int g) const { return min(size, n - g * size); }
};

// A vector of every group in the workspace: element (g, k, c) for chain c
// of group g at dimension k. Other blocks write it between grid barriers,
// so reads go to L2 (ld.global.cg).
struct GVec {
  float* p;
  size_t gs;
  __device__ float get(int g, int k, int c) const {
    return __ldcg(p + g * gs + (size_t)k * CW + c);
  }
  __device__ void set(int g, int k, int c, float v) const { p[g * gs + (size_t)k * CW + c] = v; }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One product of a phase for every chain of every group:
//   rows form (BY_ROWS)  out(c, i) = sum_j M[i][j] v(c, j), i < R (outputs), j < C
//   columns form         out(c, j) = sum_i v(c, i) M[i][j], j < C (outputs), i < R
// M row-major R x C, both multiples of 4; v(g, c, t) gives input t of chain
// c of group g. The block's tiles (tile = blockIdx.x, + gridDim.x, ...)
// write their partials to part (groups, slices, outputs, CW). A lane holds
// 4 outputs (lane + 32 u) x 4 chains (its warp's quad); the warps of a quad
// split the tile's inputs and their sums meet in shared memory in warp order.
template <bool BY_ROWS, class V>
__device__ void product(const float* __restrict__ m, int R, int C, float* part, const Groups& gr,
                        float* sm, V v) {
  float* tile = sm;
  float* vs = sm + SM_TILE;
  float* red = vs + SM_V;
  const int outs = BY_ROWS ? R : C, ins = BY_ROWS ? C : R;
  const int no = cdiv(outs, OT), len = slice_len(outs, ins, gridDim.x), ns = cdiv(ins, len);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncq = cdiv(gr.size, 4), nsplit = NWARP / ncq;
  for (int ti = blockIdx.x; ti < no * ns; ti += gridDim.x) {
    const int o0 = (ti % no) * OT, sl = ti / no, t0 = sl * len;
    const int on = min(OT, outs - o0), tn = min(len, ins - t0), tq = tn / 4;
    const int pitch = (tq & 1) ? tn : tn + 4;  // rows form: an odd count of float4s
    if constexpr (BY_ROWS) {
      for (int i = tid; i < on * tq; i += THREADS) {
        const int r = i / tq, q = i - r * tq;
        cp_async16(tile + r * pitch + 4 * q, m + (size_t)(o0 + r) * C + t0 + 4 * q);
      }
    } else {
      const int oq = on / 4;
      for (int i = tid; i < tn * oq; i += THREADS) {
        const int t = i / oq, q = i - t * oq;
        cp_async16(tile + t * OT + 4 * q, m + (size_t)(t0 + t) * C + o0 + 4 * q);
      }
    }
    for (int g = 0; g < gr.count; ++g) {
      const int gn = gr.valid(g);
      for (int i = tid; i < tn * CW; i += THREADS) {
        const int t = i / CW, c = i - t * CW;
        vs[i] = c < gn ? v(g, c, t0 + t) : 0.f;
      }
      if (g == 0) cp_async_wait_all();
      __syncthreads();
      if (warp < nsplit * ncq) {
        const int cq = warp % ncq, s = warp / ncq, per = cdiv(tq, nsplit);
        const int q1 = min(tq, (s + 1) * per);
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;
        for (int q = s * per; q < q1; ++q) {
          float mv[4][4];  // mv[u][r]: output lane + 32 u, input 4 q + r
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if constexpr (BY_ROWS) {
              const float4 x = *reinterpret_cast<const float4*>(tile + (lane + 32 * u) * pitch + 4 * q);
              mv[u][0] = x.x;
              mv[u][1] = x.y;
              mv[u][2] = x.z;
              mv[u][3] = x.w;
            } else {
#pragma unroll
              for (int r = 0; r < 4; ++r) mv[u][r] = tile[(4 * q + r) * OT + lane + 32 * u];
            }
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(vs + (4 * q + r) * CW + 4 * cq);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[u][0] = fmaf(mv[u][r], x.x, acc[u][0]);
              acc[u][1] = fmaf(mv[u][r], x.y, acc[u][1]);
              acc[u][2] = fmaf(mv[u][r], x.z, acc[u][2]);
              acc[u][3] = fmaf(mv[u][r], x.w, acc[u][3]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int c = 0; c < 4; ++c) red[(warp * 4 + c) * (OT + 1) + lane + 32 * u] = acc[u][c];
      }
      __syncthreads();
      float* out = part + ((size_t)g * ns + sl) * outs * CW;
      for (int i = tid; i < on * CW; i += THREADS) {
        const int ol = i / CW, c = i - ol * CW;
        if (c >= gn) continue;
        float sum = 0.f;
        for (int s = 0; s < nsplit; ++s) sum += red[(s * ncq * 4 + c) * (OT + 1) + ol];
        out[(size_t)(o0 + ol) * CW + c] = sum;
      }
    }
  }
}

// Output o of chain c of group g of a product with `outs` outputs and `ins`
// inputs: its partials summed in slice order.
__device__ __forceinline__ float slice_sum(const float* part, int outs, int ins, int g, int o,
                                           int c) {
  const int ns = slices(outs, ins, gridDim.x);
  const float* p = part + ((size_t)g * ns * outs + o) * CW + c;
  float s = 0.f;
  for (int t = 0; t < ns; ++t) s += __ldcg(p + (size_t)t * outs * CW);
  return s;
}

// A reduction phase: ea(g, o, c, sum) for every output o < oa of product A
// (partials pa, ins ia; none if pa is null) and eb(...) for product B, every
// valid chain c of every group g; a warp an (output, group), a lane a chain.
template <class EA, class EB>
__device__ void reduce2(const float* pa, int oa, int ia, EA ea, const float* pb, int ob, int ib,
                        EB eb, const Groups& gr) {
  const int lane = threadIdx.x & 31, tw = gridDim.x * NWARP;
  const int na = pa != nullptr ? oa * gr.count : 0, nb = ob * gr.count;
  for (int w = blockIdx.x * NWARP + (threadIdx.x >> 5); w < na + nb; w += tw) {
    const bool is_a = w < na;
    const int wi = is_a ? w : w - na, outs = is_a ? oa : ob, g = wi / outs, o = wi - g * outs;
    if (lane >= gr.valid(g)) continue;
    if (is_a) {
      ea(g, o, lane, slice_sum(pa, oa, ia, g, o, lane));
    } else {
      eb(g, o, lane, slice_sum(pb, ob, ib, g, o, lane));
    }
  }
}

struct SweepArgs {
  const float* traj;      // (K + 1, n, D): z_0..z_K
  const float* noise;     // (K, n, D): xi_0..xi_{K-1}
  const float* cot;       // (n,)
  const float* g_zfinal;  // (n, D)
  const float* betas;     // (K,)
  const float* scal;      // [eps0, factor_sn]
  WideNet net;
  WideTarget tgt;
  const float* vd_mean;     // (D,)
  const float* vd_logdiag;  // (D,)
  float* bsum;              // (blocks, 1 + K): each block's eps and beta terms
  float* part;              // 2 slots of slot_floats: the products' partial sums
  float* out;               // (len_sums)
  float* g_z0;              // (n, D)
  float* gsn;               // (K + 1, n, D): the net-output cotangent of each point
  float* ws;                // (groups, group_floats)
  int n, nbridges, d, eps_schedule;
  float clip_t, clip_q;
};

template <bool WH>
__global__ void __launch_bounds__(THREADS, 1) kl_split_sweep(const SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::grid_group grid = cg::this_grid();
  const int d = a.d, f = a.net.f, K = a.nbridges, n = a.n;
  const Groups gr{groups_of(n), group_size(n), n};
  const int dp = round_up(d, 4), fp = round_up(f, 4);
  const size_t gs = group_floats(d, f);
  const auto vec = [&](int i) { return GVec{a.ws + (size_t)i * dp * CW, gs}; };
  const auto fvec = [&](int i) { return GVec{a.ws + (size_t)SWEEP_ND * dp * CW + (size_t)i * fp * CW, gs}; };
  const GVec gt = vec(0), ez = vec(1), tmp = vec(2), ggt = vec(3), gsn = vec(4), gmean = vec(5);
  const GVec total = vec(6), fk = vec(7), direct = vec(8);
  const GVec h = fvec(0), s1 = fvec(1), s2 = fvec(2), gh = fvec(3), ga = fvec(4);
  float* part_a = a.part;
  float* part_b = a.part + slot_floats(n, d, f, gridDim.x);
  const int tid = threadIdx.x, lane = tid & 31;
  const int gw = blockIdx.x * NWARP + (tid >> 5), tw = gridDim.x * NWARP;
  const float eps0 = a.scal[0], factor = a.scal[1], mu = a.tgt.par[0], acoef = a.tgt.par[1];
  const float* mat = a.tgt.mat;
  const WideNet& net = a.net;
  float* bsum = a.bsum + (size_t)blockIdx.x * (1 + K);
  float* out_mean = a.out + 1 + K;
  float* out_logd = out_mean + d;
  for (int e = tid; e < 1 + K; e += THREADS) bsum[e] = 0.f;
  for (int e = blockIdx.x * THREADS + tid; e < 2 * d; e += gridDim.x * THREADS) out_mean[e] = 0.f;
  const auto chain = [&](int g, int c) { return g * gr.size + c; };

  for (int p = K; p >= 0; --p) {
    const int idx = p < K - 1 ? p : K - 1;
    const float* zp = a.traj + (size_t)p * n * d;
    const auto z = [&](int g, int c, int k) { return zp[(size_t)chain(g, c) * d + k]; };

    // P1, R1: the score's first product and layer 1.
    product<true>(mat, d, d, part_a, gr, sm,
                  [&](int g, int c, int t) { return WH ? z(g, c, t) : z(g, c, t) - mu; });
    product<false>(net.w1z, d, f, part_b, gr, sm, z);
    grid.sync();
    reduce2(
        part_a, d, d,
        [&](int g, int o, int c, float s) {
          if constexpr (!WH) {
            const float e = acoef * expf(z(g, c, o));
            ez.set(g, o, c, e);
            gt.set(g, o, c, -s + a.tgt.counts[o] - e);
          } else {
            const float e = acoef * expf(s + mu);
            ez.set(g, o, c, e);
            tmp.set(g, o, c, a.tgt.counts[o] - e);
          }
        },
        part_b, f, d,
        [&](int g, int o, int c, float s) {
          const float a1 = s + net.c1[(size_t)idx * f + o];
          const float h0 = o < d ? z(g, c, o) : net.emb[(size_t)idx * net.e + o - d];
          h.set(g, o, c, h0 + softplus_f(a1));
          s1.set(g, o, c, sigmoid_f(a1));
        },
        gr);
    grid.sync();

    // P2, R2: the whitened score's L^T, layer 2.
    if constexpr (WH) product<false>(mat, d, d, part_a, gr, sm, [&](int g, int c, int t) {
      return tmp.get(g, t, c);
    });
    product<false>(net.w2, f, f, part_b, gr, sm, [&](int g, int c, int t) { return h.get(g, t, c); });
    grid.sync();
    reduce2(
        WH ? part_a : nullptr, d, d,
        [&](int g, int o, int c, float s) { gt.set(g, o, c, -z(g, c, o) + s); }, part_b, f, f,
        [&](int g, int o, int c, float s) {
          const float a2 = s + net.b2[o];
          h.set(g, o, c, h.get(g, o, c) + softplus_f(a2));
          s2.set(g, o, c, sigmoid_f(a2));
        },
        gr);
    grid.sync();

    // P3: the head.
    product<true>(net.headw, d, f, part_b, gr, sm, [&](int g, int c, int t) { return h.get(g, t, c); });
    grid.sync();

    // R3: the point's elementwise terms, a warp a dimension k over every
    // chain. Sums s[0] d eps (slope-weighted), s[1] d beta_p, s[2] d
    // beta_{p-1}, s[3] g_e of step p - 1 (weighted at the point's end).
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const bool fwd = p <= K - 1, bwd = p >= 1;
    const float b_f = fwd ? a.betas[p] : 0.f, e_f = fwd ? eps_at(eps0, p, K, a.eps_schedule) : 0.f;
    const float sl_f = fwd ? eps_slope(p, K, a.eps_schedule) : 0.f;
    const float b_b = bwd ? a.betas[p - 1] : 0.f;
    const float e_b = bwd ? eps_at(eps0, p - 1, K, a.eps_schedule) : 0.f;
    for (int k = gw; k < d; k += tw) {
      const float vm = a.vd_mean[k], viv = expf(-2.0f * a.vd_logdiag[k]);
      float pm = 0.f, pl = 0.f;
      for (int g = 0; g < gr.count; ++g) {
        const int c = lane;
        if (c >= gr.valid(g)) continue;
        const int ch = chain(g, c);
        const float cot = a.cot[ch];
        const float snk = (slice_sum(part_b, d, f, g, k, c) + net.headb[k]) * factor;
        const float zk = z(g, c, k), gtk = gt.get(g, k, c);
        const float gq = -(zk - vm) * viv;
        const float gtc = clip_f(gtk, a.clip_t), gqc = clip_f(gq, a.clip_q);
        float g_gt = 0.f, g_gq = 0.f, g_sn = 0.f;
        float tot = p == K ? a.g_zfinal[(size_t)ch * d + k] : direct.get(g, k, c);
        if (fwd) {
          const float fkv = fk.get(g, k, c);
          s[0] += sl_f * (fkv * ((b_f * gtc + (1.0f - b_f) * gqc) - snk));
          s[1] += e_f * fkv * (gtc - gqc);
          g_gt += b_f * e_f * fkv;
          g_gq += (1.0f - b_f) * e_f * fkv;
          g_sn -= e_f * fkv;
        }
        float gm = 0.f;
        if (bwd) {
          const float zprev = a.traj[((size_t)(p - 1) * n + ch) * d + k];
          const float drift = b_b * gtc + (1.0f - b_b) * gqc;
          const float r = zprev - (zk + e_b * drift + e_b * snk);
          gm = cot * r / (2.0f * e_b);
          s[3] += gm * (drift + snk) + cot * r * r / ((2.0f * e_b) * (2.0f * e_b));
          s[2] += e_b * gm * (gtc - gqc);
          g_gt += b_b * e_b * gm;
          g_sn += e_b * gm;
          g_gq += (1.0f - b_b) * e_b * gm;
          tot += gm;
        }
        if (gtk != gtc) g_gt = 0.f;  // a clipped score passes nothing
        if (gq != gqc) g_gq = 0.f;
        pm += g_gq * viv;
        pl += g_gq * (-2.0f * gq);
        ggt.set(g, k, c, g_gt);
        gsn.set(g, k, c, g_sn);
        gmean.set(g, k, c, gm);
        total.set(g, k, c, tot - viv * g_gq);
        a.gsn[((size_t)p * n + ch) * d + k] = g_sn;
      }
      pm = warp_sum(pm);
      pl = warp_sum(pl);
      if (lane == 0) {
        out_mean[k] += pm;
        out_logd[k] += pl;
      }
    }
    grid.sync();

    // P4, R4: the Hessian product's first product, the head's transpose.
    product<true>(mat, d, d, part_a, gr, sm, [&](int g, int c, int t) { return ggt.get(g, t, c); });
    product<false>(net.headw, d, f, part_b, gr, sm,
                   [&](int g, int c, int t) { return gsn.get(g, t, c) * factor; });
    grid.sync();
    reduce2(
        part_a, d, d,
        [&](int g, int o, int c, float s) {
          if constexpr (!WH) {
            total.set(g, o, c, total.get(g, o, c) + (-s - ez.get(g, o, c) * ggt.get(g, o, c)));
          } else {
            tmp.set(g, o, c, ez.get(g, o, c) * s);
          }
        },
        part_b, f, d,
        [&](int g, int o, int c, float s) {
          gh.set(g, o, c, s);
          ga.set(g, o, c, s * s2.get(g, o, c));
        },
        gr);
    grid.sync();

    // P5, R5: the whitened Hessian's L^T, W2 in the VJP.
    if constexpr (WH) product<false>(mat, d, d, part_a, gr, sm, [&](int g, int c, int t) {
      return tmp.get(g, t, c);
    });
    product<true>(net.w2, f, f, part_b, gr, sm, [&](int g, int c, int t) { return ga.get(g, t, c); });
    grid.sync();
    reduce2(
        WH ? part_a : nullptr, d, d,
        [&](int g, int o, int c, float s) {
          total.set(g, o, c, total.get(g, o, c) + (-ggt.get(g, o, c) - s));
        },
        part_b, f, f,
        [&](int g, int o, int c, float s) {
          const float g1 = gh.get(g, o, c) + s;
          gh.set(g, o, c, g1);
          ga.set(g, o, c, g1 * s1.get(g, o, c));
        },
        gr);
    grid.sync();

    // P6: W1[:D] in the VJP.
    product<true>(net.w1z, d, f, part_b, gr, sm, [&](int g, int c, int t) { return ga.get(g, t, c); });
    grid.sync();

    // R6: the VJP's end, the draw's term of step p - 1's eps, the carries
    // (or g_z0), and the block's sums of the point.
    const float inv_s = bwd ? 1.0f / sqrtf(2.0f * e_b) : 0.f;
    for (int k = gw; k < d; k += tw) {
      for (int g = 0; g < gr.count; ++g) {
        const int c = lane;
        if (c >= gr.valid(g)) continue;
        const int ch = chain(g, c);
        const float tot = total.get(g, k, c) + (gh.get(g, k, c) + slice_sum(part_b, d, f, g, k, c));
        if (bwd) {
          s[3] += tot * a.noise[((size_t)(p - 1) * n + ch) * d + k] * inv_s;
          fk.set(g, k, c, tot);
          direct.set(g, k, c, tot - gmean.get(g, k, c));
        } else {
          a.g_z0[(size_t)ch * d + k] = tot;
        }
      }
    }
    wide::block_sum<4>(s, sm + SM_TILE + SM_V);
    if (tid == 0) {
      bsum[0] += s[0] + (bwd ? eps_slope(p - 1, K, a.eps_schedule) * s[3] : 0.f);
      if (fwd) bsum[1 + p] += s[1];
      if (bwd) bsum[p] += s[2];
    }
    grid.sync();
  }

  // The blocks' eps and beta sums, added in block order.
  if (blockIdx.x == 0) {
    for (int e = tid >> 5; e < 1 + K; e += NWARP) {
      float v = 0.f;
      for (int b = lane; b < (int)gridDim.x; b += 32) v += __ldcg(a.bsum + (size_t)b * (1 + K) + e);
      v = warp_sum(v);
      if (lane == 0) a.out[e] = v;
    }
  }
}

}  // namespace

extern "C" {

// Blocks of one launch of the sweep on the current device (target 4 the
// LGCP, 5 whitened): as many as are co-resident, or a negative cudaError_t.
int cmcd_kl_split_blocks(int target) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = dispatch_lgcp(target, [&](auto tag) {
      constexpr bool WH = decltype(tag)::value;
      cudaError_t e = cudaFuncSetAttribute(kl_split_sweep<WH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
      if (e != cudaSuccess) return e;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kl_split_sweep<WH>, THREADS, SMEM);
    });
  }
  if (err != cudaSuccess) return -(int)err;
  return per * sms;
}

// Launches the split sweep on `stream`, one cooperative launch of `blocks`
// (at most cmcd_kl_split_blocks): target 4 the LGCP (mat Sigma^{-1}), 5 the
// whitened LGCP (mat L); tpar = [mu, a]; the geffner net on [z, emb]
// (in_dim = dim + emb_dim); bsum (blocks, 1 + nbridges), part (2
// cmcd_kl_split_slot_floats) and ws (cmcd_kl_split_ws_floats) scratch; out
// (len_sums): d eps0, d betas (K), d vd_mean (dim), d vd_logdiag (dim); gsn
// (K + 1, n, dim). Returns a cudaError_t (0 on success).
int cmcd_kl_split_sweep(const float* traj, const float* noise, const float* cot,
                        const float* g_zfinal, const float* betas, const float* scal,
                        const float* w1z, const float* c1, const float* emb, const float* w2,
                        const float* b2, const float* headw, const float* headb,
                        const float* mat, const float* counts, const float* tpar,
                        const float* vd_mean, const float* vd_logdiag, float* bsum, float* part,
                        float* out, float* g_z0, float* gsn, float* ws, int n, int nbridges,
                        int dim, int in_dim, int emb_dim, int eps_schedule, int target,
                        float clip_t, float clip_q, int blocks, void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaSuccess;
  if (dim < 4 || dim % 4 != 0 || in_dim % 4 != 0 || emb_dim < 0 || in_dim != dim + emb_dim ||
      blocks <= 0)
    return (int)cudaErrorInvalidValue;
  SweepArgs a{traj, noise, cot, g_zfinal, betas, scal,
              WideNet{w1z, c1, emb, w2, b2, headw, headb, in_dim, emb_dim},
              WideTarget{mat, counts, tpar}, vd_mean, vd_logdiag, bsum, part, out, g_z0, gsn, ws,
              n, nbridges, dim, eps_schedule, clip_t, clip_q};
  void* args[] = {&a};
  return (int)dispatch_lgcp(target, [&](auto tag) {
    constexpr bool WH = decltype(tag)::value;
    cudaError_t e = cudaFuncSetAttribute(kl_split_sweep<WH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return e;
    e = cudaLaunchCooperativeKernel((const void*)kl_split_sweep<WH>, blocks, THREADS, args, SMEM,
                                    (cudaStream_t)stream);
    return e != cudaSuccess ? e : cudaGetLastError();
  });
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The scratch of a launch, for the wrapper to allocate: the chain groups,
// the floats of the workspace and of one slot of partial sums.
int cmcd_kl_split_groups(int n) { return groups_of(n); }
long long cmcd_kl_split_ws_floats(int n, int in_dim, int dim) {
  return (long long)groups_of(n) * (long long)group_floats(dim, in_dim);
}
long long cmcd_kl_split_slot_floats(int n, int in_dim, int dim, int blocks) {
  return (long long)slot_floats(n, dim, in_dim, blocks);
}
int cmcd_kl_split_len_sums(int dim, int nbridges) { return len_sums(dim, nbridges); }

}  // extern "C"
