// What the CMCD kernels for NVIDIA Hopper (sm_90a) share: the pieces of a
// step, stated once. Included by overdamped.cu, underdamped.cu and uha.cu
// (the rollouts) and, through cmcd_tile.cuh, by vargrad.cu, kl.cu,
// kl_underdamped.cu and kl_uha.cu (the backward kernels).
//
// The score net is a template parameter (GeffnerNet, PisNet below). The
// geffner net is the two-layer net on h0 = [x, emb_i], where x is the state
// z (DIN = D columns, D the target's dimension) or, for the underdamped
// modes whose net sees the momentum too, [z, rho'] (DIN = 2 D); the head has
// D outputs either way:
//   a1 = x @ W1[:DIN] + c1[i]        c1 = emb @ W1[DIN:] + b1 (per call, wrapper)
//   h1 = h0 + softplus(a1)
//   a2 = h1 @ W2 + b2,  h2 = h1 + softplus(a2)
//   sn = (h2 @ headW^T + headb) * factor_sn
// The PIS nets ("dds", "dds_grad") take the same two layers of F features on
// x = z, with the time coder's output h_t in the place of the embedding,
// gelu in the place of the residual softplus and the output clipped:
//   a1 = z @ W1[:D] + c1[t]          c1[t] = W1[D:] h_t(t) + b1 (per call, wrapper)
//   h1 = gelu(a1),  a2 = h1 @ W2 + b2,  h2 = gelu(a2)
//   sn = clip(h2 @ headW^T + headb, 1e4) [+ g_t[t] * clip(gt(z), 1e2)]
// where the bracket is dds_grad's gate term: g_t (K + 1 x D) the gate MLP's
// table, gt the target score the kernel already forms at z, stop-gradient.
// and the target is a template parameter of every kernel (ManyGmmTarget,
// Gmm3Target, FunnelTarget, StdNormalTarget<D>, LogregTarget<D, R> below):
// its dimension D, its score and the Hessian product the sweeps need, one
// warp per chain, from a vector of n_par constants the kernel keeps in
// shared memory (many_gmm: its n_par / 2 means, the isotropic, equally
// weighted mixture's score gt = inv_var * (sum_k r_k(z) m_k - z),
// r = softmax_k(-inv_var/2 |z - m_k|^2); the 3-mode gmm: its 18 constants,
// gmm3_score; the funnel: its sig; the standard normal and the logistic
// regressions: the prior precision, 1) and, for the logistic regressions, a
// dataset read through a pointer of its own (NetArgs::tdata). Every array of
// a chain's state is sized by the target's D, a compile-time constant.
//
// Work split of one block. Thread f owns net feature f for a tile of TC
// chains (so each W2 element read from shared memory feeds TC FMAs and the
// hidden states are read as broadcast float4s); the head and the score are
// reductions with one warp per chain, lanes over features or components.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cmcd {

constexpr int TC = 8;         // chains one feature thread carries through a layer
constexpr int MAX_MIX = 64;   // many_gmm components: two per lane
constexpr int MAX_PAR = 2 * MAX_MIX;  // floats of a target's constants
constexpr size_t MAX_SMEM = 232448;  // 227 KiB a block may use on sm_90

// The net and the target as a kernel sees them (device pointers, f32). For a
// PIS net in_dim is its width F, emb_dim 0 and emb null.
struct NetArgs {
  const float* w1z;    // (DIN, in): rows of layer-1 W (in x out) for x
  const float* c1;     // (rows, in): per row of the net's time index, K rows
                       // (geffner: emb_i @ W1[DIN:] + b1) or K + 1 (PIS: W1[D:] h_t + b1)
  const float* emb;    // (K, emb_dim)
  const float* w2;     // (in, in): layer-2 W, row k = input feature k
  const float* b2;     // (in,)
  const float* headw;  // (D, in)
  const float* headb;  // (D,)
  const float* tpar;   // (n_par,): the target's constants
  int in_dim, in_pad, emb_dim, n_par;
  float inv_var_t;     // many_gmm's 1 / scale^2 (unused by the 3-mode gmm)
  const float* gate;   // (K + 1, D) dds_grad's gate table, or null (dds, geffner)
  // A logistic regression's dataset ((D + 1) x n_data: X^T row-major, then
  // y), read in place through the L1 cache; null and 0 for the other targets.
  const float* tdata = nullptr;
  int n_data = 0;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The constants a launch's target takes (ops/target_grads.TARGETS): many_gmm
// (0) an even count of at most MAX_PAR, its means; the 3-mode gmm (1) its 18;
// the funnel (2) its sig; the standard normal (3) and the logistic
// regressions (6 australian, 7 ionosphere, 8 sonar) their prior precision.
// Codes 4 and 5 (the LGCP) belong to the wide forms (cmcd_wide.cuh).
__host__ inline bool target_ok(int target, int n_par) {
  if (target == 0) return n_par >= 2 && n_par <= MAX_PAR && n_par % 2 == 0;
  if (target == 1) return n_par == 18;
  return (target == 2 || target == 3 || (target >= 6 && target <= 8)) && n_par == 1;
}

__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// d/dx softplus(x), stable for both signs.
__device__ __forceinline__ float sigmoid_f(float x) {
  const float e = expf(-fabsf(x));
  return x >= 0.f ? 1.0f / (1.0f + e) : e / (1.0f + e);
}

// jnp.clip semantics: NaN passes through.
__device__ __forceinline__ float clip_f(float x, float c) {
  return x < -c ? -c : (x > c ? c : x);
}

// Exact (erf-based) gelu, as the JAX package's scan path (networks/pis.py),
// and its derivative Phi(x) + x phi(x).
__device__ __forceinline__ float gelu_f(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float dgelu_f(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f)) +
         x * 0.39894228040143268f * expf(-0.5f * x * x);
}

constexpr float PIS_OUT_CLIP = 1.0e4f;   // the PIS nets' output clip
constexpr float PIS_GATE_CLIP = 1.0e2f;  // dds_grad's clip of the score feature

// The score nets as template parameters of the kernels with a net tile (B1,
// B2, B3, B5): what differs between geffner and PIS inside a kernel.
//  * RESIDUAL: h_l = h_{l-1} + act(a_l) (geffner, h0 = [x, emb]), so the
//    VJP's g_h1 and g_x take the identity path; else h_l = act(a_l).
//  * act / dact: softplus and its derivative, or gelu and gelu'.
//  * row(idx, K): the table row of the net at time index idx. Geffner's
//    embedding has K rows and the CAIS backward net asks for row K at the
//    last step: clamped. PIS embeds the time itself, its tables have K + 1
//    rows, unclamped (the JAX package calls it at t = K).
//  * GATE: the PIS nets' per-warp sums of dds_grad's gate gradient (D slots
//    beside the scalars of Slots, one per state dimension).
// The output (factor_sn, or the clip and the gate term) is net_out below.
struct GeffnerNet {
  static constexpr bool RESIDUAL = true, PIS = false;
  __host__ __device__ static constexpr int gate_slots(int) { return 0; }
  __device__ static float act(float a) { return softplus_f(a); }
  __device__ static float dact(float a) { return sigmoid_f(a); }
  __host__ __device__ static int row(int idx, int k) { return idx < k - 1 ? idx : k - 1; }
};

struct PisNet {
  static constexpr bool RESIDUAL = false, PIS = true;
  __host__ __device__ static constexpr int gate_slots(int d) { return d; }
  __device__ static float act(float a) { return gelu_f(a); }
  __device__ static float dact(float a) { return dgelu_f(a); }
  __host__ __device__ static int row(int idx, int) { return idx; }
};

// The net's output in dimension d from its head's raw output plus bias o:
// geffner o * factor; PIS clip(o, 1e4) plus, with a gate row (dds_grad),
// gate_row[d] * clip(gt_d, 1e2) for the target score gt_d at the net's z.
template <class NET>
__device__ __forceinline__ float net_out(float o, float factor, const float* gate_row, int d,
                                         float gt_d) {
  if constexpr (NET::PIS) {
    const float s = clip_f(o, PIS_OUT_CLIP);
    return gate_row != nullptr ? s + gate_row[d] * clip_f(gt_d, PIS_GATE_CLIP) : s;
  } else {
    return o * factor;
  }
}

// The cotangent of the head's raw output from that of the net's output:
// geffner g * factor; PIS g where the clip passed o, else 0.
template <class NET>
__device__ __forceinline__ float net_out_cot(float g, float o, float factor) {
  if constexpr (NET::PIS) {
    return o == clip_f(o, PIS_OUT_CLIP) ? g : 0.f;
  } else {
    return g * factor;
  }
}

// The eps schedule: 0 constant, 1 linear, 2 cos_sq. eps_i = eps0 * eps_slope
// + eps_offset with both independent of eps0, so d eps_i / d eps0 = eps_slope.
__device__ __forceinline__ float eps_slope(int i, int k, int sched) {
  if (sched == 2) {  // cos_sq
    const float phase = (float)i / (float)k;
    const float c = cosf((phase + 0.008f) / 1.008f * 0.5f * 3.14159265358979f);
    return c * c;
  }
  if (sched == 1) return 1.0f - (float)i / (float)(k - 1);  // linear
  return 1.0f;
}

__device__ __forceinline__ float eps_at(float eps0, int i, int k, int sched) {
  if (sched == 2) return eps0 * eps_slope(i, k, sched);
  if (sched == 1) return (1e-4f - eps0) / (float)(k - 1) * (float)i + eps0;
  return eps0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Philox4x32-10 (Salmon et al., SC'11) on counter c with key (k0, k1).
__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c[0], hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2], hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
}

// The two standard normals of (chain, step): Box-Muller on two Philox words.
// `pair` (the third counter word) numbers further pairs of one draw beyond
// two dimensions (philox_normals).
__device__ __forceinline__ float2 philox_normal2(unsigned long long seed, uint32_t chain,
                                                 uint32_t step, uint32_t pair = 0u) {
  uint32_t c[4] = {chain, step, pair, 0u};
  philox4x32_10(c, (uint32_t)seed, (uint32_t)(seed >> 32));
  const float u1 = (float)((c[0] >> 8) + 1u) * (1.0f / 16777216.0f);  // (0, 1]
  const float u2 = (float)(c[1] >> 8) * (1.0f / 16777216.0f);         // [0, 1)
  const float r = sqrtf(-2.0f * logf(u1));
  float s, co;
  sincospif(2.0f * u2, &s, &co);
  return make_float2(r * co, r * s);
}

// The D standard normals of (chain, step): dimensions 2q and 2q + 1 from
// pair q, so D = 2 takes pair 0 alone and every kernel that makes a step's
// draw again (the rollouts, the re-rolling backward) gets the same numbers.
template <int D>
__device__ __forceinline__ void philox_normals(unsigned long long seed, uint32_t chain,
                                               uint32_t step, float xi[D]) {
#pragma unroll
  for (int d = 0; d < D; d += 2) {
    const float2 g = philox_normal2(seed, chain, step, (uint32_t)(d / 2));
    xi[d] = g.x;
    if (d + 1 < D) xi[d + 1] = g.y;
  }
}

// Copies W2 (in x in, row k = input feature k) into shared memory with row
// stride `ws`, zero beyond in_dim; every thread of the block calls it.
__device__ __forceinline__ void load_w2(const NetArgs& net, float* w2s, int ws) {
  const int ip = net.in_pad, in = net.in_dim;
  for (int idx = threadIdx.x; idx < ip * ws; idx += blockDim.x) {
    const int k = idx / ws, f = idx - k * ws;
    w2s[idx] = (k < in && f < in) ? net.w2[k * in + f] : 0.f;
  }
}

// Row f of W1[:DIN] (this thread's feature), zero past in_dim.
template <int DIN>
__device__ __forceinline__ void load_w1x(const NetArgs& net, int f, float w1x[DIN]) {
#pragma unroll
  for (int d = 0; d < DIN; ++d) w1x[d] = f < net.in_dim ? net.w1z[d * net.in_dim + f] : 0.f;
}

// Layer 1 for feature f of TC chains at table row idx: a1 and h1, geffner
// h0 + softplus(a1) with h0 = [x, emb_idx], PIS gelu(a1). xs: TC x DIN inputs.
template <int DIN, class NET = GeffnerNet>
__device__ __forceinline__ void layer1_feature(const NetArgs& net, int idx, int f,
                                               const float w1x[DIN], const float* xs,
                                               float a1[TC], float h1[TC]) {
  const float cf = net.c1[(size_t)idx * net.in_dim + f];
  float e = 0.f;
  if constexpr (NET::RESIDUAL) e = f >= DIN ? net.emb[(size_t)idx * net.emb_dim + f - DIN] : 0.f;
#pragma unroll
  for (int c = 0; c < TC; ++c) {
    float acc = cf, h0 = e;
#pragma unroll
    for (int d = 0; d < DIN; ++d) {
      const float x = xs[c * DIN + d];
      acc = fmaf(x, w1x[d], acc);
      if (f == d) h0 = x;
    }
    a1[c] = acc;
    if constexpr (NET::RESIDUAL) {
      h1[c] = h0 + softplus_f(a1[c]);
    } else {
      h1[c] = NET::act(a1[c]);
    }
  }
}

// acc[c] = sum_k hs[c][k] * w2s[k][f] for TC chains: hs has row stride ip (a
// multiple of 4, zero beyond in_dim), w2s row stride ws.
__device__ __forceinline__ void layer2_feature(const float* w2s, int ws, const float* hs,
                                               int ip, int f, float acc[TC]) {
#pragma unroll
  for (int c = 0; c < TC; ++c) acc[c] = 0.f;
#pragma unroll 2
  for (int k = 0; k < ip; k += 4) {
    const float wa = w2s[(k + 0) * ws + f];
    const float wb = w2s[(k + 1) * ws + f];
    const float wc = w2s[(k + 2) * ws + f];
    const float wd = w2s[(k + 3) * ws + f];
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      const float4 h = *reinterpret_cast<const float4*>(hs + c * ip + k);
      acc[c] = fmaf(h.x, wa, acc[c]);
      acc[c] = fmaf(h.y, wb, acc[c]);
      acc[c] = fmaf(h.z, wc, acc[c]);
      acc[c] = fmaf(h.w, wd, acc[c]);
    }
  }
}

// One warp, one chain: the head's D raw outputs h2 . headW[d] (no bias, no
// factor). h2: the chain's in_dim hidden values; hws: D x in_pad head rows.
// All lanes return the same values.
template <int D>
__device__ __forceinline__ void head_raw(const NetArgs& net, const float* h2,
                                         const float* hws, float out[D]) {
  const int lane = threadIdx.x & 31, ip = net.in_pad;
  float s[D];
#pragma unroll
  for (int d = 0; d < D; ++d) s[d] = 0.f;
  for (int k = lane; k < net.in_dim; k += 32) {
    const float h = h2[k];
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = fmaf(h, hws[d * ip + k], s[d]);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) out[d] = warp_sum(s[d]);
}

// What a lane keeps of the score for the Hessian product: its two components'
// softmax weights r and offsets d = m_k - x (zero past n_mix).
struct ScoreLanes {
  float r[2], dx[2], dy[2];
};

// One warp, one chain: the many_gmm score at (x0, x1) from the n_mix x 2
// means in mus, two components per lane, a = inv_var. All lanes return the
// same gt; with `sl` each lane also returns its own two components.
__device__ __forceinline__ void many_gmm_score(const float* mus, int n_mix, float a, float x0,
                                               float x1, float gt[2],
                                               ScoreLanes* sl = nullptr) {
  const int lane = threadIdx.x & 31;
  float l0 = -INFINITY, l1 = -INFINITY;
  float dx0 = 0.f, dy0 = 0.f, dx1 = 0.f, dy1 = 0.f;
  const int j0 = lane, j1 = lane + 32;
  if (j0 < n_mix) {
    dx0 = x0 - mus[2 * j0], dy0 = x1 - mus[2 * j0 + 1];
    l0 = -0.5f * a * (dx0 * dx0 + dy0 * dy0);
  }
  if (j1 < n_mix) {
    dx1 = x0 - mus[2 * j1], dy1 = x1 - mus[2 * j1 + 1];
    l1 = -0.5f * a * (dx1 * dx1 + dy1 * dy1);
  }
  const float m = warp_max(fmaxf(l0, l1));
  const float e0 = j0 < n_mix ? expf(l0 - m) : 0.f;
  const float e1 = j1 < n_mix ? expf(l1 - m) : 0.f;
  float sum = e0 + e1;
  float a0 = (j0 < n_mix ? e0 * mus[2 * j0] : 0.f) + (j1 < n_mix ? e1 * mus[2 * j1] : 0.f);
  float a1 = (j0 < n_mix ? e0 * mus[2 * j0 + 1] : 0.f) +
             (j1 < n_mix ? e1 * mus[2 * j1 + 1] : 0.f);
  sum = warp_sum(sum);
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  gt[0] = a * (a0 / sum - x0);
  gt[1] = a * (a1 / sum - x1);
  if (sl != nullptr) {
    sl->r[0] = e0 / sum, sl->r[1] = e1 / sum;
    sl->dx[0] = -dx0, sl->dy[0] = -dy0;
    sl->dx[1] = -dx1, sl->dy[1] = -dy1;
  }
}

// One warp, one chain: the score's Jacobian-transpose product H v at the
// point whose lanes are in sl (the Hessian of log p is symmetric),
//   H v = -a v + a^2 sum_k r_k c_k (c_k . v),  c_k = d_k - sum_i r_i d_i,
// the centred form of sum r d d^T - (sum r d)(sum r d)^T: between modes
// |d_k| reaches 40 sqrt(2) and the uncentred sums cancel. All lanes return
// the same hv.
__device__ __forceinline__ void many_gmm_hvp(float a, const ScoreLanes& sl, const float v[2],
                                             float hv[2]) {
  const float sx = warp_sum(sl.r[0] * sl.dx[0] + sl.r[1] * sl.dx[1]);
  const float sy = warp_sum(sl.r[0] * sl.dy[0] + sl.r[1] * sl.dy[1]);
  float tx = 0.f, ty = 0.f;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float cx = sl.dx[q] - sx, cy = sl.dy[q] - sy;
    const float w = sl.r[q] * (cx * v[0] + cy * v[1]);
    tx = fmaf(w, cx, tx);
    ty = fmaf(w, cy, ty);
  }
  tx = warp_sum(tx);
  ty = warp_sum(ty);
  hv[0] = a * (a * tx - v[0]);
  hv[1] = a * (a * ty - v[1]);
}

// What a lane keeps of the 3-mode gmm score for the Hessian product: its
// (component, branch) pair's responsibility r and gradient g (x's
// coordinates), the pair's number and the score gt itself.
struct Gmm3Lanes {
  float r, g[2], gt[2];
  int b;
};

// The constants of the 3-mode gmm in `par` (18 floats): the means (3 x 2),
// the precisions (p11, p12, p22) per component, the log-normalisers (3).
// Pair b < 3 is component b at x, pair b >= 3 component b - 3 at the swapped
// point S x; its precision in x's coordinates is S P S, its gradient the
// component's swapped back.
__device__ __forceinline__ void gmm3_pair(const float* par, int b, float x0, float x1,
                                          float* logp, float g[2]) {
  const int k = b % 3;
  const bool sw = b >= 3;
  const float u0 = sw ? x1 : x0, u1 = sw ? x0 : x1;
  const float p11 = par[6 + 3 * k], p12 = par[7 + 3 * k], p22 = par[8 + 3 * k];
  const float d0 = u0 - par[2 * k], d1 = u1 - par[2 * k + 1];
  const float y0 = p11 * d0 + p12 * d1, y1 = p12 * d0 + p22 * d1;
  *logp = -0.5f * (d0 * y0 + d1 * y1) + par[15 + k];
  g[0] = sw ? -y1 : -y0;
  g[1] = sw ? -y0 : -y1;
}

// One warp, one chain: the 3-mode gmm score at (x0, x1), lanes 0..5 one
// (component, branch) pair each: gt = sum_b r_b g_b with r the softmax of the
// pairs' log-densities (their equal weights cancel). All lanes return the
// same gt; with `sl` each lane also returns its pair.
__device__ __forceinline__ void gmm3_score(const float* par, float x0, float x1, float gt[2],
                                           Gmm3Lanes* sl = nullptr) {
  const int lane = threadIdx.x & 31;
  const bool on = lane < 6;
  float l = -INFINITY, g[2] = {0.f, 0.f};
  if (on) gmm3_pair(par, lane, x0, x1, &l, g);
  const float m = warp_max(l);
  const float e = on ? expf(l - m) : 0.f;
  const float sum = warp_sum(e);
  gt[0] = warp_sum(e * g[0]) / sum;
  gt[1] = warp_sum(e * g[1]) / sum;
  if (sl != nullptr) {
    sl->r = e / sum;
    sl->g[0] = g[0], sl->g[1] = g[1];
    sl->gt[0] = gt[0], sl->gt[1] = gt[1];
    sl->b = lane;
  }
}

// One warp, one chain: the gmm score's Jacobian applied to v at the point
// whose lanes are in sl (the Hessian of log p is symmetric),
//   H v = sum_b r_b (c_b (c_b . v) - P_b v),  c_b = g_b - gt,
// the centred form of sum_b r_b (g_b g_b^T - P_b) v - gt (gt . v). All lanes
// return the same hv.
__device__ __forceinline__ void gmm3_hvp(const float* par, const Gmm3Lanes& sl,
                                         const float v[2], float hv[2]) {
  float tx = 0.f, ty = 0.f;
  if (sl.b < 6) {
    const int k = sl.b % 3;
    const bool sw = sl.b >= 3;
    const float p11 = par[6 + 3 * k], p12 = par[7 + 3 * k], p22 = par[8 + 3 * k];
    const float q11 = sw ? p22 : p11, q22 = sw ? p11 : p22;
    const float cx = sl.g[0] - sl.gt[0], cy = sl.g[1] - sl.gt[1];
    const float cv = cx * v[0] + cy * v[1];
    tx = sl.r * (cv * cx - (q11 * v[0] + p12 * v[1]));
    ty = sl.r * (cv * cy - (p12 * v[0] + q22 * v[1]));
  }
  hv[0] = warp_sum(tx);
  hv[1] = warp_sum(ty);
}

// Neal's funnel, v = x[0], x[1:] | v ~ N(0, e^v I): what each lane keeps for
// the Hessian product (every lane holds the whole point: a chain's score is
// O(D) work, below the latency of a warp reduction, so the lanes compute it
// alike and nothing is exchanged).
template <int D>
struct FunnelLanes {
  float ev, sx2, x[D];  // e^{-v}, sum_{j>=1} x_j^2, the point
};

// One chain (each lane alike): the funnel's score at x, sig its v scale,
//   d/dv = -v / sig^2 + e^{-v} sum x_j^2 / 2 - (D - 1) / 2,  d/dx_j = -x_j e^{-v},
// e^{-v} unclipped (cmcd_tpu/ops/target_grads.py::make_funnel_grad_t).
template <int D>
__device__ __forceinline__ void funnel_score(float sig, const float x[D], float gt[D],
                                             FunnelLanes<D>* sl) {
  const float v = x[0], ev = expf(-v);
  float sx2 = 0.f;
#pragma unroll
  for (int j = 1; j < D; ++j) sx2 += x[j] * x[j];
  gt[0] = -v / (sig * sig) + 0.5f * ev * sx2 - 0.5f * (float)(D - 1);
#pragma unroll
  for (int j = 1; j < D; ++j) gt[j] = -x[j] * ev;
  if (sl != nullptr) {
    sl->ev = ev, sl->sx2 = sx2;
#pragma unroll
    for (int d = 0; d < D; ++d) sl->x[d] = x[d];
  }
}

// The funnel's Hessian applied to u at the point of sl (the Pallas sweep
// traces it with jax.vjp and never states it):
//   (H u)_0 = (-1/sig^2 - e^{-v} sum x_j^2 / 2) u_0 + e^{-v} sum_j x_j u_j
//   (H u)_j = e^{-v} (x_j u_0 - u_j)
template <int D>
__device__ __forceinline__ void funnel_hvp(float sig, const FunnelLanes<D>& sl, const float u[D],
                                           float hu[D]) {
  float xu = 0.f;
#pragma unroll
  for (int j = 1; j < D; ++j) xu += sl.x[j] * u[j];
  hu[0] = (-1.0f / (sig * sig) - 0.5f * sl.ev * sl.sx2) * u[0] + sl.ev * xu;
#pragma unroll
  for (int j = 1; j < D; ++j) hu[j] = sl.ev * (sl.x[j] * u[0] - u[j]);
}

// The targets as template parameters of every kernel: the state dimension
// D, what a lane keeps for the Hessian product (Lanes), the score and its
// Hessian product for one chain per warp. `par` holds the target's n_par
// constants (many_gmm: the n_par / 2 means), inv_var many_gmm's 1 / scale^2.
struct ManyGmmTarget {
  static constexpr int D = 2;
  using Lanes = ScoreLanes;
  const float* par;
  int n_mix;
  float inv_var;
  __device__ ManyGmmTarget(const float* p, int n_par, float iv)
      : par(p), n_mix(n_par / 2), inv_var(iv) {}
  __device__ void score(const float x[D], float gt[D], Lanes* sl = nullptr) const {
    many_gmm_score(par, n_mix, inv_var, x[0], x[1], gt, sl);
  }
  __device__ void hvp(const Lanes& sl, const float v[D], float hv[D]) const {
    many_gmm_hvp(inv_var, sl, v, hv);
  }
};

struct Gmm3Target {
  static constexpr int D = 2;
  using Lanes = Gmm3Lanes;
  const float* par;
  __device__ Gmm3Target(const float* p, int, float) : par(p) {}
  __device__ void score(const float x[D], float gt[D], Lanes* sl = nullptr) const {
    gmm3_score(par, x[0], x[1], gt, sl);
  }
  __device__ void hvp(const Lanes& sl, const float v[D], float hv[D]) const {
    gmm3_hvp(par, sl, v, hv);
  }
};

// The funnel at the recipes' dimension (funnel_k8, config funnel_d 10). par
// (its sig) is read at each use: a kernel builds its target before the
// block has copied the constants into shared memory.
struct FunnelTarget {
  static constexpr int D = 10;
  using Lanes = FunnelLanes<D>;
  const float* par;
  __device__ FunnelTarget(const float* p, int, float) : par(p) {}
  __device__ void score(const float x[D], float gt[D], Lanes* sl = nullptr) const {
    funnel_score<D>(par[0], x, gt, sl);
  }
  __device__ void hvp(const Lanes& sl, const float u[D], float hu[D]) const {
    funnel_hvp<D>(par[0], sl, u, hu);
  }
};

// The standard normal (par: its precision a, 1): score -a x, H u = -a u; the
// closed-form check of the D-dimensional kernels.
template <int DD>
struct StdNormalTarget {
  static constexpr int D = DD;
  struct Lanes {};
  const float* par;
  __device__ StdNormalTarget(const float* p, int, float) : par(p) {}
  __device__ void score(const float x[D], float gt[D], Lanes* = nullptr) const {
#pragma unroll
    for (int d = 0; d < D; ++d) gt[d] = -par[0] * x[d];
  }
  __device__ void hvp(const Lanes&, const float u[D], float hu[D]) const {
#pragma unroll
    for (int d = 0; d < D; ++d) hu[d] = -par[0] * u[d];
  }
};

// Bayesian logistic regression, w ~ N(0, I / a), y_i ~ Bernoulli(sigmoid(x_i . w))
// (cmcd_tpu/ops/target_grads.py::make_logreg_grad_t, a = 1):
//   score  g = -a w + X^T (y - sigmoid(X w))
//   H u    = -a u - X^T (s * X u),  s_i = sigmoid(l_i) sigmoid(-l_i),  l = X w
// The dataset (n_data rows of D features, the bias column first) is 41-51 KB
// at the three instances, past the MAX_PAR floats of shared memory the
// constants get, so it stays in device memory and is read in place: the
// kernels' read-only loads keep it in the SM's L1 cache, beside a tile of at
// most 220 KB of shared memory at the largest D; staging it in shared memory
// would cost every block 41-51 KB more and the backward tile at D = 61 would
// no longer fit. It is laid out feature-major (X^T, then y), so the lanes of a
// warp, one data row each, read 32 neighbouring floats of one feature.
//
// One warp per chain: lane j takes rows j, j + 32, ... (R = ceil(n_data / 32)
// at most), forms l_i = x_i . w from the chain's point, r_i = y_i -
// sigmoid(l_i) with one exp, and adds r_i x_i into D sums that D warp
// reductions close. For the Hessian product a lane keeps only s_i of its own
// rows (Lanes: R floats, 22 at australian's 690 rows); X u is formed again
// from the data, not kept per lane (D x R floats would spill).
template <int DD, int R>
struct LogregTarget {
  static constexpr int D = DD;
  static constexpr int MAX_ROWS = 32 * R;  // the most data rows the lanes take
  struct Lanes {
    float s[R];  // sigmoid(l) sigmoid(-l) of the lane's rows, 0 past n_data
  };
  const float* par;  // the prior precision a (read at each use: see FunnelTarget)
  const float* xt;   // D x n_data
  const float* y;    // n_data
  int n;
  __device__ LogregTarget(const float* p, const float* data, int n_data)
      : par(p), xt(data), y(data + (size_t)DD * n_data), n(n_data) {}

  __device__ void score(const float w[D], float gt[D], Lanes* sl = nullptr) const {
    const int lane = threadIdx.x & 31;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + 32 * q;
      float s = 0.f;
      if (i < n) {
        float l = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) l = fmaf(__ldg(xt + (size_t)d * n + i), w[d], l);
        const float e = expf(-fabsf(l)), inv = 1.0f / (1.0f + e);
        const float sig = l >= 0.f ? inv : e * inv;
        const float r = __ldg(y + i) - sig;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(r, __ldg(xt + (size_t)d * n + i), acc[d]);
        s = e * inv * inv;
      }
      if (sl != nullptr) sl->s[q] = s;
    }
    const float a = par[0];
#pragma unroll
    for (int d = 0; d < D; ++d) gt[d] = warp_sum(acc[d]) - a * w[d];
  }

  __device__ void hvp(const Lanes& sl, const float u[D], float hu[D]) const {
    const int lane = threadIdx.x & 31;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = lane + 32 * q;
      if (i < n) {
        float t = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) t = fmaf(__ldg(xt + (size_t)d * n + i), u[d], t);
        t *= sl.s[q];
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(t, __ldg(xt + (size_t)d * n + i), acc[d]);
      }
    }
    const float a = par[0];
#pragma unroll
    for (int d = 0; d < D; ++d) hu[d] = -a * u[d] - warp_sum(acc[d]);
  }
};

// The three datasets' instances (ops/target_grads.KERNEL_DIMS): australian
// 690 rows of 15, ionosphere 351 of 35, sonar 208 of 61.
using LogregAustralian = LogregTarget<15, 22>;
using LogregIonosphere = LogregTarget<35, 11>;
using LogregSonar = LogregTarget<61, 7>;

// A kernel builds its target from the block's copy of the constants (par)
// and the launch's NetArgs: a logistic regression also takes the dataset.
template <class T>
struct TargetData {
  static constexpr bool value = false;
};
template <int DD, int R>
struct TargetData<LogregTarget<DD, R>> {
  static constexpr bool value = true;
};

template <class T>
__device__ __forceinline__ T make_target(const float* par, const NetArgs& net) {
  if constexpr (TargetData<T>::value) {
    return T(par, net.tdata, net.n_data);
  } else {
    return T(par, net.n_par, net.inv_var_t);
  }
}

// MCD_DNF's kernels have no target in the bridge (zero drift): the state's
// dimension alone. point_eval takes one and, called with no score points,
// never asks it for a score.
template <int DD>
struct NoTarget {
  static constexpr int D = DD;
  struct Lanes {};
  __device__ void score(const float*, float gt[D], Lanes* = nullptr) const {
#pragma unroll
    for (int d = 0; d < D; ++d) gt[d] = 0.f;
  }
};

// A launch's net: arch 0 the geffner net (in_dim = din + emb_dim, no gate
// table), 1 a PIS net (in_dim its width F, emb_dim 0, the gate table of
// dds_grad or null).
__host__ inline bool net_ok(int arch, int in_dim, int emb_dim, int din, const float* gate) {
  if (arch == 0) return in_dim == din + emb_dim && gate == nullptr;
  return arch == 1 && emb_dim == 0;
}

// Calls f(NetTag<NET>{}) with the net policy of arch (net_ok).
template <class N>
struct NetTag {
  using type = N;
};

template <class F>
__host__ inline cudaError_t dispatch_net(int arch, F f) {
  return arch == 0 ? f(NetTag<GeffnerNet>{}) : f(NetTag<PisNet>{});
}

// The state dimension of a launch's target code (ops/target_grads.TARGETS).
__host__ inline int target_dim(int target) {
  switch (target) {
    case 0: case 1: return ManyGmmTarget::D;
    case 6: return LogregAustralian::D;
    case 7: return LogregIonosphere::D;
    case 8: return LogregSonar::D;
    default: return FunnelTarget::D;
  }
}

// Calls f(TargetTag<T>{}) with the template of target code `target`.
template <class T>
struct TargetTag {
  using type = T;
};

// STD_NORMAL false: the kernels instantiated for the three targets of the
// recipes only (the underdamped ones), code 3 refused.
template <bool STD_NORMAL = true, class F>
__host__ inline cudaError_t dispatch_target(int target, F f) {
  switch (target) {
    case 0: return f(TargetTag<ManyGmmTarget>{});
    case 1: return f(TargetTag<Gmm3Target>{});
    case 2: return f(TargetTag<FunnelTarget>{});
    case 3:
      if constexpr (STD_NORMAL) return f(TargetTag<StdNormalTarget<10>>{});
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

// The logistic regressions (codes 6-8) have a dispatch of their own, so
// that only the sources that instantiate them (overdamped_logreg.cu,
// kl_logreg.cu) compile their kernels; dispatch_target refuses them.
// logreg_ok: the dataset a launch passes fits the instance's R rows a lane.
template <class F>
__host__ inline cudaError_t dispatch_logreg(int target, F f) {
  switch (target) {
    case 6: return f(TargetTag<LogregAustralian>{});
    case 7: return f(TargetTag<LogregIonosphere>{});
    case 8: return f(TargetTag<LogregSonar>{});
    default: return cudaErrorInvalidValue;
  }
}

__host__ inline bool logreg_ok(int target, const float* data, int n_data) {
  int rows = 0;
  dispatch_logreg(target, [&](auto tag) {
    rows = decltype(tag)::type::MAX_ROWS;
    return cudaSuccess;
  });
  return data != nullptr && n_data >= 1 && n_data <= rows;
}

// One warp per chain: the target score at the TC points in zs into gt_s
// (TC x D). Every thread of the block must call it; ends with a barrier.
template <class T>
__device__ __forceinline__ void score_eval(const T& target, const float* zs, float* gt_s) {
  constexpr int D = T::D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarp = blockDim.x >> 5;
  for (int c = warp; c < TC; c += nwarp) {
    float gt[D];
    target.score(zs + c * D, gt);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) gt_s[c * D + d] = gt[d];
    }
  }
  __syncthreads();
}

// Net output at the TC inputs in xin_s (TC x DIN), table row idx, and,
// unless zs is null, the target score at the TC points in zs (TC x D),
// by a block of round_up(in_dim, 32) threads; writes sn_s and gt_s (TC x
// D each). w2s has row stride in_pad; h1s, h2s are TC x in_pad tiles; hws
// the D x in_pad head rows. dds_grad's gate term reads the score at zs,
// which must then be the net's z. Every thread of the block must call it.
template <int DIN, class T, class NET = GeffnerNet>
__device__ __forceinline__ void point_eval(const NetArgs& net, int idx, const float w1x[DIN],
                                           float b2f, float factor,
                                           const float* w2s, float* h1s, float* h2s,
                                           const float* hws, const T& target,
                                           const float* xin_s, const float* zs, float* gt_s,
                                           float* sn_s) {
  constexpr int D = T::D;
  const int tid = threadIdx.x, ip = net.in_pad;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const bool feat = tid < net.in_dim;

  if (feat) {
    float a1[TC], h1[TC];
    layer1_feature<DIN, NET>(net, idx, tid, w1x, xin_s, a1, h1);
#pragma unroll
    for (int c = 0; c < TC; ++c) h1s[c * ip + tid] = h1[c];
  }
  __syncthreads();

  if (feat) {
    float acc[TC];
    layer2_feature(w2s, ip, h1s, ip, tid, acc);
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      if constexpr (NET::RESIDUAL) {
        h2s[c * ip + tid] = h1s[c * ip + tid] + softplus_f(acc[c] + b2f);
      } else {
        h2s[c * ip + tid] = NET::act(acc[c] + b2f);
      }
    }
  }
  __syncthreads();

  const float* gate_row = NET::PIS && net.gate != nullptr ? net.gate + (size_t)idx * D : nullptr;
  for (int c = warp; c < TC; c += nwarp) {
    float out[D], gt[D];
#pragma unroll
    for (int d = 0; d < D; ++d) gt[d] = 0.f;
    head_raw<D>(net, h2s + c * ip, hws, out);
    if (zs != nullptr) target.score(zs + c * D, gt);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        sn_s[c * D + d] = net_out<NET>(out[d] + net.headb[d], factor, gate_row, d, gt[d]);
        if (zs != nullptr) gt_s[c * D + d] = gt[d];
      }
    }
  }
  __syncthreads();
}

}  // namespace cmcd
