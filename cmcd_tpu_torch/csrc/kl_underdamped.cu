// Underdamped KL reverse sweep for NVIDIA Hopper (sm_90a): backprop through
// time of the leapfrog rollout's log-weight from its stored positions,
// momenta and draws.
//
// Replaces cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_underdamped (the TPU
// kernel "B7") for all seven underdamped specs: the approximate refresh
// (U_A_LP, U_A_LP_SNA, U_A_LP_SN: no net, a net on z, a net on [z, rho']),
// the exact one (U_E_LP, U_E_LP_SNA), the exact forward with the
// approximate backward (U_EA_LP_SN) and CAIS_UHA (the net in both momentum
// kernels, the cosine eps schedule and the target score clipped at 1e2), on
// the many_gmm and 3-mode gmm targets (D = 2) and Neal's funnel (D = 10) with
// the two-layer geffner net. The Python wrapper is
// cmcd_tpu_torch/ops/kl_underdamped.py::evolve_kl_bwd_underdamped; its plain
// PyTorch version evolve_kl_bwd_underdamped_plain walks the same sweep. The
// TPU kernel traces jax.vjp of the step; here every derivative is written out.
//
// What it computes. z_p, rho_p (p = 0..K) and the draws xi_p (step p's
// refresh, row p + 1 of the stack) are data, c_n the cotangent of chain n's
// log-weight increments and g_K that of z_K:
//   L = sum_n [ c_n (sum_p delta_p - |rho_K|^2 / 2) + g_K . z_K ]
// Step p, with its scalars e (eps0, or eps0 s_p, s_p = cos^2 of the
// schedule, for CAIS_UHA), the refresh's factors cf, cb, scales s_f, s_b
// and the net's gain (the rollout's table, underdamped.cu):
//   rho'_p = cf rho_p - [CAIS_UHA] gain sn([z_p, rho_p], p) + s_f xi_p
//   rho''_p = rho'_p + (e / 2) D_p(z_p),  D_p(z) = b_p clip(gt(z)) + (1 - b_p) gq(z)
//   z_{p+1} = z_p + e rho''_p;  rho_{p+1} = rho''_p + (e / 2) D_p(z_{p+1})
//   bk_p = cb rho'_p + gain sn_p,  sn_p = sn(z_p, p), sn([z_p, rho'_p], p) or 0
//   r_p = (rho_p - bk_p) / s_b;  delta_p = -|r_p|^2 / 2 + |xi_p|^2 / 2 + D (log s_f - log s_b)
//   gq(z) = -(z - mu) exp(-2 logdiag);  clip at 1e2 for CAIS_UHA, none else
// differentiated in theta = (eps0, gamma, eta, betas, mu, logdiag, net) and
// in z_0 with nothing stopped (-log N(rho_0) is a draw's and gets nothing).
// The scalars depend on one parameter th of the refresh: a = gamma e
// (approx, CAIS_UHA; a_p per point under the schedule), a = gamma eps0
// (exact_fwd) or eta (exact), whose cotangent g_th the sweep collects per
// point from those of cf, cb, gain, s_f, s_b (StepScal below: their
// derivatives in th) and hands on as d th / d eps0 and d th / d gamma (or
// d eta) times g_th. The log-normalisers cancel except under exact_fwd,
// whose s_f and s_b differ. Each point p = K..0 is visited once: the score
// at z_p serves step p's first half-kick (b_p) and step p - 1's second
// (b_{p-1}), and step p's nets are applied and transposed at point p.
// Carried from point p + 1: GZ, the cotangent z_p gets from
// z_{p+1} = z_p + e rho''_p, and GR, that of rho''_p. At point p:
//   step p (p <= K - 1)
//     B = c r_p / s_b (cotangent of bk_p);  g_sn = gain B  -> net VJP: weights, g_x
//     g_th += (dcb rho'_p + dgain sn_p) . B + s_b' c |r_p|^2 / s_b
//     Grho' = GR + cb B + g_x[rho']
//     CAIS_UHA: g_snf = -gain Grho' -> forward net VJP at [z_p, rho_p]: weights, g_f;
//               g_th += -dgain snf . Grho'
//     g_th += dcf rho_p . Grho' + s_f' xi_p . Grho'  (s' = d s / d th)
//     Grho_p = cf Grho' - B + g_f[rho];  Z = GZ + g_x[z] + g_f[z]
//     first half-kick: g_e += D_p(z_p) . GR / 2;  g_b_p += (e / 2) (clip(gt) - gq) . GR
//                      g_gt += (e / 2) b_p GR;  g_gq += (e / 2) (1 - b_p) GR
//   point K: Grho_K = -c rho_K;  Z = g_K
//   step p - 1's second half-kick (p >= 1), e of step p - 1:
//                      g_e += D_{p-1}(z_p) . Grho_p / 2
//                      g_b_{p-1} += (e / 2) (clip(gt) - gq) . Grho_p
//                      g_gt += (e / 2) b_{p-1} Grho_p;  g_gq += (e / 2) (1 - b_{p-1}) Grho_p
//   vd      g_mu += exp(-2 logdiag) g_gq;  g_logdiag += -2 gq g_gq
//   state   T = Z - exp(-2 logdiag) g_gq + H(z_p) (m g_gt)  (one Hessian product for both
//           half-kicks, by linearity; m = [|gt| <= 1e2] the clip's mask, 1 without clip)
//   p >= 1  rho''_{p-1} = rho_p - (e / 2) D_{p-1}(z_p);  g_e += rho''_{p-1} . T
//           GZ <- T;  GR <- Grho_p + e T
//   p = 0   dL/dz_0 = T
// and g_eps0 collects each step's g_e times d e / d eps0 (s_p or 1).
//
// What bounds it on the H100. Per point and chain (full net, in_dim 134) one
// net apply, W2 g_a2 and the dW2 outer product, 3 x in_dim^2 FMAs (CAIS_UHA:
// three applies and two VJPs, 7 x in_dim^2), and the target's score and
// Hessian product; the three stacks are 12 D bytes per point: bound by FP32
// arithmetic and shared-memory bandwidth. The sweep is sequential along a
// chain, so only the chains run side by side.
//
// What the design does about it (B3's design, kl.cu):
//  * A block owns chain tiles b, b + B, ... and walks each from point K to
//    point 0 with the carries (GZ, GR: 2 D floats per chain) in shared
//    memory; the tile (cmcd_tile.cuh) holds W2 and the block's dW2, thread
//    (g, f) owns feature f for eight chains, 2 groups on 16-chain tiles while
//    32-chain tiles would leave SMs idle, else 4.
//  * The target (its D) and the net's input width (DIN = 0, D or 2 D) are
//    template parameters, and so is CAIS_UHA's form (the forward net, the
//    schedule, the clip): the input VJP returns the cotangents of z and of
//    rho'; without a net the block is one warp per eight chains and carries
//    no net code. The refresh is a runtime choice: approx, exact and
//    exact_fwd differ only in the step's scalars.
//  * CAIS_UHA's forward net sits at [z_p, rho_p] and its output feeds rho'_p,
//    the backward net's input: per point the forward net is applied, then
//    the backward net applied and transposed, then the forward net applied
//    again (the tile holds one net's activations) and transposed; both VJPs
//    add into the same weight sums. Recomputing costs one apply a point and
//    stores nothing more than the other forms.
//  * Per-chain passes, one warp per chain: before the VJP the backward
//    mean and its cotangent (they need only the net's output), after it the
//    score, both half-kicks, one Hessian product and the carries.
//  * Per-point sums (the betas, G1, GH1) leave the block after every point,
//    the rest after its whole walk; partials_reduce adds the blocks' partials
//    in block order: no atomics. The refresh parameter's gradient takes the
//    sums' gamma slot (Slots<D>::GAMMA): gamma's, or eta's for the exact
//    refresh, which is the only one that reads eta and never gamma.
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.

#include "cmcd_tile.cuh"

namespace {

using namespace cmcd;

constexpr float CAIS_CLIP = 1e2f;  // CAIS_UHA's target score clip

struct UdKlArgs {
  const float* ztraj;       // (K + 1, n, D)
  const float* rtraj;       // (K + 1, n, D)
  const float* noise;       // (K + 1, n, D): row p + 1 the draw of step p
  const float* cot;         // (n,)
  const float* g_zfinal;    // (n, D)
  const float* betas;       // (K,)
  const float* scal;        // [eps0, factor_sn, gamma, eta]
  NetArgs net;
  const float* vd_mean;     // (D,)
  const float* vd_logdiag;  // (D,)
  float* part_a;            // (blocks, len_a)
  float* part_b;            // (K + 1, blocks, len_b)
  float* g_z0;              // (n, D)
  int n, nbridges, refresh;
};

// Floats of shared memory per chain beside the tile, for a d-dimensional
// target: z_p, rho_p, xi_p, rho'_p, g_out, B, the carries GZ and GR, and for
// CAIS_UHA the forward net's raw output, Grho' and the backward net's g_x[z]
// (d each); the net's input (2 d) and the cotangent c. Per warp: its share
// of the net's input VJP for a group's chains (TC x 2 d).
__host__ __device__ constexpr int chain_floats(int d) { return 13 * d + 1; }
__host__ __device__ constexpr int warp_floats(int d) { return TC * 2 * d; }

// Shared memory of one block of NG groups (one layout for every form).
__host__ inline size_t smem_bytes(int ng, int in_dim, int n_par, int d) {
  return (tile_floats(ng, in_dim, n_par, d) + (size_t)chain_floats(d) * ng * TC +
          (size_t)(ng * FW_MAX / 32) * warp_floats(d)) * sizeof(float);
}

// What one block holds (NG = 4, the larger of the two forms); in_dim 0: no net.
__host__ inline bool fits(int in_dim, int n_par, int d) {
  return in_dim >= 0 && round_up(in_dim, 32) <= FW_MAX && n_par >= 1 && n_par <= MAX_PAR &&
         smem_bytes(4, in_dim, n_par, d) <= MAX_SMEM;
}

// Step p's scalars (uniform over the block) and their derivatives in the
// refresh's parameter th: a = gamma e (approx; e = eps0 sl, sl the
// schedule's factor, 1 without one), a = gamma eps0 (exact_fwd) or eta
// (exact).
struct StepScal {
  float e, cf, sf, cb, gain, sb;  // the step's values
  float kcf, kcb, kgain;          // d cf / d th, d cb / d th, d gain / d th
  float ksf, ksb;                 // s_f d s_f / d th, s_b d s_b / d th
  float th_e, th_g;               // d th / d eps0, d th / d gamma (d eta / d eta for exact)
};

__device__ __forceinline__ StepScal step_scalars(int refresh, float eps0, float gamma, float eta,
                                                 bool sched, float sl) {
  StepScal s;
  if (refresh == 1) {  // exact
    s.e = eps0;
    s.cf = s.cb = eta;
    s.sf = s.sb = sqrtf(1.0f - eta * eta);
    s.gain = 2.0f * (1.0f - eta);
    s.kcf = s.kcb = 1.0f;
    s.kgain = -2.0f;
    s.ksf = s.ksb = -eta;
    s.th_e = 0.f;
    s.th_g = 1.0f;
  } else if (refresh == 2) {  // exact_fwd: eta = exp(-gamma eps0)
    const float aux = gamma * eps0, ee = expf(-aux);
    s.e = eps0;
    s.cf = ee;
    s.sf = sqrtf(1.0f - ee * ee);
    s.cb = 1.0f - aux;
    s.gain = 2.0f * aux;
    s.sb = sqrtf(2.0f * aux);
    s.kcf = -ee;
    s.kcb = -1.0f;
    s.kgain = 2.0f;
    s.ksf = ee * ee;
    s.ksb = 1.0f;
    s.th_e = gamma;
    s.th_g = eps0;
  } else {  // approx
    s.e = sched ? eps0 * sl : eps0;
    const float aux = gamma * s.e;
    s.cf = s.cb = 1.0f - aux;
    s.sf = s.sb = sqrtf(2.0f * aux);
    s.gain = 2.0f * aux;
    s.kcf = s.kcb = -1.0f;
    s.kgain = 2.0f;
    s.ksf = s.ksb = 1.0f;
    s.th_e = sched ? gamma * sl : gamma;
    s.th_g = s.e;
  }
  return s;
}

template <int NG, class T, int DIN, bool CAIS>
__global__ void __launch_bounds__(NG* FW_MAX) kl_ud_sweep(const UdKlArgs a) {
  constexpr int D = T::D, XIN = 2 * D, TB = NG * TC;
  using S = Slots<D>;
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges;
  const Tile<NG, D> t(reinterpret_cast<float*>(smem4), net);
  const T target(t.par, net.n_par, net.inv_var_t);
  float* zc_s = t.rest;             // TB x D: z_p
  float* rc_s = zc_s + TB * D;      // TB x D: rho_p
  float* xi_s = rc_s + TB * D;      // TB x D: xi_p
  float* rp_s = xi_s + TB * D;      // TB x D: rho'_p
  float* go_s = rp_s + TB * D;      // TB x D: g_out (the backward net's, then the forward's)
  float* gb_s = go_s + TB * D;      // TB x D: B
  float* gz_c = gb_s + TB * D;      // TB x D: carry GZ
  float* gr_c = gz_c + TB * D;      // TB x D: carry GR
  float* of_s = gr_c + TB * D;      // TB x D: CAIS_UHA's forward net raw output
  float* grp_s = of_s + TB * D;     // TB x D: CAIS_UHA's Grho'
  float* gxb_s = grp_s + TB * D;    // TB x D: CAIS_UHA's backward g_x[z]
  float* xin_s = gxb_s + TB * D;    // TB x DIN: the net's input
  float* cot_s = xin_s + TB * XIN;  // TB
  float* gx_s = cot_s + TB;         // warps x TC x DIN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const FeatThread<D, DIN> th(net, NG);
  const float eps0 = a.scal[0], factor = a.scal[1], gamma = a.scal[2], eta = a.scal[3];
  float vm[D], viv[D], hb[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    vm[d] = a.vd_mean[d];
    viv[d] = expf(-2.0f * a.vd_logdiag[d]);
    hb[d] = DIN > 0 ? net.headb[d] : 0.f;
  }
  tile_init(t, net);
  float ft[nfeat(D, DIN)];
#pragma unroll
  for (int q = 0; q < nfeat(D, DIN); ++q) ft[q] = 0.f;
  float* sc = t.sc_s + warp * S::N;
  __syncthreads();

  const int ntiles = (a.n + TB - 1) / TB;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int base = tile * TB;
    for (int i = tid; i < TB * D; i += blockDim.x) {
      const bool live = base + i / D < a.n;
      gz_c[i] = live ? a.g_zfinal[(size_t)base * D + i] : 0.f;
      gr_c[i] = 0.f;
    }
    if (tid < TB) cot_s[tid] = base + tid < a.n ? a.cot[base + tid] : 0.f;

    for (int p = K; p >= 0; --p) {
      const bool m_f = p <= K - 1, m_b = p >= 1;  // step p starts here; step p - 1 ends here
      const float b_f = m_f ? a.betas[p] : 0.f, b_b = m_b ? a.betas[p - 1] : 0.f;
      const float sl_f = CAIS ? eps_slope(p, K, 2) : 1.0f;
      const float sl_b = CAIS && m_b ? eps_slope(p - 1, K, 2) : 1.0f;
      const StepScal st = step_scalars(a.refresh, eps0, gamma, eta, CAIS, sl_f);
      const float e_f = st.e, e_b = CAIS ? eps0 * sl_b : st.e;
      for (int i = tid; i < TB * D; i += blockDim.x) {
        const bool live = base + i / D < a.n;
        const size_t at = (size_t)base * D + i, row = (size_t)a.n * D;
        const float z = live ? a.ztraj[p * row + at] : 0.f;
        const float rho = live ? a.rtraj[p * row + at] : 0.f;
        const float xi = live && m_f ? a.noise[(p + 1) * row + at] : 0.f;
        zc_s[i] = z;
        rc_s[i] = rho;
        xi_s[i] = xi;
        rp_s[i] = rho * st.cf + st.sf * xi;  // CAIS_UHA: replaced once the forward net ran
        const int c = i / D, d = i - c * D;
        if constexpr (DIN > 0) xin_s[c * DIN + d] = z;
        if constexpr (DIN == XIN) xin_s[c * XIN + D + d] = CAIS ? rho : rho * st.cf + st.sf * xi;
      }
      __syncthreads();

      FeatRegs r;
      if constexpr (CAIS) {
        // The forward net at [z_p, rho_p]: rho'_p, and the backward net's input.
        if (m_f) {
          tile_layers(t, net, th, p, xin_s, r);
          for (int c = warp; c < TB; c += nwarp) {
            float out[D];
            head_raw<D>(net, t.xs + c * ip, t.hws, out);
            if (lane == 0) {
#pragma unroll
              for (int d = 0; d < D; ++d) {
                const float o = out[d] + hb[d], snf = o * factor;
                float fk = rc_s[c * D + d] * st.cf;
                fk = fk - st.gain * snf;
                const float rp = fk + st.sf * xi_s[c * D + d];
                of_s[c * D + d] = o;
                rp_s[c * D + d] = rp;
                xin_s[c * XIN + D + d] = rp;
              }
            }
          }
          __syncthreads();
        }
      }
      if constexpr (DIN > 0) {
        if (m_f) tile_layers(t, net, th, p, xin_s, r);
      }

      // Step p's backward mean and its cotangent B: one warp per chain,
      // every lane the same scalars, lane 0 keeps the sums.
      if (m_f) {
        for (int c = warp; c < TB; c += nwarp) {
          float out[D];
#pragma unroll
          for (int d = 0; d < D; ++d) out[d] = 0.f;
          if constexpr (DIN > 0) head_raw<D>(net, t.xs + c * ip, t.hws, out);
          const float cn = cot_s[c];
          float ga = 0.f, gs = 0.f, g_factor = 0.f, go[D], gb[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float o = out[d] + hb[d], sn = o * factor, rp = rp_s[c * D + d];
            float bk = rp * st.cb;
            if constexpr (DIN > 0) bk = bk + st.gain * sn;
            const float rr = (rc_s[c * D + d] - bk) / st.sb;
            gb[d] = cn * rr / st.sb;
            gs += cn * rr * rr;
            ga += st.kcb * rp * gb[d];
            const float gsn = st.gain * gb[d];
            if constexpr (DIN > 0) ga += st.kgain * sn * gb[d];
            g_factor += gsn * o;
            go[d] = gsn * factor;
          }
          if (lane == 0) {
            float gat = ga + st.ksb * (gs / (st.sb * st.sb));  // g_th with s_b's share
            if (a.refresh == 2)  // exact_fwd: D (log s_f - log s_b) of every chain
              gat += cn * (float)D * (st.ksf / (st.sf * st.sf) - st.ksb / (st.sb * st.sb));
            sc[S::EPS] += st.th_e * gat;
            sc[S::GAMMA] += st.th_g * gat;
            if constexpr (DIN > 0) sc[S::FACTOR] += g_factor;
#pragma unroll
            for (int d = 0; d < D; ++d) {
              if constexpr (DIN > 0) sc[S::HEADB + d] += go[d];
              go_s[c * D + d] = go[d];
              gb_s[c * D + d] = gb[d];
            }
          }
        }
      }
      __syncthreads();

      if constexpr (DIN > 0) {
        if (m_f) tile_vjp(t, net, th, xin_s, go_s, r, ft, gx_s);
      }

      if constexpr (CAIS) {
        // Grho' and the forward net's output cotangent; then the forward net
        // at [z_p, rho_p] again and its VJP.
        if (m_f) {
          for (int c = warp; c < TB; c += nwarp) {
            float ga = 0.f, g_factor = 0.f, gof[D];
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float grp = (gr_c[c * D + d] + st.cb * gb_s[c * D + d]) +
                                tile_gz<NG, DIN>(gx_s, c, D + d);
              const float o = of_s[c * D + d], snf = o * factor;
              const float gsnf = -st.gain * grp;
              ga -= st.kgain * snf * grp;
              g_factor += gsnf * o;
              gof[d] = gsnf * factor;
              if (lane == 0) {
                grp_s[c * D + d] = grp;
                gxb_s[c * D + d] = tile_gz<NG, DIN>(gx_s, c, d);
              }
            }
            if (lane == 0) {
              sc[S::EPS] += st.th_e * ga;
              sc[S::GAMMA] += st.th_g * ga;
              sc[S::FACTOR] += g_factor;
#pragma unroll
              for (int d = 0; d < D; ++d) {
                sc[S::HEADB + d] += gof[d];
                go_s[c * D + d] = gof[d];
                xin_s[c * XIN + D + d] = rc_s[c * D + d];
              }
            }
          }
          __syncthreads();
          tile_layers(t, net, th, p, xin_s, r);
          tile_vjp(t, net, th, xin_s, go_s, r, ft, gx_s);
        }
      }

      // The score, both half-kicks, the Hessian product and the carries.
      for (int c = warp; c < TB; c += nwarp) {
        float gt[D], gq[D], db[D], g_gt[D], g_gq[D], grho[D], tot[D], hv[D];
        typename T::Lanes sl;
        target.score(zc_s + c * D, gt, &sl);
        const float cn = cot_s[c];
        float ge = 0.f, geb = 0.f, ga = 0.f, gs = 0.f, gbf = 0.f, gbb = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float rho = rc_s[c * D + d];
          const float gtc = CAIS ? clip_f(gt[d], CAIS_CLIP) : gt[d];
          gq[d] = -(zc_s[c * D + d] - vm[d]) * viv[d];
          g_gt[d] = g_gq[d] = 0.f;
          if (m_f) {
            float gx_z = 0.f, gx_r = 0.f, grp;
            if constexpr (DIN > 0) gx_z = tile_gz<NG, DIN>(gx_s, c, d);
            if constexpr (DIN == XIN) gx_r = tile_gz<NG, DIN>(gx_s, c, D + d);
            const float gr2 = gr_c[c * D + d], gbk = gb_s[c * D + d];
            if constexpr (CAIS) {
              grp = grp_s[c * D + d];
            } else {
              grp = (gr2 + st.cb * gbk) + gx_r;
            }
            gs += xi_s[c * D + d] * grp;
            ga += st.kcf * rho * grp;
            grho[d] = st.cf * grp - gbk;
            tot[d] = gz_c[c * D + d] + gx_z;
            if constexpr (CAIS) {
              grho[d] = grho[d] + gx_r;
              tot[d] = tot[d] + gxb_s[c * D + d];
            }
            const float df = b_f * gtc + (1.0f - b_f) * gq[d];
            ge += 0.5f * df * gr2;
            gbf += 0.5f * e_f * (gtc - gq[d]) * gr2;
            g_gt[d] += 0.5f * e_f * b_f * gr2;
            g_gq[d] += 0.5f * e_f * (1.0f - b_f) * gr2;
          } else {
            grho[d] = -cn * rho;
            tot[d] = gz_c[c * D + d];
          }
          db[d] = b_b * gtc + (1.0f - b_b) * gq[d];
          if (m_b) {
            (CAIS ? geb : ge) += 0.5f * db[d] * grho[d];
            gbb += 0.5f * e_b * (gtc - gq[d]) * grho[d];
            g_gt[d] += 0.5f * e_b * b_b * grho[d];
            g_gq[d] += 0.5f * e_b * (1.0f - b_b) * grho[d];
          }
          // The clip's VJP: the score's cotangent passes where |gt| <= 1e2.
          if (CAIS && !(fabsf(gt[d]) <= CAIS_CLIP)) g_gt[d] = 0.f;
        }
        target.hvp(sl, g_gt, hv);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          tot[d] = (tot[d] - viv[d] * g_gq[d]) + hv[d];
          if (m_b) (CAIS ? geb : ge) += (rc_s[c * D + d] - 0.5f * e_b * db[d]) * tot[d];
        }
        if (lane == 0) {
          const float gat = m_f ? ga + (st.ksf * gs) / st.sf : 0.f;
          if constexpr (CAIS) {
            sc[S::EPS] += (sl_f * ge + sl_b * geb) + st.th_e * gat;
          } else {
            sc[S::EPS] += ge + st.th_e * gat;
          }
          sc[S::GAMMA] += st.th_g * gat;
          sc[S::BETA] += gbf;
          sc[S::BETA + 1] += gbb;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            sc[S::MEAN + d] += g_gq[d] * viv[d];
            sc[S::LOGDIAG + d] += g_gq[d] * (-2.0f * gq[d]);
            if (m_b) {
              gz_c[c * D + d] = tot[d];
              gr_c[c * D + d] = grho[d] + e_b * tot[d];
            } else if (base + c < a.n) {
              a.g_z0[(size_t)(base + c) * D + d] = tot[d];
            }
          }
        }
      }
      __syncthreads();
      flush_point(t, net, th, ft,
                  a.part_b + ((size_t)p * gridDim.x + blockIdx.x) * len_b(in),
                  tile != (int)blockIdx.x);
    }
  }

  flush_block(t, net, th, ft, a.part_a + (size_t)blockIdx.x * len_a(in, D, DIN));
}

template <int NG, class T, int DIN, bool CAIS>
cudaError_t launch_sweep(const UdKlArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(NG, a.net.in_dim, a.net.n_par, T::D);
  cudaError_t err = cudaFuncSetAttribute(kl_ud_sweep<NG, T, DIN, CAIS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int fw = DIN > 0 ? round_up(a.net.in_dim, 32) : 32;
  kl_ud_sweep<NG, T, DIN, CAIS><<<blocks, NG * fw, smem, stream>>>(a);
  return cudaGetLastError();
}

// form: 0 no net, 1 a net on z, 2 a net on [z, rho'], 3 CAIS_UHA.
template <int NG, class T>
cudaError_t launch_form(const UdKlArgs& a, int form, int blocks, cudaStream_t stream) {
  constexpr int D = T::D;
  if (form == 3) return launch_sweep<NG, T, 2 * D, true>(a, blocks, stream);
  if (form == 2) return launch_sweep<NG, T, 2 * D, false>(a, blocks, stream);
  if (form == 1) return launch_sweep<NG, T, D, false>(a, blocks, stream);
  return launch_sweep<NG, T, 0, false>(a, blocks, stream);
}

}  // namespace

extern "C" {

// Launches the sweep and its reduction on `stream`: `blocks` blocks of
// `groups` (2 or 4) groups of feature threads, blocks <= the number of chain
// tiles of 8 x groups chains. din: the net's input columns ahead of the
// embedding (0: no net, in_dim and emb_dim 0 and the weights null; D: z;
// 2 D: [z, rho']); cais: CAIS_UHA (din 2 D, refresh 0). target as in
// cmcd_underdamped_rollout (underdamped.cu); refresh: 0 approx, 1 exact,
// 2 exact_fwd. part_a: (blocks, len_a) and part_b: (points, blocks, len_b)
// are scratch; out_a: (len_a,), out_b: (points, len_b) and g_z0: (n, D)
// receive the results. Returns a cudaError_t.
int cmcd_kl_ud_sweep(const float* ztraj, const float* rtraj, const float* noise,
                     const float* cot, const float* g_zfinal, const float* betas,
                     const float* scal, const float* w1x, const float* c1, const float* emb,
                     const float* w2, const float* b2, const float* headw, const float* headb,
                     const float* tpar, const float* vd_mean, const float* vd_logdiag,
                     float* part_a, float* part_b, float* out_a, float* out_b, float* g_z0,
                     int n, int nbridges, int din, int in_dim, int emb_dim, int n_par,
                     int target, int refresh, int cais, int blocks, int groups,
                     float inv_var_t, void* stream) {
  if (n <= 0 || nbridges <= 0 || (groups != 2 && groups != 4)) return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || blocks > (n + groups * TC - 1) / (groups * TC))
    return (int)cudaErrorInvalidValue;
  if (target < 0 || target > 2 || !target_ok(target, n_par)) return (int)cudaErrorInvalidValue;
  const int d = target_dim(target);
  if (din != 0 && din != d && din != 2 * d) return (int)cudaErrorInvalidValue;
  if (in_dim != (din > 0 ? din + emb_dim : 0) || !fits(in_dim, n_par, d))
    return (int)cudaErrorInvalidValue;
  if (refresh < 0 || refresh > 2 || (cais && (din != 2 * d || refresh != 0)))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1x, c1, emb, w2, b2, headw, headb, tpar,
                    in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t};
  const UdKlArgs a{ztraj, rtraj, noise, cot, g_zfinal, betas, scal, net, vd_mean, vd_logdiag,
                   part_a, part_b, g_z0, n, nbridges, refresh};
  const int form = cais ? 3 : din == 2 * d ? 2 : din == d ? 1 : 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_target<false>(target, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return groups == 2 ? launch_form<2, T>(a, form, blocks, s)
                       : launch_form<4, T>(a, form, blocks, s);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(part_a, part_b, out_a, out_b, blocks, nbridges + 1, blocks, in_dim,
                            d, din, s);
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_kl_ud_chains_per_group() { return TC; }

// The launch's own limits and buffer lengths at state dimension d, for the
// wrapper to check its copy against.
int cmcd_kl_ud_fits(int in_dim, int n_par, int d) { return fits(in_dim, n_par, d) ? 1 : 0; }

long long cmcd_kl_ud_smem_bytes(int groups, int in_dim, int n_par, int d) {
  return (long long)smem_bytes(groups, in_dim, n_par, d);
}

int cmcd_kl_ud_len_a(int in_dim, int d, int din) { return len_a(in_dim, d, din); }

}  // extern "C"
