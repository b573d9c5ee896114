// The carry and per-point forms of the KL reverse sweep (B3) with a net,
// shared by the sources that instantiate them: kl.cu (the mixtures, the
// funnel and the standard normal, beside the net-free and DNF forms) and
// kl_logreg.cu (the logistic regressions, whose instances compile in a
// process of their own). The derivation and the design are in kl.cu's
// header. Its definitions have internal linkage (an unnamed namespace):
// each source that includes this header builds a library of its own.

#pragma once

#include "cmcd_tile.cuh"

namespace {

using namespace cmcd;

struct KlArgs {
  const float* traj;        // (K + 1, n, D)
  const float* noise;       // (K, n, D)
  const float* cot;         // (n,)
  const float* g_zfinal;    // (n, D)
  const float* betas;       // (K,)
  const float* scal;        // [eps0, factor_sn]
  NetArgs net;
  const float* vd_mean;     // (D,)
  const float* vd_logdiag;  // (D,)
  float* part_a;            // (blocks, len_a)
  float* part_b;            // (K + 1, blocks, len_b)
  float* g_z0;              // (n, D)
  int n, nbridges, eps_schedule;
  float clip_t, clip_q;
  NetArgs net2;             // DNF's second net (kl_dnf_sweep only)
  float* gw2;               // (blocks, 2, in_pad, in_pad + 1): DNF's dW2 accumulators
};

// Shared memory of one block of NG groups at state dimension d with `gate`
// slots a warp (NET::gate_slots(d)): the tile; per chain z_p, z_{p-1},
// xi_{p-1}, g_out, the state cotangent so far, the carries F and Z
// (d-vectors), the cotangent c; and the warps' shares of the net's input VJP.
__host__ inline size_t smem_bytes(int ng, int in_dim, int n_par, int d, int gate = 0) {
  const int tb = ng * TC;
  return (tile_floats(ng, in_dim, n_par, d, gate) + 7 * tb * d + tb +
          (ng * FW_MAX / 32) * TC * d) * sizeof(float);
}

// What one block holds (NG = 4, the larger of the two forms).
__host__ inline bool fits(int in_dim, int n_par, int d, int gate = 0) {
  return in_dim >= 1 && round_up(in_dim, 32) <= FW_MAX && n_par >= 1 && n_par <= MAX_PAR &&
         smem_bytes(4, in_dim, n_par, d, gate) <= MAX_SMEM;
}

// CAIS: the net in both kernels at (z_p, NET::row(p, K)); else (ULA_sn) in
// the backward kernel only, at (z_p, p - 1).
template <int NG, class T, bool CAIS, class NET>
__global__ void __launch_bounds__(NG* FW_MAX) kl_reverse_sweep(const KlArgs a) {
  constexpr int TB = NG * TC, D = T::D;
  using S = Slots<D>;
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges, sched = a.eps_schedule;
  const Tile<NG, D, NET> t(reinterpret_cast<float*>(smem4), net);
  const T target = make_target<T>(t.par, net);
  float* zc_s = t.rest;            // TB x D: z_p
  float* zp_s = zc_s + TB * D;     // TB x D: z_{p-1}
  float* xi_s = zp_s + TB * D;     // TB x D: xi_{p-1}
  float* go_s = xi_s + TB * D;     // TB x D: g_out
  float* tz_s = go_s + TB * D;     // TB x D: T without the net's share
  float* fc_s = tz_s + TB * D;     // TB x D: carry F
  float* zd_s = fc_s + TB * D;     // TB x D: carry Z (holds -B inside a point)
  float* cot_s = zd_s + TB * D;    // TB
  float* gz_s = cot_s + TB;        // warps x TC x D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const int nthr = blockDim.x;
  const FeatThread<D, D> th(net, NG);
  const float eps0 = a.scal[0], factor = a.scal[1];
  float vm[D], viv[D], hb[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    vm[d] = a.vd_mean[d];
    viv[d] = expf(-2.0f * a.vd_logdiag[d]);
    hb[d] = net.headb[d];
  }
  tile_init(t, net);
  float ft[nfeat(D, D)];
#pragma unroll
  for (int q = 0; q < nfeat(D, D); ++q) ft[q] = 0.f;
  float* sc = t.sc_s + warp * t.NS;
  __syncthreads();

  const int ntiles = (a.n + TB - 1) / TB;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int base = tile * TB;
    for (int i = tid; i < TB * D; i += nthr) {
      const bool live = base + i / D < a.n;
      zd_s[i] = live ? a.g_zfinal[(size_t)base * D + i] : 0.f;
      fc_s[i] = 0.f;
    }
    if (tid < TB) cot_s[tid] = base + tid < a.n ? a.cot[base + tid] : 0.f;

    for (int p = K; p >= 0; --p) {
      const bool m_fk = p <= K - 1, m_bk = p >= 1;
      // Step p (forward role) and step p - 1 (backward role); a dead role's
      // step size is 1 so that nothing divides by zero.
      const float e_f = m_fk ? eps_at(eps0, p, K, sched) : 1.f;
      const float e_b = m_bk ? eps_at(eps0, p - 1, K, sched) : 1.f;
      const float s_f = eps_slope(p, K, sched), s_b = eps_slope(p - 1, K, sched);
      const float b_f = m_fk ? a.betas[p] : 0.f;
      const float b_b = m_bk ? a.betas[p - 1] : 0.f;
      for (int i = tid; i < TB * D; i += nthr) {
        const bool live = base + i / D < a.n;
        const size_t at = (size_t)base * D + i, row = (size_t)a.n * D;
        zc_s[i] = live ? a.traj[p * row + at] : 0.f;
        zp_s[i] = live && m_bk ? a.traj[(p - 1) * row + at] : 0.f;
        xi_s[i] = live && m_bk ? a.noise[(p - 1) * row + at] : 0.f;
      }
      __syncthreads();

      // ULA_sn applies no net at point 0 (block-uniform).
      const bool net_on = CAIS || p >= 1;
      const int row = NET::row(CAIS ? p : p - 1, K);
      const float* gate_row =
          NET::PIS && net_on && net.gate != nullptr ? net.gate + (size_t)row * D : nullptr;
      FeatRegs r;
      if (net_on) tile_layers(t, net, th, row, zc_s, r);

      // Head, score, Hessian product and the scalar derivatives: one warp
      // per chain, every lane the same scalars, lane 0 keeps the sums.
      for (int c = warp; c < TB; c += nwarp) {
        float out[D], gt[D], g_gt[D], hv[D], bk[D], g_gq[D];
#pragma unroll
        for (int d = 0; d < D; ++d) out[d] = 0.f;
        typename T::Lanes sl;
        if (net_on) head_raw<D>(net, t.xs + c * ip, t.hws, out);
        target.score(zc_s + c * D, gt, &sl);
        const float cn = cot_s[c];
        float ge_f = 0.f, ge_b = 0.f, gb_f = 0.f, gb_b = 0.f, r2 = 0.f;
        float g_factor = 0.f, g_sn[D], g_mu[D], g_ld[D], ov[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float z = zc_s[c * D + d];
          const float o = out[d] + hb[d], sn = net_out<NET>(o, factor, gate_row, d, gt[d]);
          ov[d] = o;
          const float gq = -(z - vm[d]) * viv[d];
          const float gtc = clip_f(gt[d], a.clip_t), gqc = clip_f(gq, a.clip_q);
          const float diff = gtc - gqc;
          float ggt = 0.f, gsn = 0.f, ggq = 0.f;
          bk[d] = 0.f;
          if (m_fk) {
            const float f = fc_s[c * D + d], ef = e_f * f;
            ge_f += f * ((b_f * gtc + (1.0f - b_f) * gqc) - (CAIS ? sn : 0.f));
            gb_f += ef * diff;
            ggt += b_f * ef;
            if (CAIS) gsn -= ef;
            ggq += (1.0f - b_f) * ef;
          }
          if (m_bk) {
            const float drift = b_b * gtc + (1.0f - b_b) * gqc;
            const float rb = zp_s[c * D + d] - ((z + e_b * drift) + e_b * sn);
            const float gd = 0.5f * cn * rb;  // e' B
            bk[d] = gd / e_b;
            ge_b += bk[d] * (drift + sn);
            r2 += rb * rb;
            gb_b += gd * diff;
            ggt += b_b * gd;
            gsn += gd;
            ggq += (1.0f - b_b) * gd;
          }
          g_gt[d] = gt[d] == gtc ? ggt : 0.f;
          g_gq[d] = gq == gqc ? ggq : 0.f;
          g_mu[d] = g_gq[d] * viv[d];
          g_ld[d] = g_gq[d] * (-2.0f * gq);
          g_sn[d] = gsn;
          g_factor += gsn * o;
        }
        target.hvp(sl, g_gt, hv);
        if (lane == 0) {
          if (m_bk) {
            const float is2 = 1.0f / (2.0f * e_b);
            ge_b += cn * r2 * is2 * is2;
          }
          sc[S::EPS] += s_f * ge_f + s_b * ge_b;
          if constexpr (!NET::PIS) sc[S::FACTOR] += g_factor;
          sc[S::BETA] += gb_f;
          sc[S::BETA + 1] += gb_b;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float go = net_out_cot<NET>(g_sn[d], ov[d], factor);
            sc[S::MEAN + d] += g_mu[d];
            sc[S::LOGDIAG + d] += g_ld[d];
            sc[S::HEADB + d] += go;
            go_s[c * D + d] = go;
            if (gate_row != nullptr) sc[S::GATE + d] += g_sn[d] * clip_f(gt[d], PIS_GATE_CLIP);
            tz_s[c * D + d] = ((zd_s[c * D + d] + bk[d]) - viv[d] * g_gq[d]) + hv[d];
            zd_s[c * D + d] = -bk[d];
          }
        }
      }
      __syncthreads();

      if (net_on) tile_vjp(t, net, th, zc_s, go_s, r, ft, gz_s);

      // T complete: the next carries, the noise scale's share of d eps, or
      // dL/dz_0. One thread per chain, all in the first warp.
      if (warp == 0) {
        float ge = 0.f;
        if (lane < TB) {
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float tot =
                tz_s[lane * D + d] + (net_on ? tile_gz<NG, D>(gz_s, lane, d) : 0.f);
            if (m_bk) {
              ge = fmaf(tot, xi_s[lane * D + d], ge);
              fc_s[lane * D + d] = tot;
              zd_s[lane * D + d] += tot;
            } else if (base + lane < a.n) {
              a.g_z0[(size_t)(base + lane) * D + d] = tot;
            }
          }
        }
        ge = warp_sum(ge);
        if (lane == 0 && m_bk) sc[S::EPS] += s_b * ge * (1.0f / sqrtf(2.0f * e_b));
      }
      flush_point(t, net, th, ft,
                  a.part_b + ((size_t)p * gridDim.x + blockIdx.x) * len_b(in, t.G),
                  tile != (int)blockIdx.x);
    }
  }

  flush_block(t, net, th, ft, a.part_a + (size_t)blockIdx.x * len_a(in, D, D));
}

template <int NG, class T, bool CAIS, class NET>
cudaError_t launch_sweep(const KlArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem =
      smem_bytes(NG, a.net.in_dim, a.net.n_par, T::D, NET::gate_slots(T::D));
  cudaError_t err = cudaFuncSetAttribute(kl_reverse_sweep<NG, T, CAIS, NET>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kl_reverse_sweep<NG, T, CAIS, NET>
      <<<blocks, NG * round_up(a.net.in_dim, 32), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
