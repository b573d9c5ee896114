// Underdamped KL reverse sweep for NVIDIA Hopper (sm_90a): backprop through
// time of the leapfrog rollout's log-weight from its stored positions,
// momenta and draws.
//
// Replaces cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_underdamped (the TPU
// kernel "B7") for the approximate-refresh specs U_A_LP, U_A_LP_SNA and
// U_A_LP_SN (no net, a net on z, a net on [z, rho']) on the many_gmm target
// (dim 2) with the two-layer geffner net. The Python wrapper is
// cmcd_tpu_torch/ops/kl_underdamped.py::evolve_kl_bwd_underdamped; its plain
// PyTorch version evolve_kl_bwd_underdamped_plain walks the same sweep. The
// TPU kernel traces jax.vjp of the step; here every derivative is written out.
//
// What it computes. With e = eps, a = gamma e, s = sqrt(2 a) (one step size
// for all steps in these specs), z_p, rho_p (p = 0..K) and the draws xi_p
// (step p's refresh, row p + 1 of the stack) data, c_n the cotangent of
// chain n's log-weight increments and g_K that of z_K:
//   L = sum_n [ c_n (sum_p delta_p - |rho_K|^2 / 2) + g_K . z_K ]
//   step p:  rho'_p = rho_p (1 - a) + s xi_p
//            rho''_p = rho'_p + (e / 2) D_p(z_p),  D_p(z) = b_p gt(z) + (1 - b_p) gq(z)
//            z_{p+1} = z_p + e rho''_p;  rho_{p+1} = rho''_p + (e / 2) D_p(z_{p+1})
//            bk_p = rho'_p (1 - a) + 2 a sn_p,  sn_p = sn(z_p, p), sn([z_p, rho'_p], p) or 0
//            r_p = (rho_p - bk_p) / s;  delta_p = -|r_p|^2 / 2 + |xi_p|^2 / 2
//   gq(z) = -(z - mu) exp(-2 logdiag)
// differentiated in theta = (eps, gamma, betas, mu, logdiag, net) and in z_0
// with nothing stopped (the forward and backward kernels' log-normalisers
// cancel; -log N(rho_0) is a draw's and gets nothing). Each point p = K..0
// is visited once: the score at z_p serves step p's first half-kick (b_p)
// and step p - 1's second (b_{p-1}), and step p's net is applied and
// transposed at point p. Carried from point p + 1: GZ, the cotangent z_p gets
// from z_{p+1} = z_p + e rho''_p, and GR, that of rho''_p. At point p:
//   step p (p <= K - 1)
//     B = c r_p / s (cotangent of bk_p);  g_sn = 2 a B  -> net VJP: weights, g_x
//     g_a += (2 sn_p - rho'_p) . B;  g_s += c |r_p|^2 / s
//     Grho' = GR + (1 - a) B + g_x[rho']
//     g_s += xi_p . Grho';  g_a += -rho_p . Grho'
//     Grho_p = (1 - a) Grho' - B;  Z = GZ + g_x[z]
//     first half-kick: g_e += D_p(z_p) . GR / 2;  g_b_p += (e / 2) (gt - gq) . GR
//                      g_gt += (e / 2) b_p GR;  g_gq += (e / 2) (1 - b_p) GR
//   point K: Grho_K = -c rho_K;  Z = g_K
//   step p - 1's second half-kick (p >= 1):
//                      g_e += D_{p-1}(z_p) . Grho_p / 2;  g_b_{p-1} += (e / 2) (gt - gq) . Grho_p
//                      g_gt += (e / 2) b_{p-1} Grho_p;  g_gq += (e / 2) (1 - b_{p-1}) Grho_p
//   vd      g_mu += exp(-2 logdiag) g_gq;  g_logdiag += -2 gq g_gq
//   state   T = Z - exp(-2 logdiag) g_gq + H(z_p) g_gt  (one many_gmm Hessian product
//           for both half-kicks, by linearity; cmcd_common.cuh)
//   p >= 1  rho''_{p-1} = rho_p - (e / 2) D_{p-1}(z_p);  g_e += rho''_{p-1} . T
//           GZ <- T;  GR <- Grho_p + e T
//   p = 0   dL/dz_0 = T
//   finally (s = sqrt(2 a)): g_a += g_s / s;  g_eps = g_e + gamma g_a;  g_gamma = e g_a.
//
// What bounds it on the H100. Per point and chain (full net, in_dim 134) one
// net apply, W2 g_a2 and the dW2 outer product, 3 x in_dim^2 FMAs, and the
// 40-component score and Hessian product; the three stacks are 24 bytes per
// point: bound by FP32 arithmetic and shared-memory bandwidth. The sweep is
// sequential along a chain, so only the chains run side by side.
//
// What the design does about it (B3's design, kl.cu):
//  * A block owns chain tiles b, b + B, ... and walks each from point K to
//    point 0 with the carries (GZ, GR: four floats per chain) in shared
//    memory; the tile (cmcd_tile.cuh) holds W2 and the block's dW2, thread
//    (g, f) owns feature f for eight chains, 2 groups on 16-chain tiles while
//    32-chain tiles would leave SMs idle, else 4.
//  * The net's input width is a template parameter (DIN = 0, 2 or 4): the
//    input VJP returns the cotangents of z and of rho'; without a net the
//    block is one warp per eight chains and carries no net code.
//  * Two per-chain passes, one warp per chain: before the VJP the backward
//    mean and its cotangent (they need only the net's output), after it the
//    score, both half-kicks, one Hessian product and the carries.
//  * Per-point sums (the betas, G1, GH1) leave the block after every point,
//    the rest after its whole walk; partials_reduce adds the blocks' partials
//    in block order: no atomics.
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.

#include "cmcd_tile.cuh"

namespace {

using namespace cmcd;

constexpr int DIM = ManyGmmTarget::D;  // the underdamped kernels take many_gmm only (2-D)
constexpr int XIN = 4;  // floats of a chain's net input buffer: [z, rho']
using S = Slots<DIM>;

struct UdKlArgs {
  const float* ztraj;       // (K + 1, n, 2)
  const float* rtraj;       // (K + 1, n, 2)
  const float* noise;       // (K + 1, n, 2): row p + 1 the draw of step p
  const float* cot;         // (n,)
  const float* g_zfinal;    // (n, 2)
  const float* betas;       // (K,)
  const float* scal;        // [eps, factor_sn, gamma]
  NetArgs net;
  const float* vd_mean;     // (2,)
  const float* vd_logdiag;  // (2,)
  float* part_a;            // (blocks, len_a)
  float* part_b;            // (K + 1, blocks, len_b)
  float* g_z0;              // (n, 2)
  int n, nbridges;
};

// Shared memory of one block of NG groups: the tile; per chain z_p, rho_p,
// xi_p, rho'_p, g_out, B and the carries GZ, GR (2-vectors), the net's input
// and the cotangent c; and the warps' shares of the net's input VJP.
__host__ inline size_t smem_bytes(int ng, int in_dim, int n_par) {
  const int tb = ng * TC;
  return (tile_floats(ng, in_dim, n_par, DIM) + (8 * DIM + XIN + 1) * tb +
          (ng * FW_MAX / 32) * TC * XIN) * sizeof(float);
}

// What one block holds (NG = 4, the larger of the two forms); in_dim 0: no net.
__host__ inline bool fits(int in_dim, int n_par) {
  return in_dim >= 0 && round_up(in_dim, 32) <= FW_MAX && n_par >= 2 && n_par <= MAX_PAR &&
         n_par % 2 == 0 && smem_bytes(4, in_dim, n_par) <= MAX_SMEM;
}

template <int NG, int DIN>
__global__ void __launch_bounds__(NG* FW_MAX) kl_ud_sweep(const UdKlArgs a) {
  constexpr int TB = NG * TC;
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges;
  const Tile<NG, DIM> t(reinterpret_cast<float*>(smem4), net);
  const ManyGmmTarget target(t.par, net.n_par, net.inv_var_t);
  float* zc_s = t.rest;             // TB x 2: z_p
  float* rc_s = zc_s + TB * DIM;    // TB x 2: rho_p
  float* xi_s = rc_s + TB * DIM;    // TB x 2: xi_p
  float* rp_s = xi_s + TB * DIM;    // TB x 2: rho'_p
  float* go_s = rp_s + TB * DIM;    // TB x 2: g_out
  float* gb_s = go_s + TB * DIM;    // TB x 2: B
  float* gz_c = gb_s + TB * DIM;    // TB x 2: carry GZ
  float* gr_c = gz_c + TB * DIM;    // TB x 2: carry GR
  float* xin_s = gr_c + TB * DIM;   // TB x DIN: the net's input
  float* cot_s = xin_s + TB * XIN;  // TB
  float* gx_s = cot_s + TB;         // warps x TC x DIN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const FeatThread<DIM, DIN> th(net, NG);
  const float e = a.scal[0], factor = a.scal[1], gamma = a.scal[2];
  const float aux = gamma * e, s = sqrtf(2.0f * aux), cf = 1.0f - aux;
  float vm[DIM], viv[DIM], hb[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    vm[d] = a.vd_mean[d];
    viv[d] = expf(-2.0f * a.vd_logdiag[d]);
    hb[d] = DIN > 0 ? net.headb[d] : 0.f;
  }
  tile_init(t, net);
  float ft[nfeat(DIM, DIN)];
#pragma unroll
  for (int q = 0; q < nfeat(DIM, DIN); ++q) ft[q] = 0.f;
  float* sc = t.sc_s + warp * S::N;
  __syncthreads();

  const int ntiles = (a.n + TB - 1) / TB;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int base = tile * TB;
    if (tid < TB * DIM) {
      const bool live = base + tid / DIM < a.n;
      gz_c[tid] = live ? a.g_zfinal[(size_t)base * DIM + tid] : 0.f;
      gr_c[tid] = 0.f;
    }
    if (tid < TB) cot_s[tid] = base + tid < a.n ? a.cot[base + tid] : 0.f;

    for (int p = K; p >= 0; --p) {
      const bool m_f = p <= K - 1, m_b = p >= 1;  // step p starts here; step p - 1 ends here
      const float b_f = m_f ? a.betas[p] : 0.f, b_b = m_b ? a.betas[p - 1] : 0.f;
      if (tid < TB * DIM) {
        const bool live = base + tid / DIM < a.n;
        const size_t at = (size_t)base * DIM + tid, row = (size_t)a.n * DIM;
        const float z = live ? a.ztraj[p * row + at] : 0.f;
        const float rho = live ? a.rtraj[p * row + at] : 0.f;
        const float xi = live && m_f ? a.noise[(p + 1) * row + at] : 0.f;
        const float rp = rho * cf + s * xi;
        zc_s[tid] = z;
        rc_s[tid] = rho;
        xi_s[tid] = xi;
        rp_s[tid] = rp;
        const int c = tid / DIM, d = tid - c * DIM;
        if constexpr (DIN > 0) xin_s[c * DIN + d] = z;
        if constexpr (DIN == XIN) xin_s[c * XIN + DIM + d] = rp;
      }
      __syncthreads();

      FeatRegs r;
      if constexpr (DIN > 0) {
        if (m_f) tile_layers(t, net, th, p, xin_s, r);
      }

      // Step p's backward mean and its cotangent B: one warp per chain,
      // every lane the same scalars, lane 0 keeps the sums.
      if (m_f) {
        for (int c = warp; c < TB; c += nwarp) {
          float out[DIM] = {0.f, 0.f};
          if constexpr (DIN > 0) head_raw<DIM>(net, t.xs + c * ip, t.hws, out);
          const float cn = cot_s[c];
          float ga = 0.f, gs = 0.f, g_factor = 0.f, go[DIM], gb[DIM];
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            const float o = out[d] + hb[d], sn = o * factor, rp = rp_s[c * DIM + d];
            float bk = rp * cf;
            if constexpr (DIN > 0) bk = bk + 2.0f * aux * sn;
            const float rr = (rc_s[c * DIM + d] - bk) / s;
            gb[d] = cn * rr / s;
            gs += cn * rr * rr;
            ga -= rp * gb[d];
            const float gsn = 2.0f * aux * gb[d];
            if constexpr (DIN > 0) ga += 2.0f * sn * gb[d];
            g_factor += gsn * o;
            go[d] = gsn * factor;
          }
          if (lane == 0) {
            const float gat = ga + gs / (s * s);  // g_a with s's share: g_s / s
            sc[S::EPS] += gamma * gat;
            sc[S::GAMMA] += e * gat;
            if constexpr (DIN > 0) sc[S::FACTOR] += g_factor;
#pragma unroll
            for (int d = 0; d < DIM; ++d) {
              if constexpr (DIN > 0) sc[S::HEADB + d] += go[d];
              go_s[c * DIM + d] = go[d];
              gb_s[c * DIM + d] = gb[d];
            }
          }
        }
      }
      __syncthreads();

      if constexpr (DIN > 0) {
        if (m_f) tile_vjp(t, net, th, xin_s, go_s, r, ft, gx_s);
      }

      // The score, both half-kicks, the Hessian product and the carries.
      for (int c = warp; c < TB; c += nwarp) {
        float gt[DIM], gq[DIM], db[DIM], g_gt[DIM], g_gq[DIM], grho[DIM], tot[DIM], hv[DIM];
        ScoreLanes sl;
        target.score(zc_s + c * DIM, gt, &sl);
        const float cn = cot_s[c];
        float ge = 0.f, ga = 0.f, gs = 0.f, gbf = 0.f, gbb = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const float rho = rc_s[c * DIM + d];
          gq[d] = -(zc_s[c * DIM + d] - vm[d]) * viv[d];
          g_gt[d] = g_gq[d] = 0.f;
          if (m_f) {
            float gx_z = 0.f, gx_r = 0.f;
            if constexpr (DIN > 0) gx_z = tile_gz<NG, DIN>(gx_s, c, d);
            if constexpr (DIN == XIN) gx_r = tile_gz<NG, DIN>(gx_s, c, DIM + d);
            const float gr2 = gr_c[c * DIM + d], gbk = gb_s[c * DIM + d];
            const float grp = (gr2 + cf * gbk) + gx_r;
            gs += xi_s[c * DIM + d] * grp;
            ga -= rho * grp;
            grho[d] = cf * grp - gbk;
            tot[d] = gz_c[c * DIM + d] + gx_z;
            const float df = b_f * gt[d] + (1.0f - b_f) * gq[d];
            ge += 0.5f * df * gr2;
            gbf += 0.5f * e * (gt[d] - gq[d]) * gr2;
            g_gt[d] += 0.5f * e * b_f * gr2;
            g_gq[d] += 0.5f * e * (1.0f - b_f) * gr2;
          } else {
            grho[d] = -cn * rho;
            tot[d] = gz_c[c * DIM + d];
          }
          db[d] = b_b * gt[d] + (1.0f - b_b) * gq[d];
          if (m_b) {
            ge += 0.5f * db[d] * grho[d];
            gbb += 0.5f * e * (gt[d] - gq[d]) * grho[d];
            g_gt[d] += 0.5f * e * b_b * grho[d];
            g_gq[d] += 0.5f * e * (1.0f - b_b) * grho[d];
          }
        }
        target.hvp(sl, g_gt, hv);
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          tot[d] = (tot[d] - viv[d] * g_gq[d]) + hv[d];
          if (m_b) ge += (rc_s[c * DIM + d] - 0.5f * e * db[d]) * tot[d];
        }
        if (lane == 0) {
          const float gat = ga + gs / s;
          sc[S::EPS] += ge + gamma * gat;
          sc[S::GAMMA] += e * gat;
          sc[S::BETA] += gbf;
          sc[S::BETA + 1] += gbb;
#pragma unroll
          for (int d = 0; d < DIM; ++d) {
            sc[S::MEAN + d] += g_gq[d] * viv[d];
            sc[S::LOGDIAG + d] += g_gq[d] * (-2.0f * gq[d]);
            if (m_b) {
              gz_c[c * DIM + d] = tot[d];
              gr_c[c * DIM + d] = grho[d] + e * tot[d];
            } else if (base + c < a.n) {
              a.g_z0[(size_t)(base + c) * DIM + d] = tot[d];
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

  flush_block(t, net, th, ft, a.part_a + (size_t)blockIdx.x * len_a(in, DIM, DIN));
}

template <int NG, int DIN>
cudaError_t launch_sweep(const UdKlArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(NG, a.net.in_dim, a.net.n_par);
  cudaError_t err = cudaFuncSetAttribute(kl_ud_sweep<NG, DIN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int fw = DIN > 0 ? round_up(a.net.in_dim, 32) : 32;
  kl_ud_sweep<NG, DIN><<<blocks, NG * fw, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NG>
cudaError_t launch_groups(const UdKlArgs& a, int din, int blocks, cudaStream_t stream) {
  if (din == XIN) return launch_sweep<NG, XIN>(a, blocks, stream);
  if (din == DIM) return launch_sweep<NG, DIM>(a, blocks, stream);
  return launch_sweep<NG, 0>(a, blocks, stream);
}

}  // namespace

extern "C" {

// Launches the sweep and its reduction on `stream`: `blocks` blocks of
// `groups` (2 or 4) groups of feature threads, blocks <= the number of chain
// tiles of 8 x groups chains. din: the net's input columns ahead of the
// embedding (0: no net, in_dim and emb_dim 0 and the weights null; 2: z; 4:
// [z, rho']). part_a: (blocks, len_a) and part_b: (points, blocks, len_b) are
// scratch; out_a: (len_a,), out_b: (points, len_b) and g_z0: (n, 2) receive
// the results. Returns a cudaError_t.
int cmcd_kl_ud_sweep(const float* ztraj, const float* rtraj, const float* noise,
                     const float* cot, const float* g_zfinal, const float* betas,
                     const float* scal, const float* w1x, const float* c1, const float* emb,
                     const float* w2, const float* b2, const float* headw, const float* headb,
                     const float* means, const float* vd_mean, const float* vd_logdiag,
                     float* part_a, float* part_b, float* out_a, float* out_b, float* g_z0,
                     int n, int nbridges, int din, int in_dim, int emb_dim, int n_par,
                     int blocks, int groups, float inv_var_t, void* stream) {
  if (n <= 0 || nbridges <= 0 || (groups != 2 && groups != 4)) return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || blocks > (n + groups * TC - 1) / (groups * TC))
    return (int)cudaErrorInvalidValue;
  if (din != 0 && din != DIM && din != XIN) return (int)cudaErrorInvalidValue;
  if (in_dim != (din > 0 ? din + emb_dim : 0) || !fits(in_dim, n_par))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1x, c1, emb, w2, b2, headw, headb, means,
                    in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t};
  const UdKlArgs a{ztraj, rtraj, noise, cot, g_zfinal, betas, scal, net, vd_mean, vd_logdiag,
                   part_a, part_b, g_z0, n, nbridges};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = groups == 2 ? launch_groups<2>(a, din, blocks, s)
                                      : launch_groups<4>(a, din, blocks, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(part_a, part_b, out_a, out_b, blocks, nbridges + 1, blocks, in_dim,
                            DIM, din, s);
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_kl_ud_chains_per_group() { return TC; }

// The launch's own limits and buffer lengths, for the wrapper to check its
// copy against.
int cmcd_kl_ud_fits(int in_dim, int n_par) { return fits(in_dim, n_par) ? 1 : 0; }

long long cmcd_kl_ud_smem_bytes(int groups, int in_dim, int n_par) {
  return (long long)smem_bytes(groups, in_dim, n_par);
}

int cmcd_kl_ud_len_a(int in_dim, int din) { return len_a(in_dim, DIM, din); }

}  // extern "C"
