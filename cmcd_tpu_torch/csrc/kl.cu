// KL reverse sweep for NVIDIA Hopper (sm_90a): backprop through time of the
// overdamped log-weight increments from the stored trajectory and noise.
//
// Replaces cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_pallas (the TPU kernel
// "B3") on the many_gmm and the 3-mode gmm targets (dim 2), Neal's funnel
// and the standard normal (dim 10), the target a template parameter whose D
// sizes every per-chain array (cmcd_common.cuh), in three forms:
//  * kl_reverse_sweep<NG, T, true>, its carry form: one net, in both
//    kernels, backward net at i + 1 (MCD_CAIS_sn);
//  * kl_reverse_sweep<NG, T, false>: the net in the backward kernel only, at
//    (z_{i+1}, i) (MCD_ULA_sn), the per-point case of the TPU kernel
//    (pallas_kl.py point_fn, :320-333);
//  * kl_ula_sweep<T>: no net (MCD_ULA), one warp per chain;
//  * kl_dnf_sweep<NG, D>: MCD_DNF, zero drift and two geffner nets, the
//    per-point case of the TPU kernel with its second net (pallas_kl.py
//    point_fn, :202-215, :273, :286-307; the sn2 gradients :977-978),
//    instantiated by the state's dimension D (no score enters it).
// The net is a template parameter (cmcd_common.cuh): the two-layer geffner
// net or a PIS net ("dds", "dds_grad"; the TPU kernel's PIS branch is
// pallas_kl.py:147-158, 175-185, 227-241). A PIS net's output is clipped
// (its cotangent masked where the clip bit) and dds_grad's gate term
// g_t[t] * clip(gt(z_p), 1e2) enters sn with no cotangent in z_p: it adds
// the per-point sum sum_n g_sn * clip(gt) to the point's partials. The
// point's table row is NET::row(p, K) in the carry form (geffner clamps it
// to K - 1, PIS takes K at the last point). The Python wrapper is
// cmcd_tpu_torch/ops/kl.py::evolve_kl_bwd; its plain PyTorch version
// evolve_kl_bwd_plain walks the same sweep. The TPU kernel traces jax.vjp of
// the step (twice per point in its per-point form); here every derivative is
// written out, once per point.
//
// What it computes. With z_0..z_K and the draws xi_0..xi_{K-1} data, c_n the
// cotangent of chain n's summed increments and g_K that of its final state,
//   L = sum_n [ c_n sum_j (bk_lp_j - fk_lp_j) + g_K . z_K ],
//   z_{j+1} = fk_mean_j + sqrt(2 e_j) xi_j,  fk_mean_j = z_j + e_j D_j(z_j) - e_j sn(z_j, j)
//   bk_mean_j = z_{j+1} + e_j D_j(z_{j+1}) + e_j sn(z_{j+1}, j + 1),  r_j = z_j - bk_mean_j
//   D_j(z) = b_j clip(gt(z), ct) + (1 - b_j) clip(gq(z), cq),  gq = -(z - mu) exp(-2 logdiag)
// differentiated in theta = (eps0, betas, mu, logdiag, net) and in z_0 with
// nothing stopped: every state depends on the one before. fk_lp_j is
// -|xi_j|^2 / 2 plus the log term that bk_lp_j's cancels, so only r_j and
// the state chain carry gradient. Each point p = K..0 is visited once, and
// both steps that touch z_p, step p - 1 (z_p is where its backward kernel's
// mean is formed) and step p (its forward kernel starts there), use the same
// score gt(z_p) and net output sn(z_p, NET::row(p, K)), so each is applied and
// transposed once per point. Carried from point p + 1: F_p, the cotangent of
// fk_mean_p, and Z_p = F_p - c r_p / (2 e_p), the cotangent z_p gets directly
// from step p (at p = K: Z_K = g_K, no F). At point p, with e, b of step p
// and e', b' of step p - 1 (either role missing at the ends):
//   forward role   g_e_p   += F . (D_p(z_p) - sn)
//                  g_b_p   += e F . (gtc - gqc)
//                  g_gt += b e F;  g_sn += -e F;  g_gq += (1 - b) e F
//   backward role  r = z_{p-1} - bk_mean_{p-1};  B = c r / (2 e') (cotangent of bk_mean)
//                  g_e_p-1 += B . (D_p-1(z_p) + sn) + c |r|^2 / (2 e')^2
//                  g_b_p-1 += e' B . (gtc - gqc)
//                  g_gt += b' e' B;  g_sn += e' B;  g_gq += (1 - b') e' B
//   clips          g_gt, g_gq pass nothing where their score was clipped
//   vd             g_mu += g_gq exp(-2 logdiag);  g_logdiag += g_gq (-2 gq)
//   state          T = Z_p + B - exp(-2 logdiag) g_gq + H(z_p) g_gt + J_sn(z_p)^T g_sn
//                  (H: the target's Hessian product, cmcd_common.cuh; J_sn^T:
//                  the net's input VJP of cmcd_tile.cuh, which also sums the
//                  net's weight gradients from g_sn)
//   p >= 1         T is the cotangent of z_p = fk_mean_{p-1} + sqrt(2 e') xi_{p-1}:
//                  g_e_p-1 += T . xi_{p-1} / sqrt(2 e');  F_{p-1} = T;  Z_{p-1} = T - B
//   p = 0          dL/dz_0 = T
//   g_eps0 = sum_j g_e_j s_j with s_j = d eps_j / d eps0 of the schedule.
// ULA_sn: the forward mean has no net (fk_mean_j = z_j + e_j D_j(z_j)) and
// the backward mean's net is sn(z_{j+1}, j). The same walk holds with two
// changes: the forward role has no net term (no -sn in g_e_p, no g_sn), and
// the point's net application is sn(z_p, p - 1), serving the backward role
// of step p - 1 only (none at p = 0). ULA: no net at all; what is left per
// point is one score, one Hessian product and the scalar derivatives.
//
// What bounds it on the H100. Per point and chain one net apply, W2 g_a2 and
// the dW2 outer product, 3 x in_dim^2 FMAs (52k at in_dim 132, 10k at the
// funnel's 58), and the target's Hessian product; trajectory and noise are
// 8 D bytes per point:
// bound by FP32 arithmetic and shared-memory bandwidth, not device memory.
// But the sweep is sequential along a chain, so only the chains run side by
// side.
//
// Without the net (ULA) a point is the score, its Hessian product and O(1)
// state: latency along the chain, as the UHA sweep (kl_uha.cu).
//
// DNF (kl_dnf_sweep). The steps are
//   fk_mean_j = z_j - e_j sn(z_j, j),  z_{j+1} = fk_mean_j + sqrt(2 e_j) xi_j
//   bk_mean_j = z_{j+1} + e_j sn2(z_{j+1}, row(j + 1, K)),  r_j = z_j - bk_mean_j
// with no drift, so no score, no Hessian product, no betas and no vd in the
// bridge: their gradients are zero. At point p the two nets are different
// applications at the same state: sn(z_p, p) serves the forward role of
// step p (p < K), sn2(z_p, row(p, K)) the backward role of step p - 1
// (p >= 1), and each is transposed once at its point:
//   forward role   g_e_p   += F . (-sn);  g_sn = -e F          (known before the point)
//   backward role  r = z_{p-1} - (z_p + e' sn2);  B = c r / (2 e')
//                  g_e_p-1 += B . sn2 + c |r|^2 / (2 e')^2;  g_sn2 = e' B
//   state          T = Z_p + B + J_sn(z_p)^T g_sn + J_sn2(z_p)^T g_sn2
// and from T on as in the carry form (g_e_p-1 += T . xi_{p-1} / sqrt(2 e'),
// F_{p-1} = T, Z_{p-1} = T - B; dL/dz_0 = T). Each net sums its own weight
// gradients (dW2, dheadW, db2, dW1[:D], head bias, factor, G1 and GH1 a
// point); eps's gradient sits in the first net's sums.
//
// DNF's design. Two nets do not fit the tile as the carry form lays it out:
// W2 and the block's dW2 at row stride in_pad + 1 are 2 x 70 KiB for one net
// at in_dim 132, 281 KiB for two, past the 227 KiB a block may use. Of the
// four matrices, the two W2 stay in shared memory (both are read every
// point, by the layer-2 apply and by W2 g_a2, in column and in row walks),
// and the two dW2 accumulators go to this block's own slice of a global
// scratch buffer (2 x 70 KiB a block; 17.6 MB at the 125 blocks of N=2000,
// L2-resident), where each point's outer product reads and writes them:
// thread (g, f) updates column f of its group's rows, so a warp touches 32
// neighbouring floats, and no two threads touch one element. That costs
// 280 KiB of L2 traffic a point a block, half of what reading both W2 from
// L2 would (each group reads W2 twice a point). The block's sums stay in
// block order: no atomics, the same inputs give the same bits. The hidden
// tiles, the transposed h1 and the per-chain buffers are shared by the two
// nets, which run one after the other at a point: the forward net's
// cotangent (-e F) is known before the point, so its VJP goes first.
//
// What the design does about it:
//  * A block owns chain tiles b, b + B, ... and walks each from point K to
//    point 0 with the carries (F, Z: 2 D floats per chain) in shared
//    memory; the per-chain loads are strided over the block's threads (at
//    D = 10 a 16-chain tile holds 160 floats a vector, more than the 128
//    threads of two groups at the funnel's in_dim 58). The tile is the VarGrad kernels' (cmcd_tile.cuh): W2 and the
//    block's dW2 in shared memory, thread (g, f) owns feature f for eight
//    chains. With fewer 32-chain tiles than SMs it runs NG = 2 groups on
//    tiles of 16 chains, else NG = 4 on 32.
//  * The head, the score, its Hessian product and the scalar derivatives take
//    one warp per chain; the net's input VJP leaves the feature threads as
//    per-warp sums that one thread per chain adds up.
//  * Per-point sums (the betas, G1, GH1) leave the block after every point;
//    everything else is summed over the block's whole walk. partials_reduce
//    adds the blocks' partials in block order: no atomics.
//  * Both the score and its Hessian product serve the two steps that meet at
//    a point, under the two steps' betas: their cotangents are summed before
//    one Hessian product per point.
//  * ULA has no net, so no tile: kl_ula_sweep gives each chain a warp (lanes
//    over the target's components), keeps the carries and the chain's sums
//    in registers and meets the block once a point, for the betas' sum
//    (the layout of kl_uha.cu).
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.
//  * The forms with a net (kl_reverse_sweep<NG, T, CAIS, NET>) are defined in
//    kl_sweep.cuh, shared with kl_logreg.cu, which builds its logistic
//    regression instances in a process of their own.

#include "kl_sweep.cuh"

namespace {

using namespace cmcd;

template <class T, class NET>
cudaError_t launch_tiles(const KlArgs& a, int blocks, int groups, bool cais, cudaStream_t s) {
  if (cais) {
    return groups == 2 ? launch_sweep<2, T, true, NET>(a, blocks, s)
                       : launch_sweep<4, T, true, NET>(a, blocks, s);
  }
  return groups == 2 ? launch_sweep<2, T, false, NET>(a, blocks, s)
                     : launch_sweep<4, T, false, NET>(a, blocks, s);
}

// Shared memory of one block of kl_dnf_sweep at state dimension d: the tile
// with no target constants (its dW2 slot holds sn2's W2), sn2's head rows
// and per-warp slots, the per-chain buffers of the carry form, and two
// nets' shares of the input VJP.
__host__ inline size_t dnf_smem_bytes(int ng, int in_dim, int d) {
  const int tb = ng * TC, ip = round_up(in_dim, 4), warps = ng * FW_MAX / 32;
  return (tile_floats(ng, in_dim, 0, d) + (size_t)d * ip + (size_t)nscal(d) * warps +
          7 * tb * d + tb + 2 * warps * TC * d) * sizeof(float);
}

__host__ inline bool dnf_fits(int in_dim, int d) {
  return in_dim >= 1 && round_up(in_dim, 32) <= FW_MAX && dnf_smem_bytes(4, in_dim, d) <= MAX_SMEM;
}

template <int NG, int D>
__global__ void __launch_bounds__(NG* FW_MAX) kl_dnf_sweep(const KlArgs a) {
  constexpr int TB = NG * TC;
  using NET = GeffnerNet;
  using TileT = Tile<NG, D, NET>;
  using S = Slots<D>;
  constexpr int NS = TileT::NS;
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const NetArgs& net2 = a.net2;
  const int ip = net.in_pad, K = a.nbridges, sched = a.eps_schedule;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const int nthr = blockDim.x;
  // t1 is the tile as the carry form lays it out (n_par 0); its dW2 slot
  // holds sn2's W2 and both dW2 go to the block's global scratch.
  TileT t1(reinterpret_cast<float*>(smem4), net);
  tile_init(t1, net);  // sn's W2 and head; zeroes the slot, the tiles, the slots
  TileT t2 = t1;
  t2.w2s = t1.gw2s;
  t2.hws = t1.rest;                                   // D x in_pad
  t2.sc_s = t2.hws + D * ip;                          // warps x NS
  float* zc_s = t2.sc_s + NS * (NG * FW_MAX / 32);    // TB x D: z_p
  float* zp_s = zc_s + TB * D;     // TB x D: z_{p-1}
  float* xi_s = zp_s + TB * D;     // TB x D: xi_{p-1}
  float* go_s = xi_s + TB * D;     // TB x D: g_out of the net being transposed
  float* tz_s = go_s + TB * D;     // TB x D: T without the nets' shares
  float* fc_s = tz_s + TB * D;     // TB x D: carry F
  float* zd_s = fc_s + TB * D;     // TB x D: carry Z (holds -B inside a point)
  float* cot_s = zd_s + TB * D;    // TB
  float* gz1_s = cot_s + TB;       // warps x TC x D: sn's share of g_x
  float* gz2_s = gz1_s + (NG * FW_MAX / 32) * TC * D;  // sn2's
  float* gw = a.gw2 + (size_t)blockIdx.x * 2 * ip * t1.ws;
  t1.gw2s = gw;
  t2.gw2s = gw + ip * t1.ws;
  __syncthreads();  // tile_init's zeroes of the slot before sn2's W2 lands there
  load_w2(net2, t2.w2s, t2.ws);
  for (int i = tid; i < 2 * ip * t1.ws; i += nthr) gw[i] = 0.f;
  for (int i = tid; i < D * ip; i += nthr) {
    const int d = i / ip, k = i - d * ip;
    t2.hws[i] = k < net2.in_dim ? net2.headw[d * net2.in_dim + k] : 0.f;
  }
  for (int i = tid; i < nwarp * NS; i += nthr) t2.sc_s[i] = 0.f;

  const FeatThread<D, D> th1(net, NG), th2(net2, NG);
  const float eps0 = a.scal[0], factor1 = a.scal[1], factor2 = a.scal[2];
  float hb1[D], hb2[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    hb1[d] = net.headb[d];
    hb2[d] = net2.headb[d];
  }
  float ft1[nfeat(D, D)], ft2[nfeat(D, D)];
#pragma unroll
  for (int q = 0; q < nfeat(D, D); ++q) ft1[q] = ft2[q] = 0.f;
  float* sc1 = t1.sc_s + warp * NS;
  float* sc2 = t2.sc_s + warp * NS;
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
      const float e_f = m_fk ? eps_at(eps0, p, K, sched) : 1.f;
      const float e_b = m_bk ? eps_at(eps0, p - 1, K, sched) : 1.f;
      const float s_f = eps_slope(p, K, sched), s_b = eps_slope(p - 1, K, sched);
      for (int i = tid; i < TB * D; i += nthr) {
        const bool live = base + i / D < a.n;
        const size_t at = (size_t)base * D + i, row = (size_t)a.n * D;
        zc_s[i] = live ? a.traj[p * row + at] : 0.f;
        zp_s[i] = live && m_bk ? a.traj[(p - 1) * row + at] : 0.f;
        xi_s[i] = live && m_bk ? a.noise[(p - 1) * row + at] : 0.f;
      }
      __syncthreads();

      FeatRegs r;
      if (m_fk) {  // step p's forward mean: sn(z_p, p), cotangent -e F
        tile_layers(t1, net, th1, p, zc_s, r);
        for (int c = warp; c < TB; c += nwarp) {
          float out[D];
          head_raw<D>(net, t1.xs + c * ip, t1.hws, out);
          float ge_f = 0.f, g_factor = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float o = out[d] + hb1[d], f = fc_s[c * D + d];
            const float gsn = -e_f * f;
            ge_f -= f * (o * factor1);
            g_factor += gsn * o;
            if (lane == 0) {
              const float go = gsn * factor1;
              sc1[S::HEADB + d] += go;
              go_s[c * D + d] = go;
            }
          }
          if (lane == 0) {
            sc1[S::EPS] += s_f * ge_f;
            sc1[S::FACTOR] += g_factor;
          }
        }
        __syncthreads();
        tile_vjp(t1, net, th1, zc_s, go_s, r, ft1, gz1_s);
      }
      if (m_bk) {  // step p - 1's backward mean: sn2(z_p, row(p, K))
        tile_layers(t2, net2, th2, NET::row(p, K), zc_s, r);
        for (int c = warp; c < TB; c += nwarp) {
          float out[D];
          head_raw<D>(net2, t2.xs + c * ip, t2.hws, out);
          const float cn = cot_s[c];
          float ge_b = 0.f, r2 = 0.f, g_factor = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float o = out[d] + hb2[d], sn2 = o * factor2;
            const float rb = zp_s[c * D + d] - (zc_s[c * D + d] + e_b * sn2);
            const float gd = 0.5f * cn * rb;  // e' B, the cotangent of sn2
            const float bk = gd / e_b;
            ge_b += bk * sn2;
            r2 += rb * rb;
            g_factor += gd * o;
            if (lane == 0) {
              const float go = gd * factor2;
              sc2[S::HEADB + d] += go;
              go_s[c * D + d] = go;
              tz_s[c * D + d] = zd_s[c * D + d] + bk;
              zd_s[c * D + d] = -bk;
            }
          }
          if (lane == 0) {
            const float is2 = 1.0f / (2.0f * e_b);
            sc1[S::EPS] += s_b * (ge_b + cn * r2 * is2 * is2);
            sc2[S::FACTOR] += g_factor;
          }
        }
        __syncthreads();
        tile_vjp(t2, net2, th2, zc_s, go_s, r, ft2, gz2_s);
      } else {  // point 0: T is what step 0 sent back
        for (int i = tid; i < TB * D; i += nthr) tz_s[i] = zd_s[i];
        __syncthreads();
      }

      // T complete: the next carries, the noise scale's share of d eps, or
      // dL/dz_0. One thread per chain, all in the first warp.
      if (warp == 0) {
        float ge = 0.f;
        if (lane < TB) {
#pragma unroll
          for (int d = 0; d < D; ++d) {
            float tot = tz_s[lane * D + d];
            if (m_fk) tot += tile_gz<NG, D>(gz1_s, lane, d);
            if (m_bk) tot += tile_gz<NG, D>(gz2_s, lane, d);
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
        if (lane == 0 && m_bk) sc1[S::EPS] += s_b * ge * (1.0f / sqrtf(2.0f * e_b));
      }
      const int lb = len_b(net.in_dim);
      float* pb = a.part_b + ((size_t)p * gridDim.x + blockIdx.x) * 2 * lb;
      flush_point(t1, net, th1, ft1, pb, tile != (int)blockIdx.x);
      flush_point(t2, net2, th2, ft2, pb + lb, tile != (int)blockIdx.x);
    }
  }

  const int la = len_a(net.in_dim, D, D);
  flush_block(t1, net, th1, ft1, a.part_a + (size_t)blockIdx.x * 2 * la);
  flush_block(t2, net2, th2, ft2, a.part_a + (size_t)blockIdx.x * 2 * la + la);
}

template <int NG, int D>
cudaError_t launch_dnf(const KlArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem = dnf_smem_bytes(NG, a.net.in_dim, D);
  cudaError_t err = cudaFuncSetAttribute(kl_dnf_sweep<NG, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kl_dnf_sweep<NG, D><<<blocks, NG * round_up(a.net.in_dim, 32), smem, stream>>>(a);
  return cudaGetLastError();
}

// The net-free sweep (ULA).
constexpr int ULA_CPB = 8;  // chains (warps) per block
// Floats of a block's sums at state dimension d: eps, vd mean, vd logdiag.
__host__ __device__ constexpr int ula_len_sums(int d) { return 1 + 2 * d; }

// One warp per chain, every lane the carries F, Z and the chain's sums;
// point p's betas share (step p's forward role plus step p's backward role,
// met at point p + 1) leaves the block once a point.
template <class T>
__global__ void __launch_bounds__(ULA_CPB * 32) kl_ula_sweep(const KlArgs a) {
  constexpr int D = T::D, LA = ula_len_sums(D);
  __shared__ float par_s[MAX_PAR];
  __shared__ float beta_s[2][ULA_CPB];
  __shared__ float sums_s[ULA_CPB][LA];
  for (int idx = threadIdx.x; idx < a.net.n_par; idx += blockDim.x) par_s[idx] = a.net.tpar[idx];
  __syncthreads();

  const int tid = threadIdx.x, warp = tid >> 5;
  const bool lead = (tid & 31) == 0;
  const int chain = blockIdx.x * ULA_CPB + warp;
  const bool live = chain < a.n;  // a warp past n walks zeros and adds nothing
  const T target(par_s, a.net.n_par, a.net.inv_var_t);
  const int K = a.nbridges, sched = a.eps_schedule;
  const float eps0 = a.scal[0];
  const size_t row = (size_t)a.n * D, at = (size_t)chain * D;
  const float cn = live ? a.cot[chain] : 0.f;

  float vm[D], viv[D], fc[D], zd[D], g_mu[D], g_ld[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    vm[d] = a.vd_mean[d];
    viv[d] = expf(-2.0f * a.vd_logdiag[d]);
    fc[d] = 0.f;
    zd[d] = live ? a.g_zfinal[at + d] : 0.f;
    g_mu[d] = g_ld[d] = 0.f;
  }
  float g_eps = 0.f, gb_pend = 0.f;

  for (int p = K; p >= 0; --p) {
    const bool m_fk = p <= K - 1, m_bk = p >= 1;
    const float e_f = m_fk ? eps_at(eps0, p, K, sched) : 1.f;
    const float e_b = m_bk ? eps_at(eps0, p - 1, K, sched) : 1.f;
    const float s_f = eps_slope(p, K, sched), s_b = eps_slope(p - 1, K, sched);
    const float b_f = m_fk ? a.betas[p] : 0.f;
    const float b_b = m_bk ? a.betas[p - 1] : 0.f;
    float z[D], zp[D], xi[D], gt[D], g_gt[D], g_gq[D], bk[D], hv[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      z[d] = live ? a.traj[p * row + at + d] : 0.f;
      zp[d] = live && m_bk ? a.traj[(p - 1) * row + at + d] : 0.f;
      xi[d] = live && m_bk ? a.noise[(p - 1) * row + at + d] : 0.f;
    }
    typename T::Lanes sl;
    target.score(z, gt, &sl);
    float ge_f = 0.f, ge_b = 0.f, gb_f = 0.f, gb_b = 0.f, r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float gq = -(z[d] - vm[d]) * viv[d];
      const float gtc = clip_f(gt[d], a.clip_t), gqc = clip_f(gq, a.clip_q);
      const float diff = gtc - gqc;
      float ggt = 0.f, ggq = 0.f;
      bk[d] = 0.f;
      if (m_fk) {
        const float ef = e_f * fc[d];
        ge_f += fc[d] * (b_f * gtc + (1.0f - b_f) * gqc);
        gb_f += ef * diff;
        ggt += b_f * ef;
        ggq += (1.0f - b_f) * ef;
      }
      if (m_bk) {
        const float drift = b_b * gtc + (1.0f - b_b) * gqc;
        const float rb = zp[d] - (z[d] + e_b * drift);
        const float gd = 0.5f * cn * rb;  // e' B
        bk[d] = gd / e_b;
        ge_b += bk[d] * drift;
        r2 += rb * rb;
        gb_b += gd * diff;
        ggt += b_b * gd;
        ggq += (1.0f - b_b) * gd;
      }
      g_gt[d] = gt[d] == gtc ? ggt : 0.f;
      g_gq[d] = gq == gqc ? ggq : 0.f;
      g_mu[d] += g_gq[d] * viv[d];
      g_ld[d] += g_gq[d] * (-2.0f * gq);
    }
    target.hvp(sl, g_gt, hv);
    if (m_bk) {
      const float is2 = 1.0f / (2.0f * e_b);
      ge_b += cn * r2 * is2 * is2;
    }
    float ge_xi = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float tot = ((zd[d] + bk[d]) - viv[d] * g_gq[d]) + hv[d];
      if (m_bk) {
        ge_xi = fmaf(tot, xi[d], ge_xi);
        fc[d] = tot;
        zd[d] = tot - bk[d];
      } else if (lead && live) {
        a.g_z0[at + d] = tot;
      }
    }
    g_eps += s_f * ge_f + s_b * ge_b;
    if (m_bk) g_eps += s_b * ge_xi * (1.0f / sqrtf(2.0f * e_b));
    if (m_fk && lead) beta_s[p & 1][warp] = live ? gb_f + gb_pend : 0.f;
    gb_pend = gb_b;
    __syncthreads();
    if (m_fk && tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < ULA_CPB; ++w) sum += beta_s[p & 1][w];
      a.part_b[(size_t)p * gridDim.x + blockIdx.x] = sum;
    }
  }

  if (lead) {
    float* out = sums_s[warp];
    out[0] = live ? g_eps : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      out[1 + d] = live ? g_mu[d] : 0.f;
      out[1 + D + d] = live ? g_ld[d] : 0.f;
    }
  }
  __syncthreads();
  if (tid < LA) {
    float sum = 0.f;
    for (int w = 0; w < ULA_CPB; ++w) sum += sums_s[w][tid];
    a.part_a[(size_t)blockIdx.x * LA + tid] = sum;
  }
}


}  // namespace

extern "C" {

// Launches the reverse sweep with a net and its reduction on `stream`:
// `blocks` blocks of `groups` (2 or 4) groups of feature threads, blocks <=
// the number of chain tiles of 8 x groups chains. cais: 1 the carry form
// (MCD_CAIS_sn), 0 the backward net at i (MCD_ULA_sn). target, arch and
// gate as in cmcd_overdamped_rollout (overdamped.cu), D the target's
// dimension. part_a: (blocks, len_a) and part_b: (points, blocks, len_b,
// with a PIS net's D gate sums) are scratch; out_a: (len_a,), out_b:
// (points, len_b) and g_z0: (n, D) receive the results. tdata and n_data: a
// target's dataset, which none of this source's targets reads
// (kl_logreg.cu's entry of the same name takes the logistic regressions').
// Returns a cudaError_t.
int cmcd_kl_reverse_sweep(const float* traj, const float* noise, const float* cot,
                          const float* g_zfinal, const float* betas, const float* scal,
                          const float* w1z, const float* c1, const float* emb, const float* w2,
                          const float* b2, const float* headw, const float* headb,
                          const float* tpar, const float* vd_mean, const float* vd_logdiag,
                          float* part_a, float* part_b, float* out_a, float* out_b, float* g_z0,
                          int n, int nbridges, int in_dim, int emb_dim, int n_par,
                          int eps_schedule, int blocks, int groups, int cais, int target,
                          float inv_var_t, float clip_t, float clip_q, int arch,
                          const float* gate, const float* tdata, int n_data, void* stream) {
  if (n <= 0 || nbridges <= 0 || (groups != 2 && groups != 4)) return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || blocks > (n + groups * TC - 1) / (groups * TC))
    return (int)cudaErrorInvalidValue;
  if (!target_ok(target, n_par)) return (int)cudaErrorInvalidValue;
  const int d = target_dim(target), gs = arch == 1 ? d : 0;  // gate slots
  if (!net_ok(arch, in_dim, emb_dim, d, gate) || !fits(in_dim, n_par, d, gs))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, tpar,
                    in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t, gate};
  const KlArgs a{traj, noise, cot, g_zfinal, betas, scal, net, vd_mean, vd_logdiag,
                 part_a, part_b, g_z0, n, nbridges, eps_schedule, clip_t, clip_q};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_target(target, [&](auto tag) {
    return dispatch_net(arch, [&](auto net_tag) {
      return launch_tiles<typename decltype(tag)::type, typename decltype(net_tag)::type>(
          a, blocks, groups, cais != 0, s);
    });
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(part_a, part_b, out_a, out_b, blocks, nbridges + 1, blocks, in_dim,
                            d, d, s, gs);
}

// Launches the net-free sweep (MCD_ULA) and its reduction on `stream`, one
// block per 8 chains; D the target's dimension. part_a: (blocks,
// ula_len_sums(D)) and part_b: (K, blocks) are scratch; out_a:
// (ula_len_sums(D),) receives eps, vd mean (D), vd logdiag (D); out_b: (K,)
// betas; g_z0: (n, D). Returns a cudaError_t.
int cmcd_kl_ula_sweep(const float* traj, const float* noise, const float* cot,
                      const float* g_zfinal, const float* betas, const float* scal,
                      const float* tpar, const float* vd_mean, const float* vd_logdiag,
                      float* part_a, float* part_b, float* out_a, float* out_b, float* g_z0,
                      int n, int nbridges, int n_par, int eps_schedule, int target,
                      float inv_var_t, float clip_t, float clip_q, void* stream) {
  if (n <= 0 || nbridges <= 0 || !target_ok(target, n_par)) return (int)cudaErrorInvalidValue;
  const NetArgs net{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, tpar,
                    0, 0, 0, n_par, inv_var_t};
  const KlArgs a{traj, noise, cot, g_zfinal, betas, scal, net, vd_mean, vd_logdiag,
                 part_a, part_b, g_z0, n, nbridges, eps_schedule, clip_t, clip_q};
  const int blocks = (n + ULA_CPB - 1) / ULA_CPB;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_target(target, [&](auto tag) {
    kl_ula_sweep<typename decltype(tag)::type><<<blocks, ULA_CPB * 32, 0, s>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  const int la = ula_len_sums(target_dim(target)), total = la + nbridges;
  partials_reduce<<<(total + 255) / 256, 256, 0, s>>>(part_a, part_b, out_a, out_b, blocks, la,
                                                      nbridges, blocks, 1);
  return (int)cudaGetLastError();
}

// Launches MCD_DNF's sweep and its reduction on `stream`: `blocks` blocks of
// `groups` (2 or 4) groups, as cmcd_kl_reverse_sweep. The first net (w1z ..
// headb) is the forward mean's, the second (w1z2 .. headb2) the backward
// mean's, both geffner nets of width in_dim; scal is [eps0, factor_sn of
// each]; d the state's dimension (2 or 10). gw2: (blocks, 2, in_pad, in_pad
// + 1), part_a: (blocks, 2 len_a) and part_b: (points, blocks, 2 len_b) are
// scratch; out_a: (2 len_a,) and out_b: (points, 2 len_b) receive each net's
// sums in turn (eps in the first net's; betas and vd zero), g_z0: (n, d).
// Returns a cudaError_t.
int cmcd_kl_dnf_sweep(const float* traj, const float* noise, const float* cot,
                      const float* g_zfinal, const float* scal, const float* w1z,
                      const float* c1, const float* emb, const float* w2, const float* b2,
                      const float* headw, const float* headb, const float* w1z2,
                      const float* c12, const float* emb2, const float* w22, const float* b22,
                      const float* headw2, const float* headb2, float* gw2, float* part_a,
                      float* part_b, float* out_a, float* out_b, float* g_z0, int n,
                      int nbridges, int in_dim, int emb_dim, int d, int eps_schedule,
                      int blocks, int groups, void* stream) {
  if (n <= 0 || nbridges <= 0 || (groups != 2 && groups != 4) || (d != 2 && d != 10))
    return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || blocks > (n + groups * TC - 1) / (groups * TC))
    return (int)cudaErrorInvalidValue;
  if (!net_ok(0, in_dim, emb_dim, d, nullptr) || !dnf_fits(in_dim, d))
    return (int)cudaErrorInvalidValue;
  const int ip = round_up(in_dim, 4);
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, nullptr,
                    in_dim, ip, emb_dim, 0, 0.f, nullptr};
  const NetArgs net2{w1z2, c12, emb2, w22, b22, headw2, headb2, nullptr,
                     in_dim, ip, emb_dim, 0, 0.f, nullptr};
  const KlArgs a{traj, noise, cot, g_zfinal, nullptr, scal, net, nullptr, nullptr,
                 part_a, part_b, g_z0, n, nbridges, eps_schedule, INFINITY, INFINITY,
                 net2, gw2};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (d == 2) {
    err = groups == 2 ? launch_dnf<2, 2>(a, blocks, s) : launch_dnf<4, 2>(a, blocks, s);
  } else {
    err = groups == 2 ? launch_dnf<2, 10>(a, blocks, s) : launch_dnf<4, 10>(a, blocks, s);
  }
  if (err != cudaSuccess) return (int)err;
  const int la = 2 * len_a(in_dim, d, d), lb = 2 * len_b(in_dim), total = la + (nbridges + 1) * lb;
  partials_reduce<<<(total + 255) / 256, 256, 0, s>>>(part_a, part_b, out_a, out_b, blocks, la,
                                                      nbridges + 1, blocks, lb);
  return (int)cudaGetLastError();
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_kl_chains_per_group() { return TC; }

// DNF's limits at state dimension d, for the wrapper to check its copy against.
int cmcd_kl_dnf_fits(int in_dim, int d) { return dnf_fits(in_dim, d) ? 1 : 0; }

long long cmcd_kl_dnf_smem_bytes(int groups, int in_dim, int d) {
  return (long long)dnf_smem_bytes(groups, in_dim, d);
}

// The launch's own limits and buffer lengths at state dimension d with
// `gate` slots a warp (0 geffner, d PIS), for the wrapper to check its copy
// against.
int cmcd_kl_fits(int in_dim, int n_par, int d, int gate) {
  return fits(in_dim, n_par, d, gate) ? 1 : 0;
}

long long cmcd_kl_smem_bytes(int groups, int in_dim, int n_par, int d, int gate) {
  return (long long)smem_bytes(groups, in_dim, n_par, d, gate);
}

int cmcd_kl_len_a(int in_dim, int d) { return len_a(in_dim, d, d); }

int cmcd_kl_len_b(int in_dim, int gate) { return len_b(in_dim, gate); }

int cmcd_kl_ula_chains_per_block() { return ULA_CPB; }

int cmcd_kl_ula_len_sums(int d) { return ula_len_sums(d); }

}  // extern "C"
