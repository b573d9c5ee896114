// UHA KL reverse sweep for NVIDIA Hopper (sm_90a): backprop through time of
// the UHA rollout's log-weight and final position from its stored
// positions, momenta and draws.
//
// Replaces cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_uha (the TPU kernel
// "B9") on the many_gmm and the 3-mode gmm targets (D = 2) and Neal's funnel
// (D = 10), for up to
// MAX_LFSTEPS leapfrog steps a bridge; the TPU-only time chunking is not
// ported. The Python wrapper is cmcd_tpu_torch/ops/kl_uha.py::evolve_kl_bwd_uha;
// its plain PyTorch version evolve_kl_bwd_uha_plain walks the same sweep.
// The TPU kernel traces jax.vjp of the bridge (pallas_kl.py:1523-1562) and
// states none of it; here every derivative is written out.
//
// What it computes. With E = e^{md}, V = e^{-2 md}, Q = e^{-2 logdiag} (all
// elementwise over D), s = sqrt(1 - eta^2), z_p, rho_p (p = 0..K, the state
// before bridge p) and the draws xi_p (row p + 1 of the stack: bridge p's
// refresh) data, c_n the cotangent of chain n's log-weight increment and g_K
// that of z_K, bridge p is
//   rho    = eta rho_p + s E xi_p;              q0 = sum rho^2 V
//   r_0    = rho - (e / 2) G_p(y_0),  y_0 = z_p
//   y_l    = y_{l-1} + e V r_{l-1},   r_l = r_{l-1} - e G_p(y_l)   (l = 1..L-1)
//   z_{p+1} = y_L = y_{L-1} + e V r_{L-1}
//   rho_{p+1} = r_{L-1} - (e / 2) G_p(y_L);      q1 = sum rho_{p+1}^2 V
//   delta_p = -(q1 - q0) / 2
//   G_p(y) = -(b_p gt(y) + (1 - b_p) gq(y)),  gq(y) = -(y - mu) Q,
// and L = sum_n [c_n sum_p delta_p + g_K . z_K], differentiated in
// theta = (eps, eta, md, betas, mu, logdiag) and in z_0 with nothing
// stopped. rho_0 = E xi_0 depends on md too; UHA has no endpoint momentum
// term, so the momentum's cotangent starts at zero. With J_G(y)^T u =
// H(y) (-b u) - Q (-(1 - b) u) (H the target's Hessian, symmetric), a
// cotangent u of G_p at y gives g_b_p += (gt - gq) . (-u), g_mu += Q g_gq,
// g_logdiag += -2 gq g_gq with g_gt = -b u, g_gq = -(1 - b) u. Walking
// points p = K..0, carried from point p + 1: T, the whole cotangent of
// z_{p+1} (its Hessian products done), and GR, that of rho_{p+1} less the
// second half-kick (the cotangent of r_{L-1}). At point p (score at z_p with
// its lanes):
//   bridge p (p <= K - 1): recompute rho, r_0, and y_l, r_l (l = 1..L-1) from
//     z_p, rho_p, xi_p; then with g_r = GR, g_y = T:
//     l = L-1..1: g_r += e V g_y; g_e += V r_l . g_y; g_V += e r_l g_y;
//                 u = -e g_r at y_l: g_e += -G_p(y_l) . g_r, the G terms above,
//                 g_y += H(y_l) g_gt - Q g_gq (the score at y_l again, with lanes)
//     l = 0:      g_r += e V g_y; g_e += V r_0 . g_y; g_V += e r_0 g_y
//                 u = -(e / 2) g_r at z_p: g_e += -G_p(z_p) . g_r / 2, G terms
//     g_rho = g_r + c V rho;  g_V += c rho^2 / 2
//     g_eta += g_rho . (rho_p - eta / s E xi_p);  g_E += s xi_p g_rho
//     Z = g_y;  R = eta g_rho
//   point K: Z = g_K;  R = 0
//   bridge p - 1's end (p >= 1): GR' = R - c V rho_p;  g_V += -c rho_p^2 / 2
//     u = -(e / 2) GR' at z_p under b_{p-1}: g_e += -G_{p-1}(z_p) . GR' / 2, G terms
//   T' = Z + H(z_p) g_gt - Q g_gq (one Hessian product for both G terms at z_p)
//   p = 0: dL/dz_0 = T';  g_E-term of rho_0: g_md += R rho_0
// and at the end g_md = E g_E - 2 V g_V (+ the rho_0 term).
//
// What bounds it on the H100. Per chain and bridge 2L - 1 scores and L
// Hessian products (warp reductions over 40 components or 6 pairs; the
// funnel's O(D) sums), O(D) state; the three stacks are 12 D bytes per chain
// and point. As the rollout
// (uha.cu): the bound is microseconds, the time the latency of the
// dependent reductions along a chain.
//
// What the design does about it:
//  * One warp per chain, lanes over the components (the rollout's layout);
//    every lane keeps the carries and the chain's sums in registers.
//  * The target is a template parameter, D its dimension; LMAX (1 or
//    MAX_LFSTEPS) sizes the recomputed inner positions, so lfsteps 1 keeps
//    everything in registers.
//  * betas' gradient leaves the block once per point (eight chains summed in
//    shared memory, double-buffered, one barrier a point), the other sums
//    after the walk; partials_reduce (cmcd_tile.cuh) adds the blocks' partials
//    in block order: no atomics, the same inputs give the same bits.
//  * f32 throughout.

#include "cmcd_tile.cuh"

namespace {

using namespace cmcd;

constexpr int CPB = 8;              // chains (warps) per block
constexpr int MAX_LFSTEPS = 8;

// The per-chain sums a block hands on, for D dimensions: eps, eta, md (D),
// vd mean (D), vd logdiag (D).
__host__ __device__ constexpr int len_sums(int d) { return 2 + 3 * d; }

struct KlUhaArgs {
  const float* ztraj;       // (K + 1, n, D)
  const float* rtraj;       // (K + 1, n, D)
  const float* noise;       // (K + 1, n, D): row p + 1 the draw of bridge p
  const float* cot;         // (n,)
  const float* g_zfinal;    // (n, D)
  const float* betas;       // (K,)
  const float* scal;        // [eps, eta]
  const float* md;          // (D,)
  const float* vd_mean;     // (D,)
  const float* vd_logdiag;  // (D,)
  const float* tpar;        // the target's constants
  float* part_a;            // (blocks, len_sums(D))
  float* part_b;            // (K, blocks)
  float* g_z0;              // (n, D)
  int n, nbridges, lfsteps, n_par;
  float inv_var;
};

template <class T, int LMAX>
__global__ void __launch_bounds__(CPB * 32) kl_uha_sweep(const KlUhaArgs a) {
  constexpr int D = T::D, LA = len_sums(D);
  __shared__ float par_s[MAX_PAR];
  __shared__ float beta_s[2][CPB];
  __shared__ float sums_s[CPB][LA];
  for (int idx = threadIdx.x; idx < a.n_par; idx += blockDim.x) par_s[idx] = a.tpar[idx];
  __syncthreads();

  const int tid = threadIdx.x, warp = tid >> 5;
  const bool lead = (tid & 31) == 0;
  const int chain = blockIdx.x * CPB + warp;
  const bool live = chain < a.n;  // a warp past n walks zeros and adds nothing
  const T target(par_s, a.n_par, a.inv_var);
  const int K = a.nbridges, L = a.lfsteps;
  const float e = a.scal[0], eta = a.scal[1];
  const float sq = sqrtf(1.0f - eta * eta), eta_sq = eta / sq;
  const size_t row = (size_t)a.n * D, at = (size_t)chain * D;

  float em[D], iv[D], mu[D], vq[D], tz[D], gr[D];
  float g_e = 0.f, g_eta = 0.f, g_md[D], g_mu[D], g_ld[D];
  const float c = live ? a.cot[chain] : 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    em[d] = expf(a.md[d]);
    iv[d] = expf(-2.0f * a.md[d]);
    mu[d] = a.vd_mean[d];
    vq[d] = expf(-2.0f * a.vd_logdiag[d]);
    tz[d] = live ? a.g_zfinal[at + d] : 0.f;
    gr[d] = 0.f;
    g_md[d] = g_mu[d] = g_ld[d] = 0.f;
  }
  float gb_pend = 0.f;  // betas[p]'s share from point p + 1 (bridge p's end)

  for (int p = K; p >= 0; --p) {
    float z[D], rp[D], gt[D], gq[D], g_gt[D], g_gq[D], zc[D], rc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      z[d] = live ? a.ztraj[p * row + at + d] : 0.f;
      rp[d] = live ? a.rtraj[p * row + at + d] : 0.f;
      g_gt[d] = g_gq[d] = 0.f;
    }
    typename T::Lanes sl;
    target.score(z, gt, &sl);
#pragma unroll
    for (int d = 0; d < D; ++d) gq[d] = -(z[d] - mu[d]) * vq[d];

    if (p <= K - 1) {  // bridge p starts here
      const float b = a.betas[p];
      float xi[D], rho[D], ys[LMAX][D], rs[LMAX][D], g_r[D], g_y[D];
      float g_b = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        xi[d] = live ? a.noise[(p + 1) * row + at + d] : 0.f;
        rho[d] = eta * rp[d] + sq * (em[d] * xi[d]);
        ys[0][d] = z[d];
        rs[0][d] = rho[d] - 0.5f * e * (-(b * gt[d] + (1.0f - b) * gq[d]));
      }
      // The inner positions y_1..y_{L-1} and momenta r_1..r_{L-1}, again.
      for (int l = 1; l < L && l < LMAX; ++l) {
        float gtl[D];
#pragma unroll
        for (int d = 0; d < D; ++d) ys[l][d] = ys[l - 1][d] + e * (iv[d] * rs[l - 1][d]);
        target.score(ys[l], gtl);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float gql = -(ys[l][d] - mu[d]) * vq[d];
          rs[l][d] = rs[l - 1][d] - e * (-(b * gtl[d] + (1.0f - b) * gql));
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) g_r[d] = gr[d], g_y[d] = tz[d];
      for (int l = (L < LMAX ? L : LMAX) - 1; l >= 0; --l) {
        // y_{l+1} = y_l + e V r_l
#pragma unroll
        for (int d = 0; d < D; ++d) {
          g_r[d] += e * iv[d] * g_y[d];
          g_e += iv[d] * rs[l][d] * g_y[d];
          g_md[d] += -2.0f * iv[d] * (e * rs[l][d] * g_y[d]);
        }
        if (l == 0) break;
        // r_l = r_{l-1} - e G_p(y_l): u = -e g_r at y_l
        float gtl[D], hv[D], ggt[D];
        typename T::Lanes sll;
        target.score(ys[l], gtl, &sll);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float gql = -(ys[l][d] - mu[d]) * vq[d];
          g_e += (b * gtl[d] + (1.0f - b) * gql) * g_r[d];
          g_b += e * (gtl[d] - gql) * g_r[d];
          ggt[d] = e * b * g_r[d];
          const float ggq = e * (1.0f - b) * g_r[d];
          g_mu[d] += vq[d] * ggq;
          g_ld[d] += -2.0f * gql * ggq;
          g_y[d] -= vq[d] * ggq;
        }
        target.hvp(sll, ggt, hv);
#pragma unroll
        for (int d = 0; d < D; ++d) g_y[d] += hv[d];
      }
      // r_0 = rho - (e / 2) G_p(z_p), the refresh, and delta's q0.
      float g_rho2 = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        g_e += 0.5f * (b * gt[d] + (1.0f - b) * gq[d]) * g_r[d];
        g_b += 0.5f * e * (gt[d] - gq[d]) * g_r[d];
        g_gt[d] += 0.5f * e * b * g_r[d];
        g_gq[d] += 0.5f * e * (1.0f - b) * g_r[d];
        const float g_rho = g_r[d] + c * iv[d] * rho[d];
        g_md[d] += -2.0f * iv[d] * (0.5f * c * rho[d] * rho[d]);
        g_rho2 += g_rho * (rp[d] - eta_sq * (em[d] * xi[d]));
        g_md[d] += em[d] * (sq * xi[d] * g_rho);
        zc[d] = g_y[d];
        rc[d] = eta * g_rho;
      }
      g_eta += g_rho2;
      if (lead) beta_s[p & 1][warp] = live ? g_b + gb_pend : 0.f;
    } else {  // point K
#pragma unroll
      for (int d = 0; d < D; ++d) zc[d] = tz[d], rc[d] = 0.f;
    }

    if (p >= 1) {  // bridge p - 1 ends here: rho_p is its new momentum
      const float b = a.betas[p - 1];
      float g_b = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float grn = rc[d] - c * iv[d] * rp[d];
        g_md[d] += -2.0f * iv[d] * (-0.5f * c * rp[d] * rp[d]);
        g_e += 0.5f * (b * gt[d] + (1.0f - b) * gq[d]) * grn;
        g_b += 0.5f * e * (gt[d] - gq[d]) * grn;
        g_gt[d] += 0.5f * e * b * grn;
        g_gq[d] += 0.5f * e * (1.0f - b) * grn;
        gr[d] = grn;
      }
      gb_pend = g_b;
    }
    float hv[D];
    target.hvp(sl, g_gt, hv);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      g_mu[d] += vq[d] * g_gq[d];
      g_ld[d] += -2.0f * gq[d] * g_gq[d];
      tz[d] = zc[d] + hv[d] - vq[d] * g_gq[d];
    }
    if (p == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        g_md[d] += rc[d] * rp[d];  // rho_0 = E xi_0: d rho_0 / d md = rho_0
        if (lead && live) a.g_z0[at + d] = tz[d];
      }
    }
    __syncthreads();
    if (p <= K - 1 && tid == 0) {
      float s = 0.f;
      for (int w = 0; w < CPB; ++w) s += beta_s[p & 1][w];
      a.part_b[(size_t)p * gridDim.x + blockIdx.x] = s;
    }
  }

  if (lead) {
    float* out = sums_s[warp];
    out[0] = live ? g_e : 0.f;
    out[1] = live ? g_eta : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      out[2 + d] = live ? g_md[d] : 0.f;
      out[2 + D + d] = live ? g_mu[d] : 0.f;
      out[2 + 2 * D + d] = live ? g_ld[d] : 0.f;
    }
  }
  __syncthreads();
  if (tid < LA) {
    float s = 0.f;
    for (int w = 0; w < CPB; ++w) s += sums_s[w][tid];
    a.part_a[(size_t)blockIdx.x * LA + tid] = s;
  }
}

template <class T>
cudaError_t launch_sweep(const KlUhaArgs& a, int blocks, cudaStream_t stream) {
  if (a.lfsteps == 1) {
    kl_uha_sweep<T, 1><<<blocks, CPB * 32, 0, stream>>>(a);
  } else {
    kl_uha_sweep<T, MAX_LFSTEPS><<<blocks, CPB * 32, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the sweep and its reduction on `stream`. target as in
// cmcd_uha_rollout (uha.cu). part_a: (blocks, len_sums) and part_b: (K,
// blocks) are scratch, blocks = ceil(n / 8); out_a: (len_sums(D),) receives
// eps, eta, md (D), vd mean (D), vd logdiag (D); out_b: (K,) betas; g_z0:
// (n, D). Returns a cudaError_t.
int cmcd_kl_uha_sweep(const float* ztraj, const float* rtraj, const float* noise,
                      const float* cot, const float* g_zfinal, const float* betas,
                      const float* scal, const float* md, const float* vd_mean,
                      const float* vd_logdiag, const float* tpar, float* part_a, float* part_b,
                      float* out_a, float* out_b, float* g_z0, int n, int nbridges, int lfsteps,
                      int target, int n_par, float inv_var, void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaErrorInvalidValue;
  if (lfsteps < 1 || lfsteps > MAX_LFSTEPS || !target_ok(target, n_par))
    return (int)cudaErrorInvalidValue;
  const KlUhaArgs a{ztraj, rtraj, noise, cot, g_zfinal, betas, scal, md, vd_mean, vd_logdiag,
                    tpar, part_a, part_b, g_z0, n, nbridges, lfsteps, n_par, inv_var};
  const int blocks = (n + CPB - 1) / CPB;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_target<false>(target, [&](auto tag) {
    return launch_sweep<typename decltype(tag)::type>(a, blocks, s);
  });
  if (err != cudaSuccess) return (int)err;
  const int la = len_sums(target_dim(target)), total = la + nbridges;
  partials_reduce<<<(total + 255) / 256, 256, 0, s>>>(part_a, part_b, out_a, out_b, blocks, la,
                                                      nbridges, blocks, 1);
  return (int)cudaGetLastError();
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The launch's own limits and buffer lengths, for the wrapper to check its
// copy against.
int cmcd_kl_uha_chains_per_block() { return CPB; }

int cmcd_kl_uha_max_lfsteps() { return MAX_LFSTEPS; }

int cmcd_kl_uha_len_sums(int d) { return len_sums(d); }

}  // extern "C"
