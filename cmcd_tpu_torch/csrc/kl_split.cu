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
// one Hessian product and one net VJP in z (cmcd_wide.cuh), and nothing of
// the weights' size is written.
//
// What bounds it: 2 D (D + 2 F) + 2 D^2 operations for the apply and the
// score and as many again for the VJP and the Hessian product (whitened: L
// twice each), ~42 MFLOP a chain-point at LGCP; a block streams ~83 MB of
// matrices from L2 a point. Blocks write their sums (eps, betas, vd mean, vd
// logdiag) to scratch and partials_sum adds them in block order: no atomics,
// the same inputs give the same bits.

#include "cmcd_wide.cuh"

namespace {

using namespace cmcd;
using namespace cmcd::wide;

// One chain's workspace: 11 vectors of D (z, gt, sn, ez, tmp, g_gt, g_sn,
// g_mean, total, fk, direct) and 6 of F (h1, h2, sigmoid(a1), sigmoid(a2),
// the VJP's g_h and g_a).
constexpr int SWEEP_ND = 11, SWEEP_NF = 6;

// The sums of one block: eps, betas (K), vd mean (D), vd logdiag (D).
__host__ __device__ inline int len_sums(int d, int k) { return 1 + k + 2 * d; }

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
  float* part;              // (blocks, len_sums)
  float* g_z0;              // (n, D)
  float* gsn;               // (K + 1, n, D): the net-output cotangent of each point
  float* ws;                // (blocks * TBW, chain_floats(SWEEP_ND, SWEEP_NF))
  int n, nbridges, d, eps_schedule;
  float clip_t, clip_q;
};

template <bool WH>
__global__ void __launch_bounds__(THREADS) kl_split_sweep(const SweepArgs a) {
  extern __shared__ float4 smem4[];
  const int d = a.d, f = a.net.f, K = a.nbridges, sp = stage_pitch(f, d);
  float* vs = reinterpret_cast<float*>(smem4);  // TBW x sp
  float* red = vs + TBW * sp;                   // NWARP x RED
  const int dp = round_up(d, 4), fp = round_up(f, 4);
  const size_t cs = chain_floats(SWEEP_ND, SWEEP_NF, d, f);
  float* base = a.ws + (size_t)blockIdx.x * TBW * cs;
  const Vec z{base, cs}, gt{base + dp, cs}, sn{base + 2 * dp, cs}, ez{base + 3 * dp, cs};
  const Vec tmp{base + 4 * dp, cs}, ggt{base + 5 * dp, cs}, gsn{base + 6 * dp, cs};
  const Vec gmean{base + 7 * dp, cs}, total{base + 8 * dp, cs}, fk{base + 9 * dp, cs};
  const Vec direct{base + 10 * dp, cs};
  float* fb = base + SWEEP_ND * dp;
  const Vec h1{fb, cs}, h2{fb + fp, cs}, s1{fb + 2 * fp, cs}, s2{fb + 3 * fp, cs};
  const Vec gh{fb + 4 * fp, cs}, ga{fb + 5 * fp, cs};
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int chain0 = blockIdx.x * TBW;
  const float eps0 = a.scal[0], factor = a.scal[1];
  const int ls = len_sums(d, K);
  float* part = a.part + (size_t)blockIdx.x * ls;
  float* p_mean = part + 1 + K;
  float* p_logd = p_mean + d;
  for (int e = tid; e < ls; e += nthr) part[e] = 0.f;
  float cot[TBW];
#pragma unroll
  for (int c = 0; c < TBW; ++c) cot[c] = chain0 + c < a.n ? a.cot[chain0 + c] : 0.f;

  for (int p = K; p >= 0; --p) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < TBW; ++c) {
      const int chain = chain0 + c;
      for (int k = tid; k < d; k += nthr)
        z(c, k) = chain < a.n ? a.traj[((size_t)p * a.n + chain) * d + k] : 0.f;
    }
    lgcp_score<WH>(a.tgt, d, vs, sp, z, gt, ez, tmp);
    net_apply(a.net, d, p < K - 1 ? p : K - 1, factor, vs, sp, z, h1, h2, sn, &s1, &s2);
    __syncthreads();

    // The point's elementwise terms: sums s[0] d eps (slope-weighted), s[1]
    // d beta_p, s[2] d beta_{p-1}, s[3] g_e of step p - 1 (weighted at the
    // point's end); vd partials per dimension.
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const bool fwd = p <= K - 1, bwd = p >= 1;
    const float b_f = fwd ? a.betas[p] : 0.f, e_f = fwd ? eps_at(eps0, p, K, a.eps_schedule) : 0.f;
    const float sl_f = fwd ? eps_slope(p, K, a.eps_schedule) : 0.f;
    const float b_b = bwd ? a.betas[p - 1] : 0.f;
    const float e_b = bwd ? eps_at(eps0, p - 1, K, a.eps_schedule) : 0.f;
    for (int k = tid; k < d; k += nthr) {
      const float vm = a.vd_mean[k], viv = expf(-2.0f * a.vd_logdiag[k]);
      float pm = 0.f, pl = 0.f;
#pragma unroll
      for (int c = 0; c < TBW; ++c) {
        const int chain = chain0 + c;
        const float zk = z(c, k), gtk = gt(c, k), snk = sn(c, k);
        const float gq = -(zk - vm) * viv;
        const float gtc = clip_f(gtk, a.clip_t), gqc = clip_f(gq, a.clip_q);
        float g_gt = 0.f, g_gq = 0.f, g_sn = 0.f;
        float tot = p == K ? (chain < a.n ? a.g_zfinal[(size_t)chain * d + k] : 0.f) : direct(c, k);
        if (fwd) {
          const float fkv = fk(c, k);
          s[0] += sl_f * (fkv * ((b_f * gtc + (1.0f - b_f) * gqc) - snk));
          s[1] += e_f * fkv * (gtc - gqc);
          g_gt += b_f * e_f * fkv;
          g_gq += (1.0f - b_f) * e_f * fkv;
          g_sn -= e_f * fkv;
        }
        float gm = 0.f;
        if (bwd) {
          const float zp = chain < a.n ? a.traj[((size_t)(p - 1) * a.n + chain) * d + k] : 0.f;
          const float drift = b_b * gtc + (1.0f - b_b) * gqc;
          const float r = zp - (zk + e_b * drift + e_b * snk);
          gm = cot[c] * r / (2.0f * e_b);
          s[3] += gm * (drift + snk) + cot[c] * r * r / ((2.0f * e_b) * (2.0f * e_b));
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
        ggt(c, k) = g_gt;
        gsn(c, k) = g_sn;
        gmean(c, k) = gm;
        total(c, k) = tot - viv * g_gq;
        if (chain < a.n) a.gsn[((size_t)p * a.n + chain) * d + k] = g_sn;
      }
      p_mean[k] += pm;
      p_logd[k] += pl;
    }
    lgcp_hvp_add<WH>(a.tgt, d, vs, sp, ggt, ez, tmp, total);
    net_vjp_add(a.net, d, factor, vs, sp, gsn, s1, s2, gh, ga, total);
    __syncthreads();

    // The draw's term of step p - 1's eps, and the carries (or g_z0).
    const float inv_s = bwd ? 1.0f / sqrtf(2.0f * e_b) : 0.f;
    for (int k = tid; k < d; k += nthr) {
#pragma unroll
      for (int c = 0; c < TBW; ++c) {
        const int chain = chain0 + c;
        const float tot = total(c, k);
        if (bwd) {
          const float xi = chain < a.n ? a.noise[((size_t)(p - 1) * a.n + chain) * d + k] : 0.f;
          s[3] += tot * xi * inv_s;
          fk(c, k) = tot;
          direct(c, k) = tot - gmean(c, k);
        } else if (chain < a.n) {
          a.g_z0[(size_t)chain * d + k] = tot;
        }
      }
    }
    block_sum<4>(s, red);
    if (tid == 0) {
      part[0] += s[0] + (bwd ? eps_slope(p - 1, K, a.eps_schedule) * s[3] : 0.f);
      if (fwd) part[1 + p] += s[1];
      if (bwd) part[p] += s[2];
    }
  }
}

}  // namespace

extern "C" {

// Launches the split sweep and the reduction of its block sums on `stream`:
// target 4 the LGCP (mat Sigma^{-1}), 5 the whitened LGCP (mat L); tpar =
// [mu, a]; the geffner net on [z, emb] (in_dim = dim + emb_dim); part
// (blocks, len_sums) scratch, out (len_sums): d eps0, d betas (K), d vd_mean
// (dim), d vd_logdiag (dim); gsn (K + 1, n, dim); ws the workspace
// (cmcd_kl_split_ws_floats per chain, every chain of the last tile
// included). Returns a cudaError_t (0 on success).
int cmcd_kl_split_sweep(const float* traj, const float* noise, const float* cot,
                        const float* g_zfinal, const float* betas, const float* scal,
                        const float* w1z, const float* c1, const float* emb, const float* w2,
                        const float* b2, const float* headw, const float* headb,
                        const float* mat, const float* counts, const float* tpar,
                        const float* vd_mean, const float* vd_logdiag, float* part, float* out,
                        float* g_z0, float* gsn, float* ws, int n, int nbridges, int dim,
                        int in_dim, int emb_dim, int eps_schedule, int target, float clip_t,
                        float clip_q, void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaSuccess;
  if (!fits(in_dim, dim, emb_dim)) return (int)cudaErrorInvalidValue;
  const int blocks = (n + TBW - 1) / TBW, ls = len_sums(dim, nbridges);
  const SweepArgs a{traj, noise, cot, g_zfinal, betas, scal,
                    WideNet{w1z, c1, emb, w2, b2, headw, headb, in_dim, emb_dim},
                    WideTarget{mat, counts, tpar}, vd_mean, vd_logdiag, part, g_z0, gsn, ws,
                    n, nbridges, dim, eps_schedule, clip_t, clip_q};
  const size_t smem = smem_bytes(in_dim, dim);
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_lgcp(target, [&](auto tag) {
    constexpr bool WH = decltype(tag)::value;
    cudaError_t e = cudaFuncSetAttribute(kl_split_sweep<WH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    kl_split_sweep<WH><<<blocks, THREADS, smem, s>>>(a);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  partials_sum<<<(ls + 255) / 256, 256, 0, s>>>(part, out, blocks, ls);
  return (int)cudaGetLastError();
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The layout's constants and formulas, for the wrapper to check its copy.
int cmcd_kl_split_chains_per_block() { return TBW; }
int cmcd_kl_split_fits(int in_dim, int dim, int emb_dim) { return fits(in_dim, dim, emb_dim) ? 1 : 0; }
long long cmcd_kl_split_smem_bytes(int in_dim, int dim) { return (long long)smem_bytes(in_dim, dim); }
long long cmcd_kl_split_ws_floats(int in_dim, int dim) {
  return (long long)chain_floats(SWEEP_ND, SWEEP_NF, dim, in_dim);
}
int cmcd_kl_split_len_sums(int dim, int nbridges) { return len_sums(dim, nbridges); }

}  // extern "C"
