// VarGrad replay backward for NVIDIA Hopper (sm_90a): the gradient of the
// CAIS_VAR log-weight increments from a stored trajectory.
//
// Replaces cmcd_tpu/ops/pallas_vargrad.py::evolve_vargrad_bwd_replay (the TPU
// kernel "B2") on the many_gmm target (dim 2) with the two-layer geffner net.
// The Python wrapper is cmcd_tpu_torch/ops/vargrad.py::evolve_vargrad_bwd_replay;
// its plain PyTorch version evolve_vargrad_bwd_replay_plain states the same
// point loss and lets autograd differentiate it. The TPU kernel traces
// jax.grad of that loss; here every derivative is written out.
//
// What it computes. The VarGrad loss stops the gradient at every state, so
// with z_0..z_K data and c_n the cotangent of chain n's summed increments,
//   L = sum_n c_n sum_i (bk_lp_i - fk_lp_i)
// splits into one term per stored point j = 0..K, and the CAIS structure
// (backward net at i + 1) makes both kernels that touch z_j use the same
// net output sn = net(z_j, min(j, K - 1)). Per point and chain:
//   gq = -(z_j - mu) * exp(-2 logdiag);  gtc = clip(gt(z_j), ct), gqc = clip(gq, cq)
//   D(b) = b * gtc + (1 - b) * gqc
//   forward term, live for j <= K-1 (e = eps_j, b = beta_j):
//     r_fk = z_{j+1} - (z_j + e D(b) - e sn),  fk_lp = -|r_fk|^2 / (4e) - log(2e) - log(2 pi)
//   backward term, live for j >= 1 (e' = eps_{j-1}, b' = beta_{j-1}):
//     r_bk = z_{j-1} - (z_j + e' D(b') + e' sn), bk_lp likewise
//   L_j = c_n (m_bk bk_lp - m_fk fk_lp).
// The derivatives (dim = 2; e / (2e) = 1/2 removes eps from most of them):
//   dL/dsn       = c/2 (m_bk r_bk + m_fk r_fk)                      =: G
//   dL/dbeta_j   = -c/2 m_fk r_fk . (gtc - gqc)     (this point's forward term)
//   dL/dbeta_j-1 = +c/2 m_bk r_bk . (gtc - gqc)     (this point's backward term)
//   dL/dgqc      = c/2 (m_bk r_bk (1 - b') - m_fk r_fk (1 - b))     =: Gq
//   dL/dmu       = Gq * exp(-2 logdiag),  dL/dlogdiag = Gq * (-2 gq), zero where gq is clipped
//   dL/deps0     = -c m_fk s_j  [r_fk.(D(b) - sn)/(2e)  + |r_fk|^2/(2e)^2  - 2/(2e)]
//                  +c m_bk s_j-1[r_bk.(D(b') + sn)/(2e') + |r_bk|^2/(2e')^2 - 2/(2e')]
//                  with s_i = d eps_i / d eps0 of the schedule (cmcd_common.cuh)
//   net, with out = h2 @ headW^T + headb and sn = out * factor_sn:
//     dfactor = G . out;  g_out = G * factor;  dheadb = g_out;  dheadW[d] = g_out[d] h2
//     g_h2 = g_out @ headW;  g_a2 = g_h2 * sigmoid(a2);  db2 = g_a2;  dW2 = h1 (x) g_a2
//     g_h1 = g_h2 + W2 g_a2;  g_a1 = g_h1 * sigmoid(a1);  dW1[:2] = z (x) g_a1
//   each summed over chains and points. Masked terms are never divided by
//   their eps (0 * inf would be NaN): r is set to 0 where its term is dead.
// The embedding half of layer 1 is a product of the wrapper (c1 = emb @
// W1[2:] + b1, once per call), so its transpose is the wrapper's too: the
// kernel returns the per-point sums over chains G1[j] = sum_n g_a1 and
// GH1[j] = sum_n g_h1, from which two small products give demb, dW1[2:], db1.
//
// What bounds it on the H100. Per point and chain the layer-2 apply, the
// product W2 g_a2 and the outer product h1 (x) g_a2 are 3 x in_dim^2 FMAs
// (52k at in_dim 132); the trajectory is 8 bytes per point: bound by FP32
// arithmetic and shared-memory bandwidth, not by device memory.
//
// What the design does about it:
//  * Blocks run in no order, so nothing accumulates across them. Block
//    (j, s) takes trajectory point j and the chain tiles s, s + S, ...; it
//    sums its own partial gradients (dW2 in shared memory, the per-feature
//    sums in registers, the scalars per warp) and writes them to scratch.
//    A second kernel of this file, vargrad_reduce, adds the partials in
//    block order. No atomics: the same inputs give the same bits.
//  * Shared memory of one block at in_dim 132: W2 and the dW2 accumulator,
//    69 KiB each with row stride in_pad + 1 (odd, so both the column walk of
//    the apply and the row walk of W2 g_a2 are free of bank conflicts), the
//    hidden tile in both orientations, the h2 / g_a2 tile, head, means and
//    per-chain exchange: 192 KiB of the 227 KiB a block may use. One block
//    per SM, so a block runs NG = 4 groups of feature threads (640 threads
//    at in_dim 132) on a tile of 32 chains to keep the SM's issue slots fed.
//  * Thread (g, f) owns feature f for the 8 chains of group g through the
//    apply and the VJP (activations and sigmoids stay in its registers), and
//    column f of dW2 for the g-th quarter of the rows k in the outer
//    product, where it reads h1 transposed as broadcast float4s.
//  * The head, the score and the scalar derivatives take one warp per chain.
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.

#include "cmcd_common.cuh"

namespace {

using namespace cmcd;

constexpr int NG = 4;             // groups of feature threads
constexpr int TB = NG * TC;       // chains per tile
constexpr int TBP = TB + 4;       // row stride of the transposed hidden tile
constexpr int MAX_THREADS = 640;  // NG x 160 features
constexpr int NSCAL = 10;         // eps, mean x2, logdiag x2, factor, headb x2, beta_fk, beta_bk
constexpr int NFEAT = 7;          // headW x2, b2, W1z x2, G1, GH1

struct VargradArgs {
  const float* traj;        // (K + 1, n, 2)
  const float* cot;         // (n,)
  const float* betas;       // (K,)
  const float* scal;        // [eps0, factor_sn]
  NetArgs net;
  const float* vd_mean;     // (2,)
  const float* vd_logdiag;  // (2,)
  float* part_a;            // (blocks, len_a): summed over all blocks
  float* part_b;            // (K + 1, splits, len_b): summed over splits
  int n, nbridges, splits, eps_schedule;
  float clip_t, clip_q;
};

// Partials summed over every block: dW2 (in x in), dheadW (2 x in), db2,
// dW1[:2] (2 x in), then eps, mean x2, logdiag x2, factor, headb x2.
__host__ __device__ inline int len_a(int in_dim) { return in_dim * in_dim + 5 * in_dim + 8; }
// Partials of one point: G1 (in), GH1 (in), dbeta_j, dbeta_{j-1}.
__host__ __device__ inline int len_b(int in_dim) { return 2 * in_dim + 2; }

__host__ inline size_t smem_bytes(int in_dim, int n_mix) {
  const int ip = round_up(in_dim, 4);
  size_t floats = (size_t)2 * ip * (ip + 1) + 2 * TB * ip + (size_t)ip * TBP + 2 * ip +
                  round_up(2 * n_mix, 4) + 4 * TB * DIM + TB + NSCAL * (MAX_THREADS / 32);
  return floats * sizeof(float);
}

__host__ inline bool fits(int in_dim, int n_mix) {
  return in_dim >= 1 && NG * round_up(in_dim, 32) <= MAX_THREADS && n_mix >= 1 &&
         n_mix <= MAX_MIX && smem_bytes(in_dim, n_mix) <= MAX_SMEM;
}

__global__ void __launch_bounds__(MAX_THREADS) vargrad_replay(const VargradArgs a) {
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges, ws = ip + 1;
  float* w2s = reinterpret_cast<float*>(smem4);      // in_pad x ws
  float* gw2s = w2s + ip * ws;                       // in_pad x ws: dW2 of this block
  float* h1s = gw2s + ip * ws;                       // TB x in_pad
  float* xs = h1s + TB * ip;                         // TB x in_pad: h2, then g_a2
  float* h1t = xs + TB * ip;                         // in_pad x TBP: h1 transposed
  float* hws = h1t + ip * TBP;                       // 2 x in_pad
  float* mus = hws + 2 * ip;                         // n_mix x 2 (padded to 4)
  float* zc_s = mus + round_up(2 * net.n_mix, 4);    // TB x 2: z_j
  float* zp_s = zc_s + TB * DIM;                     // TB x 2: z_{j-1}
  float* zn_s = zp_s + TB * DIM;                     // TB x 2: z_{j+1}
  float* go_s = zn_s + TB * DIM;                     // TB x 2: g_out
  float* cot_s = go_s + TB * DIM;                    // TB
  float* sc_s = cot_s + TB;                          // warps x NSCAL

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nthr >> 5;
  const int fw = nthr / NG, g = tid / fw, f = tid - g * fw;
  const bool feat = f < in;
  const int j = blockIdx.x / a.splits, split = blockIdx.x - j * a.splits;
  const int idx = min(j, K - 1);
  const bool m_fk = j <= K - 1, m_bk = j >= 1;

  load_w2(net, w2s, ws);
  // gw2s, h1s, xs and h1t follow w2s: zero them all (pad columns stay zero).
  for (int i = tid; i < ip * ws + 2 * TB * ip + ip * TBP; i += nthr) gw2s[i] = 0.f;
  for (int i = tid; i < 2 * ip; i += nthr) {
    const int d = i / ip, k = i - d * ip;
    hws[i] = k < in ? net.headw[d * in + k] : 0.f;
  }
  for (int i = tid; i < 2 * net.n_mix; i += nthr) mus[i] = net.means[i];

  const float w1z0 = feat ? net.w1z[f] : 0.f;
  const float w1z1 = feat ? net.w1z[in + f] : 0.f;
  const float b2f = feat ? net.b2[f] : 0.f;
  const float hw0 = feat ? net.headw[f] : 0.f;
  const float hw1 = feat ? net.headw[in + f] : 0.f;
  const float eps0 = a.scal[0], factor = a.scal[1];
  const float eps_j = m_fk ? eps_at(eps0, j, K, a.eps_schedule) : 1.f;
  const float eps_p = m_bk ? eps_at(eps0, j - 1, K, a.eps_schedule) : 1.f;
  const float de_j = eps_slope(j, K, a.eps_schedule);
  const float de_p = eps_slope(j - 1, K, a.eps_schedule);
  const float beta_j = m_fk ? a.betas[j] : 0.f;
  const float beta_p = m_bk ? a.betas[j - 1] : 0.f;
  float vm[DIM], viv[DIM], hb[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    vm[d] = a.vd_mean[d];
    viv[d] = expf(-2.0f * a.vd_logdiag[d]);
    hb[d] = net.headb[d];
  }

  // Sums of this block. Per feature thread, in registers: dheadW[0][f],
  // dheadW[1][f], db2[f], dW1[0][f], dW1[1][f], G1[f], GH1[f]. Per warp, in
  // shared memory and touched by lane 0 only: the NSCAL scalars.
  float ft[NFEAT];
#pragma unroll
  for (int q = 0; q < NFEAT; ++q) ft[q] = 0.f;
  for (int i = tid; i < nwarp * NSCAL; i += nthr) sc_s[i] = 0.f;
  float* sc = sc_s + warp * NSCAL;
  __syncthreads();

  const int ntiles = (a.n + TB - 1) / TB;
  const int kper = (in + NG - 1) / NG;
  for (int tile = split; tile < ntiles; tile += a.splits) {
    const int base = tile * TB;
    if (tid < TB * DIM) {
      const int chain = base + tid / DIM, d = tid - (tid / DIM) * DIM;
      const bool live = chain < a.n;
      zc_s[tid] = live ? a.traj[((size_t)j * a.n + chain) * DIM + d] : 0.f;
      zp_s[tid] = live && m_bk ? a.traj[((size_t)(j - 1) * a.n + chain) * DIM + d] : 0.f;
      zn_s[tid] = live && m_fk ? a.traj[((size_t)(j + 1) * a.n + chain) * DIM + d] : 0.f;
    }
    if (tid < TB) cot_s[tid] = base + tid < a.n ? a.cot[base + tid] : 0.f;
    __syncthreads();

    // Layer 1: thread (g, f), the 8 chains of group g.
    float sig1[TC], h1v[TC];
    if (feat) {
      float a1[TC];
      layer1_feature(net, idx, f, w1z0, w1z1, zc_s + g * TC * DIM, a1, h1v);
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        sig1[c] = sigmoid_f(a1[c]);
        h1s[(g * TC + c) * ip + f] = h1v[c];
      }
      float4* col = reinterpret_cast<float4*>(h1t + f * TBP + g * TC);
      col[0] = make_float4(h1v[0], h1v[1], h1v[2], h1v[3]);
      col[1] = make_float4(h1v[4], h1v[5], h1v[6], h1v[7]);
    }
    __syncthreads();

    // Layer 2.
    float sig2[TC], h2v[TC];
    if (feat) {
      float acc[TC];
      layer2_feature(w2s, ws, h1s + g * TC * ip, ip, f, acc);
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const float a2 = acc[c] + b2f;
        sig2[c] = sigmoid_f(a2);
        h2v[c] = h1v[c] + softplus_f(a2);
        xs[(g * TC + c) * ip + f] = h2v[c];
      }
    }
    __syncthreads();

    // Head, score and the scalar derivatives: one warp per chain.
    for (int c = warp; c < TB; c += nwarp) {
      float out[DIM], gt[DIM];
      head_and_score(net, xs + c * ip, hws, mus, zc_s[c * DIM], zc_s[c * DIM + 1], out, gt);
      if (lane == 0) {
        const float cn = cot_s[c];
        float t_fk = 0.f, t_bk = 0.f, r2_fk = 0.f, r2_bk = 0.f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          const float z = zc_s[c * DIM + d];
          const float o = out[d] + hb[d], sn = o * factor;
          const float gq = -(z - vm[d]) * viv[d];
          const float gtc = clip_f(gt[d], a.clip_t), gqc = clip_f(gq, a.clip_q);
          const float dj = beta_j * gtc + (1.0f - beta_j) * gqc;
          const float dp = beta_p * gtc + (1.0f - beta_p) * gqc;
          const float r_fk = m_fk ? zn_s[c * DIM + d] - ((z + eps_j * dj) - eps_j * sn) : 0.f;
          const float r_bk = m_bk ? zp_s[c * DIM + d] - ((z + eps_p * dp) + eps_p * sn) : 0.f;
          const float gsn = 0.5f * cn * (r_bk + r_fk);
          go_s[c * DIM + d] = gsn * factor;
          sc[5] += gsn * o;
          sc[6 + d] += gsn * factor;
          const float diff = gtc - gqc;
          sc[8] += -0.5f * cn * r_fk * diff;
          sc[9] += 0.5f * cn * r_bk * diff;
          if (gq == gqc) {  // not clipped
            const float g_gq = 0.5f * cn * (r_bk * (1.0f - beta_p) - r_fk * (1.0f - beta_j));
            sc[1 + d] += g_gq * viv[d];
            sc[3 + d] += g_gq * (-2.0f * gq);
          }
          t_fk += r_fk * (dj - sn);
          t_bk += r_bk * (dp + sn);
          r2_fk += r_fk * r_fk;
          r2_bk += r_bk * r_bk;
        }
        if (m_fk) {
          const float is2 = 1.0f / (2.0f * eps_j);
          sc[0] -= cn * de_j * (t_fk * is2 + r2_fk * is2 * is2 - (float)DIM * is2);
        }
        if (m_bk) {
          const float is2 = 1.0f / (2.0f * eps_p);
          sc[0] += cn * de_p * (t_bk * is2 + r2_bk * is2 * is2 - (float)DIM * is2);
        }
      }
    }
    __syncthreads();

    // Head backward and g_a2 = g_h2 * sigmoid(a2); g_a2 replaces h2 in xs.
    float gh2[TC];
    if (feat) {
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int cc = g * TC + c;
        const float go0 = go_s[cc * DIM], go1 = go_s[cc * DIM + 1];
        ft[0] = fmaf(go0, h2v[c], ft[0]);
        ft[1] = fmaf(go1, h2v[c], ft[1]);
        gh2[c] = go0 * hw0 + go1 * hw1;
        const float ga2 = gh2[c] * sig2[c];
        ft[2] += ga2;
        xs[cc * ip + f] = ga2;
      }
    }
    __syncthreads();

    if (feat) {
      // g_h1[c][f] = g_h2[c][f] + sum_k W2[f][k] g_a2[c][k]: row f of W2.
      float acc[TC];
#pragma unroll
      for (int c = 0; c < TC; ++c) acc[c] = 0.f;
      const float* wrow = w2s + f * ws;
      const float* gs = xs + g * TC * ip;
#pragma unroll 2
      for (int k = 0; k < ip; k += 4) {
        const float wa = wrow[k], wb = wrow[k + 1], wc = wrow[k + 2], wd = wrow[k + 3];
#pragma unroll
        for (int c = 0; c < TC; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(gs + c * ip + k);
          acc[c] = fmaf(v.x, wa, acc[c]);
          acc[c] = fmaf(v.y, wb, acc[c]);
          acc[c] = fmaf(v.z, wc, acc[c]);
          acc[c] = fmaf(v.w, wd, acc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int cc = g * TC + c;
        const float gh1 = gh2[c] + acc[c];
        const float ga1 = gh1 * sig1[c];
        ft[3] = fmaf(zc_s[cc * DIM], ga1, ft[3]);
        ft[4] = fmaf(zc_s[cc * DIM + 1], ga1, ft[4]);
        ft[5] += ga1;
        ft[6] += gh1;
      }

      // dW2[k][f] += sum_c h1[c][k] g_a2[c][f] over all TB chains, for the
      // rows k of this thread's group.
      float ga[TB];
#pragma unroll
      for (int c = 0; c < TB; ++c) ga[c] = xs[c * ip + f];
      const int k1 = min(in, (g + 1) * kper);
      for (int k = g * kper; k < k1; ++k) {
        float s = gw2s[k * ws + f];
        const float4* hk = reinterpret_cast<const float4*>(h1t + k * TBP);
#pragma unroll
        for (int c4 = 0; c4 < TB / 4; ++c4) {
          const float4 h = hk[c4];
          s = fmaf(h.x, ga[4 * c4], s);
          s = fmaf(h.y, ga[4 * c4 + 1], s);
          s = fmaf(h.z, ga[4 * c4 + 2], s);
          s = fmaf(h.w, ga[4 * c4 + 3], s);
        }
        gw2s[k * ws + f] = s;
      }
    }
    __syncthreads();
  }

  // This block's partials. dW2 from shared memory; the per-feature sums
  // across the NG groups and the scalars across the warps, in fixed order.
  const int b = blockIdx.x;
  float* pa = a.part_a + (size_t)b * len_a(in);
  float* pb = a.part_b + (size_t)b * len_b(in);
  for (int i = tid; i < in * in; i += nthr) {
    const int k = i / in, c = i - k * in;
    pa[i] = gw2s[k * ws + c];
  }
  if (feat) {
#pragma unroll
    for (int q = 0; q < NFEAT; ++q) xs[(g * NFEAT + q) * ip + f] = ft[q];
  }
  __syncthreads();
  for (int i = tid; i < NFEAT * in; i += nthr) {
    const int q = i / in, c = i - q * in;
    float s = 0.f;
    for (int gg = 0; gg < NG; ++gg) s += xs[(gg * NFEAT + q) * ip + c];
    if (q < 5) pa[in * in + i] = s;  // dheadW (2 x in), db2, dW1[:2] (2 x in)
    else pb[(q - 5) * in + c] = s;   // G1, GH1
  }
  if (tid < NSCAL) {
    float s = 0.f;
    for (int w = 0; w < nwarp; ++w) s += sc_s[w * NSCAL + tid];
    if (tid < 8) pa[in * in + 5 * in + tid] = s;
    else pb[2 * in + tid - 8] = s;
  }
}

// Adds the partials in block order: out_a[e] over all blocks, out_b[j][e]
// over the splits of point j.
__global__ void vargrad_reduce(const float* part_a, const float* part_b, float* out_a,
                               float* out_b, int nblocks, int la, int npoints, int splits,
                               int lb) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < la) {
    float s = 0.f;
    for (int b = 0; b < nblocks; ++b) s += part_a[(size_t)b * la + e];
    out_a[e] = s;
  } else if (e - la < npoints * lb) {
    const int e2 = e - la, j = e2 / lb, q = e2 - j * lb;
    float s = 0.f;
    for (int t = 0; t < splits; ++t) s += part_b[((size_t)j * splits + t) * lb + q];
    out_b[e2] = s;
  }
}

}  // namespace

extern "C" {

// Launches the backward and its reduction on `stream`. part_a: (points x
// splits, len_a) and part_b: (points, splits, len_b) are scratch; out_a:
// (len_a,) and out_b: (points, len_b) receive the sums. Returns a cudaError_t.
int cmcd_vargrad_replay(const float* traj, const float* cot, const float* betas,
                        const float* scal, const float* w1z, const float* c1,
                        const float* emb, const float* w2, const float* b2,
                        const float* headw, const float* headb, const float* means,
                        const float* vd_mean, const float* vd_logdiag, float* part_a,
                        float* part_b, float* out_a, float* out_b, int n, int nbridges,
                        int in_dim, int emb_dim, int n_mix, int eps_schedule, int splits,
                        float inv_var_t, float clip_t, float clip_q, void* stream) {
  if (n <= 0 || nbridges <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  if (in_dim != DIM + emb_dim || !fits(in_dim, n_mix)) return (int)cudaErrorInvalidValue;
  const int threads = NG * round_up(in_dim, 32);
  const int in_pad = round_up(in_dim, 4);
  const size_t smem = smem_bytes(in_dim, n_mix);
  cudaError_t err = cudaFuncSetAttribute(
      vargrad_replay, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, means,
                    in_dim, in_pad, emb_dim, n_mix, inv_var_t};
  const VargradArgs a{traj, cot, betas, scal, net, vd_mean, vd_logdiag, part_a, part_b,
                      n, nbridges, splits, eps_schedule, clip_t, clip_q};
  const int points = nbridges + 1, blocks = points * splits;
  vargrad_replay<<<blocks, threads, smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int la = len_a(in_dim), lb = len_b(in_dim), total = la + points * lb;
  vargrad_reduce<<<(total + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part_a, part_b, out_a, out_b, blocks, la, points, splits, lb);
  return (int)cudaGetLastError();
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_vargrad_chains_per_tile() { return TB; }

// The launch's own limits and buffer lengths, for the wrapper to check its
// copy against.
int cmcd_vargrad_fits(int in_dim, int n_mix) { return fits(in_dim, n_mix) ? 1 : 0; }

long long cmcd_vargrad_smem_bytes(int in_dim, int n_mix) {
  return (long long)smem_bytes(in_dim, n_mix);
}

int cmcd_vargrad_len_a(int in_dim) { return len_a(in_dim); }

int cmcd_vargrad_len_b(int in_dim) { return len_b(in_dim); }

}  // extern "C"
