// VarGrad backward for NVIDIA Hopper (sm_90a): the gradient of the CAIS_VAR
// log-weight increments, from a stored trajectory (replay) or from the
// trajectory rolled again inside the kernel (reroll).
//
// Replaces cmcd_tpu/ops/pallas_vargrad.py::evolve_vargrad_bwd_replay (the TPU
// kernel "B2") and ::evolve_vargrad_bwd_pallas ("B5") on the many_gmm and
// the 3-mode gmm targets (dim 2), Neal's funnel and the standard normal
// (dim 10), the target a template parameter whose D sizes every per-chain
// array (cmcd_common.cuh), and the net a template parameter: the two-layer
// geffner net or a PIS net ("dds", "dds_grad"; the TPU kernels' PIS branch
// is pallas_vargrad.py:151-156, 455-460: its output clipped and its
// cotangent masked where the clip bit, dds_grad's gate term a per-point sum
// sum_n g_sn * clip(gt) in the point's partials, the table row NET::row(j,
// K)). The Python wrappers are
// cmcd_tpu_torch/ops/vargrad.py::evolve_vargrad_bwd_replay and
// ::evolve_vargrad_bwd_reroll; their plain PyTorch versions state the same
// point loss and let autograd differentiate it. The TPU kernels trace
// jax.grad of that loss; here every derivative is written out.
//
// What it computes. The VarGrad loss stops the gradient at every state, so
// with z_0..z_K data and c_n the cotangent of chain n's summed increments,
//   L = sum_n c_n sum_i (bk_lp_i - fk_lp_i)
// splits into one term per stored point j = 0..K, and the CAIS structure
// (backward net at i + 1) makes both kernels that touch z_j use the same
// net output sn = net(z_j, NET::row(j, K)). Per point and chain:
//   gq = -(z_j - mu) * exp(-2 logdiag);  gtc = clip(gt(z_j), ct), gqc = clip(gq, cq)
//   D(b) = b * gtc + (1 - b) * gqc
//   forward term, live for j <= K-1 (e = eps_j, b = beta_j):
//     r_fk = z_{j+1} - (z_j + e D(b) - e sn),  fk_lp = -|r_fk|^2 / (4e) - log(2e) - log(2 pi)
//   backward term, live for j >= 1 (e' = eps_{j-1}, b' = beta_{j-1}):
//     r_bk = z_{j-1} - (z_j + e' D(b') + e' sn), bk_lp likewise
//   L_j = c_n (m_bk bk_lp - m_fk fk_lp).
// The derivatives (dim D; e / (2e) = 1/2 removes eps from most of them):
//   dL/dsn       = c/2 (m_bk r_bk + m_fk r_fk)                      =: G
//   dL/dbeta_j   = -c/2 m_fk r_fk . (gtc - gqc)     (this point's forward term)
//   dL/dbeta_j-1 = +c/2 m_bk r_bk . (gtc - gqc)     (this point's backward term)
//   dL/dgqc      = c/2 (m_bk r_bk (1 - b') - m_fk r_fk (1 - b))     =: Gq
//   dL/dmu       = Gq * exp(-2 logdiag),  dL/dlogdiag = Gq * (-2 gq), zero where gq is clipped
//   dL/deps0     = -c m_fk s_j  [r_fk.(D(b) - sn)/(2e)  + |r_fk|^2/(2e)^2  - D/(2e)]
//                  +c m_bk s_j-1[r_bk.(D(b') + sn)/(2e') + |r_bk|^2/(2e')^2 - D/(2e')]
//                  with s_i = d eps_i / d eps0 of the schedule (cmcd_common.cuh)
//   dL/dout     = G * factor_sn, dfactor = G . out (PIS: G where the clip
//                  passed out; the gate table's dL/dg_t = G * clip(gt)): the
//                  net's own VJP from there is cmcd_tile.cuh's
//   each summed over chains and points. Masked terms are never divided by
//   their eps (0 * inf would be NaN): r is set to 0 where its term is dead.
//
// What bounds it on the H100. Per point and chain the layer-2 apply, the
// product W2 g_a2 and the outer product h1 (x) g_a2 are 3 x in_dim^2 FMAs
// (52k at in_dim 132); the trajectory is 4 D bytes per point: bound by FP32
// arithmetic and shared-memory bandwidth, not by device memory.
//
// The replay kernel. Block (j, s) takes trajectory point j and the chain
// tiles s, s + S, ...: every point at once, NG = 4 groups of feature threads
// (640 threads at in_dim 132) on tiles of 32 chains, one block per SM
// (192 KiB of the 227 KiB of shared memory a block may use).
//
// The reroll kernel. Nothing is stored: a block owns chain tiles b, b + B,
// ... and walks each from z_0 through all K + 1 points, making z_{j+1} from
// the point's own score and net output exactly as the rollout kernel does
// (overdamped.cu: the same clips, the same operation order, the same Philox
// draw of (seed, chain, step) or the injected noise), so its gradient is the
// replay kernel's on the trajectory the rollout would have stored. The walk
// is sequential, so few chains leave SMs idle: with fewer 32-chain tiles
// than SMs it runs NG = 2 groups on tiles of 16 chains. Per-point sums (the
// betas, G1, GH1) leave the block after every point.
//  * At D = 10 a tile's TB x D floats of a state can outnumber the block's
//    threads (two groups of 64 at the funnel's in_dim 58): the per-chain
//    loads and the step to the next point are strided loops.
//  * f32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.

#include "cmcd_tile.cuh"

namespace {

using namespace cmcd;

constexpr int NG_REPLAY = 4;  // groups of feature threads of the replay kernel

struct VargradArgs {
  const float* traj;        // (K + 1, n, D)
  const float* cot;         // (n,)
  const float* betas;       // (K,)
  const float* scal;        // [eps0, factor_sn]
  NetArgs net;
  const float* vd_mean;     // (D,)
  const float* vd_logdiag;  // (D,)
  float* part_a;            // (blocks, len_a): summed over all blocks
  float* part_b;            // (K + 1, splits, len_b): summed over splits
  int n, nbridges, splits, eps_schedule;
  float clip_t, clip_q;
};

struct RerollArgs {
  const float* z0;          // (n, D)
  const float* cot;         // (n,)
  const float* betas;       // (K,)
  const float* noise;       // (K, n, D) or nullptr: in-kernel Philox
  const float* scal;        // [eps0, factor_sn]
  const long long* seed;    // one int64
  NetArgs net;
  const float* vd_mean;     // (D,)
  const float* vd_logdiag;  // (D,)
  float* part_a;            // (blocks, len_a)
  float* part_b;            // (K + 1, blocks, len_b)
  int n, nbridges, eps_schedule;
  float clip_t, clip_q;
};

// Shared memory of one block of NG groups at state dimension d with `gate`
// slots a warp (NET::gate_slots(d)): the tile and, per chain, z_j, z_{j-1},
// z_{j+1}, g_out (d-vectors) and the cotangent.
__host__ inline size_t smem_bytes(int ng, int in_dim, int n_par, int d, int gate = 0) {
  const int tb = ng * TC;
  return (tile_floats(ng, in_dim, n_par, d, gate) + 4 * tb * d + tb) * sizeof(float);
}

// What one block holds (NG = 4, the larger of the two forms).
__host__ inline bool fits(int in_dim, int n_par, int d, int gate = 0) {
  return in_dim >= 1 && round_up(in_dim, 32) <= FW_MAX && n_par >= 1 && n_par <= MAX_PAR &&
         smem_bytes(NG_REPLAY, in_dim, n_par, d, gate) <= MAX_SMEM;
}


// What every chain of a block shares at trajectory point j.
template <int D>
struct PointArgs {
  bool m_fk, m_bk;  // the point's forward term (j <= K - 1), backward term (j >= 1)
  float eps_j, eps_p, de_j, de_p, beta_j, beta_p, factor, clip_t, clip_q;
  float vm[D], viv[D], hb[D];
};

template <int D>
__device__ __forceinline__ PointArgs<D> make_point(int j, int K, int sched, const float* scal,
                                                   const float* betas, const float* vd_mean,
                                                   const float* vd_logdiag, const NetArgs& net,
                                                   float clip_t, float clip_q) {
  PointArgs<D> p;
  const float eps0 = scal[0];
  p.m_fk = j <= K - 1;
  p.m_bk = j >= 1;
  p.eps_j = p.m_fk ? eps_at(eps0, j, K, sched) : 1.f;
  p.eps_p = p.m_bk ? eps_at(eps0, j - 1, K, sched) : 1.f;
  p.de_j = eps_slope(j, K, sched);
  p.de_p = eps_slope(j - 1, K, sched);
  p.beta_j = p.m_fk ? betas[j] : 0.f;
  p.beta_p = p.m_bk ? betas[j - 1] : 0.f;
  p.factor = scal[1];
  p.clip_t = clip_t;
  p.clip_q = clip_q;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    p.vm[d] = vd_mean[d];
    p.viv[d] = expf(-2.0f * vd_logdiag[d]);
    p.hb[d] = net.headb[d];
  }
  return p;
}

// One chain at one point (lane 0 of the chain's warp): the scalar
// derivatives into this warp's sums sc (slots Slots<D>, a PIS net's gate
// sums after them), the head's cotangent into go. out: the head's raw
// output; gt: the score; zc, zp, zn: z_j, z_{j-1}, z_{j+1}; gate_row: the
// point's row of dds_grad's gate table, or null.
template <int D, class NET>
__device__ __forceinline__ void vargrad_chain(const PointArgs<D>& p, const float out[D],
                                              const float gt[D], const float* zc,
                                              const float* zp, const float* zn, float cn,
                                              float* go, float* sc, const float* gate_row) {
  using S = Slots<D>;
  float t_fk = 0.f, t_bk = 0.f, r2_fk = 0.f, r2_bk = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float z = zc[d];
    const float o = out[d] + p.hb[d], sn = net_out<NET>(o, p.factor, gate_row, d, gt[d]);
    const float gq = -(z - p.vm[d]) * p.viv[d];
    const float gtc = clip_f(gt[d], p.clip_t), gqc = clip_f(gq, p.clip_q);
    const float dj = p.beta_j * gtc + (1.0f - p.beta_j) * gqc;
    const float dp = p.beta_p * gtc + (1.0f - p.beta_p) * gqc;
    const float r_fk = p.m_fk ? zn[d] - ((z + p.eps_j * dj) - p.eps_j * sn) : 0.f;
    const float r_bk = p.m_bk ? zp[d] - ((z + p.eps_p * dp) + p.eps_p * sn) : 0.f;
    const float gsn = 0.5f * cn * (r_bk + r_fk);
    go[d] = net_out_cot<NET>(gsn, o, p.factor);
    if constexpr (!NET::PIS) sc[S::FACTOR] += gsn * o;
    sc[S::HEADB + d] += go[d];
    if (gate_row != nullptr) sc[S::GATE + d] += gsn * clip_f(gt[d], PIS_GATE_CLIP);
    const float diff = gtc - gqc;
    sc[S::BETA] += -0.5f * cn * r_fk * diff;
    sc[S::BETA + 1] += 0.5f * cn * r_bk * diff;
    if (gq == gqc) {  // not clipped
      const float g_gq = 0.5f * cn * (r_bk * (1.0f - p.beta_p) - r_fk * (1.0f - p.beta_j));
      sc[S::MEAN + d] += g_gq * p.viv[d];
      sc[S::LOGDIAG + d] += g_gq * (-2.0f * gq);
    }
    t_fk += r_fk * (dj - sn);
    t_bk += r_bk * (dp + sn);
    r2_fk += r_fk * r_fk;
    r2_bk += r_bk * r_bk;
  }
  if (p.m_fk) {
    const float is2 = 1.0f / (2.0f * p.eps_j);
    sc[S::EPS] -= cn * p.de_j * (t_fk * is2 + r2_fk * is2 * is2 - (float)D * is2);
  }
  if (p.m_bk) {
    const float is2 = 1.0f / (2.0f * p.eps_p);
    sc[S::EPS] += cn * p.de_p * (t_bk * is2 + r2_bk * is2 * is2 - (float)D * is2);
  }
}

template <class T, class NET>
__global__ void __launch_bounds__(NG_REPLAY* FW_MAX) vargrad_replay(const VargradArgs a) {
  constexpr int NG = NG_REPLAY, TB = NG * TC, D = T::D;
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges;
  const Tile<NG, D, NET> t(reinterpret_cast<float*>(smem4), net);
  const T target(t.par, net.n_par, net.inv_var_t);
  float* zc_s = t.rest;            // TB x D: z_j
  float* zp_s = zc_s + TB * D;     // TB x D: z_{j-1}
  float* zn_s = zp_s + TB * D;     // TB x D: z_{j+1}
  float* go_s = zn_s + TB * D;     // TB x D: g_out
  float* cot_s = go_s + TB * D;    // TB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const int nthr = blockDim.x;
  const int j = blockIdx.x / a.splits, split = blockIdx.x - j * a.splits;
  const FeatThread<D, D> th(net, NG);
  const PointArgs<D> p = make_point<D>(j, K, a.eps_schedule, a.scal, a.betas, a.vd_mean,
                                       a.vd_logdiag, net, a.clip_t, a.clip_q);
  tile_init(t, net);
  // Sums of this block. Per feature thread, in registers: ft. Per warp, in
  // shared memory and touched by lane 0 only: the t.NS scalars.
  float ft[nfeat(D, D)];
#pragma unroll
  for (int q = 0; q < nfeat(D, D); ++q) ft[q] = 0.f;
  float* sc = t.sc_s + warp * t.NS;
  const int row = NET::row(j, K);
  const float* gate_row = NET::PIS && net.gate != nullptr ? net.gate + (size_t)row * D : nullptr;
  __syncthreads();

  const int ntiles = (a.n + TB - 1) / TB;
  for (int tile = split; tile < ntiles; tile += a.splits) {
    const int base = tile * TB;
    for (int i = tid; i < TB * D; i += nthr) {
      const int chain = base + i / D, d = i - (i / D) * D;
      const bool live = chain < a.n;
      zc_s[i] = live ? a.traj[((size_t)j * a.n + chain) * D + d] : 0.f;
      zp_s[i] = live && p.m_bk ? a.traj[((size_t)(j - 1) * a.n + chain) * D + d] : 0.f;
      zn_s[i] = live && p.m_fk ? a.traj[((size_t)(j + 1) * a.n + chain) * D + d] : 0.f;
    }
    if (tid < TB) cot_s[tid] = base + tid < a.n ? a.cot[base + tid] : 0.f;
    __syncthreads();

    FeatRegs r;
    tile_layers(t, net, th, row, zc_s, r);

    // Head, score and the scalar derivatives: one warp per chain.
    for (int c = warp; c < TB; c += nwarp) {
      float out[D], gt[D];
      head_raw<D>(net, t.xs + c * ip, t.hws, out);
      target.score(zc_s + c * D, gt);
      if (lane == 0)
        vargrad_chain<D, NET>(p, out, gt, zc_s + c * D, zp_s + c * D, zn_s + c * D, cot_s[c],
                              go_s + c * D, sc, gate_row);
    }
    __syncthreads();

    tile_vjp(t, net, th, zc_s, go_s, r, ft, nullptr);
  }

  flush_block(t, net, th, ft, a.part_a + (size_t)blockIdx.x * len_a(in, D, D));
  flush_point(t, net, th, ft, a.part_b + (size_t)blockIdx.x * len_b(in, t.G), false);
}

template <int NG, class T, class NET>
__global__ void __launch_bounds__(NG* FW_MAX) vargrad_reroll(const RerollArgs a) {
  constexpr int TB = NG * TC, D = T::D;
  extern __shared__ float4 smem4[];
  const NetArgs& net = a.net;
  const int ip = net.in_pad, in = net.in_dim, K = a.nbridges;
  const Tile<NG, D, NET> t(reinterpret_cast<float*>(smem4), net);
  const T target(t.par, net.n_par, net.inv_var_t);
  float* zc_s = t.rest;            // TB x D: z_j
  float* zp_s = zc_s + TB * D;     // TB x D: z_{j-1}
  float* zn_s = zp_s + TB * D;     // TB x D: z_{j+1}, made here
  float* go_s = zn_s + TB * D;     // TB x D: g_out
  float* cot_s = go_s + TB * D;    // TB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const int nthr = blockDim.x;
  const FeatThread<D, D> th(net, NG);
  const unsigned long long seed = (unsigned long long)a.seed[0];
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
      const int chain = base + i / D;
      zc_s[i] = chain < a.n ? a.z0[(size_t)base * D + i] : 0.f;
      zp_s[i] = 0.f;
      zn_s[i] = 0.f;
    }
    if (tid < TB) cot_s[tid] = base + tid < a.n ? a.cot[base + tid] : 0.f;
    __syncthreads();

    for (int j = 0; j <= K; ++j) {
      const PointArgs<D> p = make_point<D>(j, K, a.eps_schedule, a.scal, a.betas, a.vd_mean,
                                           a.vd_logdiag, net, a.clip_t, a.clip_q);
      const int row = NET::row(j, K);
      const float* gate_row =
          NET::PIS && net.gate != nullptr ? net.gate + (size_t)row * D : nullptr;
      FeatRegs r;
      tile_layers(t, net, th, row, zc_s, r);

      for (int c = warp; c < TB; c += nwarp) {
        float out[D], gt[D];
        head_raw<D>(net, t.xs + c * ip, t.hws, out);
        target.score(zc_s + c * D, gt);
        if (lane == 0) {
          const int chain = base + c;
          if (p.m_fk) {  // the rollout's step, operation for operation
            float xi[D];
            if (a.noise != nullptr) {
#pragma unroll
              for (int d = 0; d < D; ++d)
                xi[d] = chain < a.n ? a.noise[((size_t)j * a.n + chain) * D + d] : 0.f;
            } else {
              philox_normals<D>(seed, (uint32_t)chain, (uint32_t)j, xi);
            }
            const float scale = sqrtf(2.0f * p.eps_j);
#pragma unroll
            for (int d = 0; d < D; ++d) {
              const float z = zc_s[c * D + d];
              const float sn = net_out<NET>(out[d] + p.hb[d], p.factor, gate_row, d, gt[d]);
              const float gq = -(z - p.vm[d]) * p.viv[d];
              const float gu = -(p.beta_j * clip_f(gt[d], p.clip_t) +
                                 (1.0f - p.beta_j) * clip_f(gq, p.clip_q));
              const float fk = (z - p.eps_j * gu) - p.eps_j * sn;
              zn_s[c * D + d] = fk + scale * xi[d];
            }
          }
          vargrad_chain<D, NET>(p, out, gt, zc_s + c * D, zp_s + c * D, zn_s + c * D,
                                cot_s[c], go_s + c * D, sc, gate_row);
        }
      }
      __syncthreads();

      tile_vjp(t, net, th, zc_s, go_s, r, ft, nullptr);
      for (int i = tid; i < TB * D; i += nthr) {  // the next point
        zp_s[i] = zc_s[i];
        zc_s[i] = zn_s[i];
      }
      flush_point(t, net, th, ft,
                  a.part_b + ((size_t)j * gridDim.x + blockIdx.x) * len_b(in, t.G),
                  tile != (int)blockIdx.x);
    }
  }

  flush_block(t, net, th, ft, a.part_a + (size_t)blockIdx.x * len_a(in, D, D));
}

template <class T, class NET>
cudaError_t launch_replay(const VargradArgs& a, cudaStream_t stream) {
  const size_t smem =
      smem_bytes(NG_REPLAY, a.net.in_dim, a.net.n_par, T::D, NET::gate_slots(T::D));
  cudaError_t err = cudaFuncSetAttribute(vargrad_replay<T, NET>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (a.nbridges + 1) * a.splits;
  vargrad_replay<T, NET><<<blocks, NG_REPLAY * round_up(a.net.in_dim, 32), smem, stream>>>(a);
  return cudaGetLastError();
}

template <int NG, class T, class NET>
cudaError_t launch_reroll(const RerollArgs& a, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(NG, a.net.in_dim, a.net.n_par, T::D, NET::gate_slots(T::D));
  cudaError_t err = cudaFuncSetAttribute(vargrad_reroll<NG, T, NET>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  vargrad_reroll<NG, T, NET><<<blocks, NG * round_up(a.net.in_dim, 32), smem, stream>>>(a);
  return cudaGetLastError();
}

template <class T, class NET>
cudaError_t launch_reroll_groups(const RerollArgs& a, int blocks, int groups, cudaStream_t s) {
  return groups == 2 ? launch_reroll<2, T, NET>(a, blocks, s)
                     : launch_reroll<4, T, NET>(a, blocks, s);
}

}  // namespace

extern "C" {

// Launches the replay backward and its reduction on `stream`. part_a:
// (points x splits, len_a) and part_b: (points, splits, len_b) are scratch;
// out_a: (len_a,) and out_b: (points, len_b) receive the sums. target as in
// cmcd_overdamped_rollout (overdamped.cu): 0 many_gmm, 1 the 3-mode gmm (2-D),
// 2 the funnel, 3 the standard normal (10-D), tpar its n_par constants; arch
// and gate as there (a PIS net's len_b holds D gate sums more). Returns a
// cudaError_t.
int cmcd_vargrad_replay(const float* traj, const float* cot, const float* betas,
                        const float* scal, const float* w1z, const float* c1,
                        const float* emb, const float* w2, const float* b2,
                        const float* headw, const float* headb, const float* tpar,
                        const float* vd_mean, const float* vd_logdiag, float* part_a,
                        float* part_b, float* out_a, float* out_b, int n, int nbridges,
                        int in_dim, int emb_dim, int n_par, int eps_schedule, int splits,
                        int target, float inv_var_t, float clip_t, float clip_q, int arch,
                        const float* gate, void* stream) {
  if (n <= 0 || nbridges <= 0 || splits <= 0 || !target_ok(target, n_par))
    return (int)cudaErrorInvalidValue;
  const int d = target_dim(target), gs = arch == 1 ? d : 0;  // gate slots
  if (!net_ok(arch, in_dim, emb_dim, d, gate) || !fits(in_dim, n_par, d, gs))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, tpar,
                    in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t, gate};
  const VargradArgs a{traj, cot, betas, scal, net, vd_mean, vd_logdiag, part_a, part_b,
                      n, nbridges, splits, eps_schedule, clip_t, clip_q};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_target(target, [&](auto tag) {
    return dispatch_net(arch, [&](auto net_tag) {
      return launch_replay<typename decltype(tag)::type, typename decltype(net_tag)::type>(a, s);
    });
  });
  if (err != cudaSuccess) return (int)err;
  const int points = nbridges + 1;
  return (int)launch_reduce(part_a, part_b, out_a, out_b, points * splits, points, splits,
                            in_dim, d, d, s, gs);
}

// Launches the re-rolling backward and its reduction on `stream`: `blocks`
// blocks of `groups` (2 or 4) groups of feature threads, blocks <= the
// number of chain tiles of 8 x groups chains. noise may be null (Philox from
// seed). part_a: (blocks, len_a) and part_b: (points, blocks, len_b) are
// scratch; out_a and out_b as above; target, tpar, arch and gate as above.
// Returns a cudaError_t.
int cmcd_vargrad_reroll(const float* z0, const float* cot, const float* betas,
                        const float* noise, const float* scal, const long long* seed,
                        const float* w1z, const float* c1, const float* emb, const float* w2,
                        const float* b2, const float* headw, const float* headb,
                        const float* tpar, const float* vd_mean, const float* vd_logdiag,
                        float* part_a, float* part_b, float* out_a, float* out_b, int n,
                        int nbridges, int in_dim, int emb_dim, int n_par, int eps_schedule,
                        int blocks, int groups, int target, float inv_var_t, float clip_t,
                        float clip_q, int arch, const float* gate, void* stream) {
  if (n <= 0 || nbridges <= 0 || (groups != 2 && groups != 4)) return (int)cudaErrorInvalidValue;
  if (blocks <= 0 || blocks > (n + groups * TC - 1) / (groups * TC) || !target_ok(target, n_par))
    return (int)cudaErrorInvalidValue;
  const int d = target_dim(target), gs = arch == 1 ? d : 0;  // gate slots
  if (!net_ok(arch, in_dim, emb_dim, d, gate) || !fits(in_dim, n_par, d, gs))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, tpar,
                    in_dim, round_up(in_dim, 4), emb_dim, n_par, inv_var_t, gate};
  const RerollArgs a{z0, cot, betas, noise, scal, seed, net, vd_mean, vd_logdiag, part_a,
                     part_b, n, nbridges, eps_schedule, clip_t, clip_q};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_target(target, [&](auto tag) {
    return dispatch_net(arch, [&](auto net_tag) {
      return launch_reroll_groups<typename decltype(tag)::type,
                                  typename decltype(net_tag)::type>(a, blocks, groups, s);
    });
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(part_a, part_b, out_a, out_b, blocks, nbridges + 1, blocks, in_dim,
                            d, d, s, gs);
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_vargrad_chains_per_group() { return TC; }

// The launch's own limits and buffer lengths at state dimension d with
// `gate` slots a warp (0 geffner, d PIS), for the wrapper to check its copy
// against.
int cmcd_vargrad_fits(int in_dim, int n_par, int d, int gate) {
  return fits(in_dim, n_par, d, gate) ? 1 : 0;
}

long long cmcd_vargrad_smem_bytes(int groups, int in_dim, int n_par, int d, int gate) {
  return (long long)smem_bytes(groups, in_dim, n_par, d, gate);
}

int cmcd_vargrad_len_a(int in_dim, int d) { return len_a(in_dim, d, d); }

int cmcd_vargrad_len_b(int in_dim, int gate) { return len_b(in_dim, gate); }

}  // extern "C"
