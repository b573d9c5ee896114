// The fused overdamped rollout (B1) on the Bayesian logistic regressions,
// for NVIDIA Hopper (sm_90a): australian (D = 15), ionosphere (D = 35) and
// sonar (D = 61).
//
// Replaces cmcd_tpu/ops/pallas_overdamped.py::evolve_overdamped_pallas (the
// TPU kernel "B1") with the logistic regression score inlined
// (cmcd_tpu/ops/target_grads.py::make_logreg_grad_t), in the form the
// posterior protocol MCD_CAIS_sn runs: overdamped_rollout<LogregTarget<D, R>,
// GeffnerNet, true, 1>, the geffner net in both kernels and the backward net
// at i + 1, with and without the stored trajectory and noise. The kernel is
// the tile form of overdamped.cu (overdamped_rollout.cuh; its header states
// the step and the design); this source instantiates it for the three
// targets only, so that their compile runs beside overdamped.cu's, not
// after it. The Python wrapper is the same as overdamped.cu's
// (cmcd_tpu_torch/ops/overdamped.py::evolve_overdamped_fused, which picks
// this library for a logistic regression, ops/overdamped.source_for).
//
// What differs from the other targets is the score (cmcd_common.cuh,
// LogregTarget): it reads the dataset, 41-51 KB, which does not fit the
// 128 floats of constants a block copies into shared memory. The design:
//  * The dataset stays in device memory, laid out feature-major (X^T, then
//    y), and is read in place with read-only loads: after a block's first
//    score it sits in the SM's L1 cache (the tile takes 22-60 KB of shared
//    memory here, so L1 keeps well over 100 KB). Staging it in shared memory
//    would cost each block 41-51 KB and would not fit the KL sweep's tile at
//    D = 61 (kl_logreg.cu), which reads it the same way.
//  * One warp per chain, as for every target: the lanes take the data rows,
//    32 neighbouring floats of one feature a load, and D warp reductions
//    close the score's D sums.
//  * Work per chain-step: 2 n_data D FMAs for the score (n_data 690, 351,
//    208) beside the net's in_dim^2 (in_dim = D + emb_dim: 35, 55, 81 at
//    emb 20). At the protocol's N = 300 that is 38 blocks of 8 chains, fewer
//    than the card's 132 SMs: the kernel is latency-bound along the K steps.
//  * Per-thread arrays sized by D (the head's and the score's D sums, the
//    chain's state) spill at D = 61; ptxas's registers and spill per
//    instance are in PERF.md. f32 throughout, no tensor cores.
//
// cmcd_logreg_probe runs the same device functions (LogregTarget::score
// and ::hvp) at given points, for the card's check against float64.

#include "overdamped_rollout.cuh"

namespace {

using namespace cmcd;

// One warp per point: the score of T at z (n x D) into gt and its Hessian
// product with u into hv.
template <class T>
__global__ void __launch_bounds__(256) logreg_probe(const float* z, const float* u,
                                                    const float* tpar, const float* data,
                                                    int n_data, int n, float* gt, float* hv) {
  constexpr int D = T::D;
  __shared__ float par_s[4];
  if (threadIdx.x == 0) par_s[0] = tpar[0];
  __syncthreads();
  const int point = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (point >= n) return;  // a whole warp: no barrier follows
  const T target(par_s, data, n_data);
  typename T::Lanes sl;
  float g[D], uu[D], h[D];
#pragma unroll
  for (int d = 0; d < D; ++d) uu[d] = u[(size_t)point * D + d];
  target.score(z + (size_t)point * D, g, &sl);
  target.hvp(sl, uu, h);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      gt[(size_t)point * D + d] = g[d];
      hv[(size_t)point * D + d] = h[d];
    }
  }
}

}  // namespace

extern "C" {

// Launches the rollout on `stream`: cmcd_overdamped_rollout of overdamped.cu
// (the same arguments) for the CAIS form (form 0) with the geffner net (arch
// 0, no gate) on a logistic regression (target 6 australian, 7 ionosphere, 8
// sonar; tpar its prior precision, 1; tdata its dataset, X^T (D x n_data)
// then y, n_data its rows); the second net's pointers are not read. Any
// other form, net or target returns cudaErrorInvalidValue.
int cmcd_overdamped_rollout(const float* z0, const float* w0, const float* betas,
                            const float* noise, const float* scal, const long long* seed,
                            const float* w1z, const float* c1, const float* emb,
                            const float* w2, const float* b2, const float* headw,
                            const float* headb, const float* tpar, const float* vd_mean,
                            const float* vd_inv_var, float* z_out, float* w_out, float* traj,
                            float* noise_out, int n, int nbridges, int in_dim, int emb_dim,
                            int n_par, int eps_schedule, int form, int target, float inv_var_t,
                            float clip_t, float clip_q, int arch, const float* gate,
                            const float*, const float*, const float*, const float*,
                            const float*, const float*, const float*, const float* tdata,
                            int n_data, void* stream) {
  if (n <= 0 || nbridges <= 0) return (int)cudaSuccess;
  if (form != 0 || arch != 0 || target < 6 || target > 8 || !target_ok(target, n_par) ||
      !logreg_ok(target, tdata, n_data))
    return (int)cudaErrorInvalidValue;
  const int d = target_dim(target);
  if (!net_ok(arch, in_dim, emb_dim, d, gate) || !fits(in_dim, n_par, d))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, tpar, in_dim, round_up(in_dim, 4),
                    emb_dim, n_par, inv_var_t, gate, tdata, n_data};
  const RolloutArgs a{z0, w0, betas, noise, scal, seed, net, NetArgs{}, vd_mean, vd_inv_var,
                      z_out, w_out, traj, noise_out, n, nbridges, eps_schedule, clip_t, clip_q};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch_logreg(target, [&](auto tag) {
    return launch_tile<typename decltype(tag)::type, GeffnerNet, true, 1>(a, s);
  });
}

// The score and its Hessian product of target 6-8 at n points z (n x D),
// with u (n x D), into gt and hv (n x D each), on `stream`.
int cmcd_logreg_probe(const float* z, const float* u, const float* tpar, const float* tdata,
                      int n_data, int n, int target, float* gt, float* hv, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (target < 6 || target > 8 || !logreg_ok(target, tdata, n_data))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch_logreg(target, [&](auto tag) {
    using T = typename decltype(tag)::type;
    logreg_probe<T><<<(n + 7) / 8, 256, 0, s>>>(z, u, tpar, tdata, n_data, n, gt, hv);
    return cudaGetLastError();
  });
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_overdamped_chains_per_block() { return TC; }

// The launch's own limits, as overdamped.cu's (the wrapper checks its copy
// against both libraries).
int cmcd_overdamped_fits(int in_dim, int n_par, int d, int nets) {
  return fits(in_dim, n_par, d, nets) ? 1 : 0;
}

long long cmcd_overdamped_smem_bytes(int in_dim, int n_par, int d, int nets) {
  return (long long)smem_bytes(in_dim, n_par, d, nets);
}

}  // extern "C"
