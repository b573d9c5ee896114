// The KL reverse sweep (B3) on the Bayesian logistic regressions, for NVIDIA
// Hopper (sm_90a): australian (D = 15), ionosphere (D = 35) and sonar
// (D = 61).
//
// Replaces cmcd_tpu/ops/pallas_kl.py::evolve_kl_bwd_pallas (the TPU kernel
// "B3") with the logistic regression score and its Hessian product inlined
// (cmcd_tpu/ops/target_grads.py::make_logreg_grad_t; the TPU kernel traces
// the product with jax.vjp), in the carry form the posterior protocol
// MCD_CAIS_sn trains with: kl_reverse_sweep<NG, LogregTarget<D, R>, true,
// GeffnerNet> at both group counts (NG = 2 on tiles of 16 chains, 4 on 32;
// ops/vargrad.sweep_grid). The kernel is the carry form of kl.cu
// (kl_sweep.cuh; kl.cu's header has the derivation and the design); this
// source instantiates it for the three targets only, so that their compile
// runs beside kl.cu's. The Python wrapper is the same as kl.cu's
// (cmcd_tpu_torch/ops/kl.py::evolve_kl_bwd, which picks this library for a
// logistic regression).
//
// Per point and chain the sweep forms the score at z_p (keeping s_i =
// sigmoid(l_i) sigmoid(-l_i) of each lane's data rows, cmcd_common.cuh:
// LogregTarget) and one Hessian product with the summed cotangent of the
// two steps that meet there: 4 n_data D FMAs (n_data 690, 351, 208), beside
// the net's apply and VJP, 3 in_dim^2 (in_dim 35, 55, 81 at emb 20).
// The design choices the target forces:
//  * The dataset (41-51 KB) stays in device memory and is read in place
//    through L1 (read-only loads, feature-major so a warp's load is 32
//    neighbouring floats). In shared memory it would not fit: at D = 61 the
//    tile of four groups and its per-chain buffers already take 220 KB of
//    the 227 KB a block may have (ops/kl.kernel_fits counts them).
//  * The product re-forms X u from the data instead of keeping each row's
//    x_i . w or the point's D-vector per lane (Lanes: R floats, the s_i).
//  * Per-thread arrays sized by D (the chain's scalars and cotangents in the
//    per-warp loop, a feature thread's head column and D-wide sums) spill
//    at D = 35 and 61; the instances' registers and spill are in PERF.md.
// f32 throughout, no tensor cores.

#include "kl_sweep.cuh"

extern "C" {

// Launches the reverse sweep and its reduction on `stream`:
// cmcd_kl_reverse_sweep of kl.cu (the same arguments) for the carry form
// (cais 1) with the geffner net (arch 0, no gate) on a logistic regression
// (target 6 australian, 7 ionosphere, 8 sonar; tpar its prior precision, 1;
// tdata its dataset, X^T (D x n_data) then y, n_data its rows). Any other
// form, net or target returns cudaErrorInvalidValue.
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
  if (cais != 1 || arch != 0 || target < 6 || target > 8 || !target_ok(target, n_par) ||
      !logreg_ok(target, tdata, n_data))
    return (int)cudaErrorInvalidValue;
  const int d = target_dim(target);
  if (!net_ok(arch, in_dim, emb_dim, d, gate) || !fits(in_dim, n_par, d))
    return (int)cudaErrorInvalidValue;
  const NetArgs net{w1z, c1, emb, w2, b2, headw, headb, tpar, in_dim, round_up(in_dim, 4),
                    emb_dim, n_par, inv_var_t, gate, tdata, n_data};
  const KlArgs a{traj, noise, cot, g_zfinal, betas, scal, net, vd_mean, vd_logdiag,
                 part_a, part_b, g_z0, n, nbridges, eps_schedule, clip_t, clip_q};
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = dispatch_logreg(target, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return groups == 2 ? launch_sweep<2, T, true, GeffnerNet>(a, blocks, s)
                       : launch_sweep<4, T, true, GeffnerNet>(a, blocks, s);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_reduce(part_a, part_b, out_a, out_b, blocks, nbridges + 1, blocks, in_dim,
                            d, d, s);
}

const char* cmcd_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int cmcd_kl_chains_per_group() { return TC; }

// The launch's own limits and buffer lengths, as kl.cu's (the wrapper checks
// its copy against both libraries).
int cmcd_kl_fits(int in_dim, int n_par, int d, int gate) {
  return fits(in_dim, n_par, d, gate) ? 1 : 0;
}

long long cmcd_kl_smem_bytes(int groups, int in_dim, int n_par, int d, int gate) {
  return (long long)smem_bytes(groups, in_dim, n_par, d, gate);
}

int cmcd_kl_len_a(int in_dim, int d) { return len_a(in_dim, d, d); }

int cmcd_kl_len_b(int in_dim, int gate) { return len_b(in_dim, gate); }

}  // extern "C"
