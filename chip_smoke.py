#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cmcd_tpu_torch) once on one NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases 1,2,3

Phases, one line each; any failure exits non-zero:
  1. device: needs CUDA (no CPU run); prints the card's name and power limit.
  2. build: compiles csrc/overdamped.cu, csrc/vargrad.cu, csrc/kl.cu,
     csrc/underdamped.cu, csrc/kl_underdamped.cu, csrc/uha.cu,
     csrc/kl_uha.cu, csrc/overdamped_wide.cu, csrc/kl_split.cu,
     csrc/overdamped_logreg.cu and csrc/kl_logreg.cu with nvcc for sm_90a,
     all at once (ptxas report per kernel: every target instance, the D = 10
     ones of the funnel and the standard normal, the LGCP's wide forms and
     the logistic regressions' instances included).
  3. kernels vs their plain versions. The rollout under injected noise, at
     the CPU tests' size and at full width (K=256, emb_dim 130, grad clipping,
     factor_sn 0.3, random embedding) for N=2000 and for the evaluation's
     N=500, whose last block holds 4 live and 4 idle chains, with and without
     the stored trajectory, under both specs (CAIS_VAR; CAIS, the KL path's). The VarGrad replay backward from the same
     trajectory and a random cotangent, at the test size and at full width
     for N=2000 and N=1001 (both leave a partial last chain tile). Then one
     whole training step, var_bound_fused through the kernels against the
     same call through the plain versions: loss and every gradient leaf.
     The rollout's noise stack (its Philox draws, injected again, give the
     same z and w bit for bit). The KL reverse sweep against its plain
     version, every gradient leaf and dL/dz0, at the test size (K=6, N=128,
     emb 16; three schedules, with and without clipping) and at full width
     for N=2000, N=1001 and N=6000 (four groups of feature threads, several
     tiles per block); where a leaf misses the float32 limit the plain
     version in float64 arbitrates (the kernel may be at most 4 times as far
     from it as the float32 plain version is). The re-rolling VarGrad
     backward against its plain version under injected noise, and from a
     seed against the replay kernel on the trajectory the rollout stored
     from that seed, also at N=REROLL_N. One whole KL training step,
     kl_bound_fused through the kernels against the plain versions. Fails
     above the stated tolerances.
  4. evaluation path: cmcd_tpu_torch.main.run_experiment with the flagship
     flags (many_gmm, MCD_CAIS_var_sn, K=256, emb_dim 130, iters 0) and the
     30 x 500 evaluation; the rollout must be launched 30 times, ELBO and
     ln Z finite.
  5. statistics: the same evaluation with the kernel's Philox noise and with
     the plain version's torch.randn noise agree within 4 combined standard
     errors in ELBO and ln Z.
  6. timing of the evaluation: kernel and plain version for one K=256 rollout
     at N=500 and N=2000 (CUDA events) and for one 30 x 500 evaluation (host
     clock around synchronize), in the order plain, kernel, kernel, plain;
     then the kernel evaluation's device time under torch.profiler.
  7. training path: run_experiment with the flagship flags and TRAIN_ITERS
     optimizer steps at N=2000, then the 30 x 500 evaluation. The rollout must
     be launched TRAIN_ITERS + 30 times and the backward TRAIN_ITERS times, no
     logged loss may be NaN, the run must not diverge, and the mean of the
     last 100 per-step losses must lie below half the mean of the first 100.
     ELBO and ln Z before (phase 4) and after training are printed, not gated.
  8. timing of training at N=2000, K=256, in the order plain, kernel, kernel,
     plain: the rollout with and without the trajectory store and the replay
     backward (CUDA events), one optimizer step through the kernels over 50
     steps against the eager step (host clock around synchronize), and one
     fused step's device time by kernel under torch.profiler.
  9. KL training path: run_experiment with the many_gmm_kl flags
     (MCD_CAIS_sn, init_eps 0.1) and TRAIN_ITERS steps at N=2000, then the
     30 x 500 evaluation. The rollout must be launched TRAIN_ITERS + 30 times
     and the reverse sweep TRAIN_ITERS times, no logged loss may be NaN, the
     run must not diverge, and the ELBO after training must lie above the
     ELBO of the same evaluation at the initial parameters.
 10. reroll path: run_experiment with the flagship VarGrad flags at
     N=REROLL_N, where the stored trajectory would pass the byte budget and
     "auto" takes the re-rolling backward, for REROLL_ITERS steps: the reroll
     kernel must be launched once per step and the replay kernel never.
 11. timing at N=2000, K=256, in the order plain, kernel, kernel, plain: the
     KL reverse sweep and the re-rolling backward (CUDA events), the rollout
     and the re-rolling backward at N=REROLL_N, and one KL optimizer step
     through the kernels over 50 steps against the eager step.
 12. the underdamped kernels against their plain versions. The underdamped
     rollout under injected noise ((K + 1, N, 2): the initial momentum, then
     one refresh draw per step) for all seven specs at the test size and for
     LDVI (MCD_U_a-lp-sn) at full width (K=256, emb_dim 130: in_dim 134) for
     N=2000 and N=500: z, w and both stored paths, with and without the
     stores; its noise stack, injected again, gives the same bits. The
     underdamped KL sweep for the three approximate-refresh specs at the test
     size and for LDVI at full width (float64 arbiter where a leaf misses
     the limit), and one whole LDVI KL training step through the kernels
     against the plain versions.
 13. LDVI evaluation path: run_experiment with the LDVI flags (iters 0) and
     the 30 x 500 evaluation: the underdamped rollout launched 30 times,
     ELBO and ln Z finite.
 14. LDVI KL training path: run_experiment with the LDVI flags and
     TRAIN_ITERS steps at N=2000, then the evaluation: the underdamped rollout
     launched TRAIN_ITERS + 30 times, its sweep TRAIN_ITERS times and no
     overdamped kernel at all; no NaN loss, no divergence, the ELBO after
     training above phase 13's.
 15. timing of the LDVI path at N=2000, K=256, in the order plain, kernel,
     kernel, plain: the underdamped rollout with and without its stores (and
     at the evaluation's N=500) and the sweep (CUDA events), and one LDVI
     optimizer step through the kernels over 50 steps against the eager
     step, with its device busy share under torch.profiler.
 16. the UHA kernels against their plain versions. The UHA rollout under
     injected noise ((K + 1, N, 2): the initial momentum's base draw, then one
     refresh draw per bridge) on many_gmm and the 3-mode gmm with lfsteps 1
     and 3 at the test size (N=256, K=8) and on many_gmm at full width (K=256)
     for N=2000 and N=500: z, w and both stored paths, with and without the
     stores; its noise stack, injected again, gives the same bits. The UHA
     sweep at the same sizes (float64 arbiter at full width where a leaf
     misses the limit), and one whole UHA KL training step through the
     kernels against the plain versions.
 17. UHA evaluation path: run_experiment with the UHA flags (iters 0) and the
     30 x 500 evaluation: the UHA rollout launched 30 times, ELBO and ln Z
     finite; the same flags with lfsteps past the kernels' limit raise
     NotImplementedError and launch nothing.
 18. UHA KL training path: run_experiment with the UHA flags and TRAIN_ITERS
     steps at N=2000, then the evaluation: the UHA rollout launched
     TRAIN_ITERS + 30 times, its sweep TRAIN_ITERS times and no other kernel;
     no NaN loss, no divergence, the ELBO after training above phase 17's.
 19. timing of the UHA path at N=2000, K=256, in the order plain, kernel,
     kernel, plain: the UHA rollout with and without its stores (and at the
     evaluation's N=500) and the sweep (CUDA events), and one UHA optimizer
     step through the kernels over 50 steps against the eager step, with its
     device busy share under torch.profiler.
 20. the overdamped kernels' forms of the 3-mode gmm, ULA_sn and plain ULA
     against their plain versions. The rollout under injected noise at the
     test size (N=256, K=8, emb 16) for CAIS, CAIS_VAR, ULA and ULA_sn on
     many_gmm and gmm, each with its noise stack injected again (the same
     bits); the KL sweep for CAIS, ULA and ULA_sn on both targets at N=128,
     K=6 (three schedules; float64 reported, and the arbiter of the eps
     leaf of gmm under cos_sq only, whose terms cancel); the VarGrad replay and
     re-rolling backward on
     gmm; at full width ULA and ULA_sn on many_gmm (N=2000 and 500, K=256,
     emb 130 for ULA_sn) and the gmm CAIS recipes' shapes (N=300 and 500,
     K=256, cos_sq, emb 20; N=300, K=8), the sweeps with the float64 arbiter;
     one whole KL step with the variational draw trained for the gmm_cais,
     gmm_cais_tuned and gmm_ula flags and for ULA_sn on many_gmm.
 21. the paths of those forms through the CLI, each form's launches counted
     from 0 just before its run and no other kernel launched: gmm_cais's and
     gmm_ula's flags for OD_PATH_ITERS steps (rollout OD_PATH_ITERS + 30,
     sweep OD_PATH_ITERS; ELBO above its value at init), ULA_sn and ULA on
     many_gmm at N=2000, K=256 for OD_WIDE_ITERS steps, the VarGrad loss on
     gmm (replay at N=300; the re-rolling backward at N=REROLL_N, K=256),
     each followed by the 30 x 500 evaluation; no NaN loss, no divergence.
 22. timing (CUDA events, in the order plain, kernel, kernel, plain) of the
     new forms at N=2000, K=256 on many_gmm and at the gmm recipes' shapes,
     each beside its bound (_work_od) and the kernel's device time per
     launch under torch.profiler, and the gmm_cais, gmm_ula and ULA_sn
     optimizer steps over 50 steps against the eager step (the gmm steps
     also over 500 steps, and train()'s set-up alone).
 23. the D = 10 forms against their plain versions, on Neal's funnel and the
     standard normal: the kernels' score and Hessian product through the
     net-free forms at points with v from -20 to 8 (float64 reported, limit
     1e-5 of the row's scale); at funnel_k8's shape (N=300, K=8, emb 48,
     cos_sq) and at a stress shape (N=2000, K=256, init_eps 0.01) the
     rollout of CAIS, CAIS_VAR, ULA_sn and ULA (TOL_SMALL at K=8, TOL_FULL at
     K=256; the noise stack at funnel_k8's shape), the KL sweep of CAIS,
     ULA_sn and ULA (GRAD_TOL_FULL with the float64 arbiter), the VarGrad
     replay and re-rolling backward (and the reroll from a seed against the
     replay kernel); at four groups of feature threads (N past 32 chains a
     tile times the card's SMs, more tiles than blocks) the KL sweep's carry
     and per-point forms and the re-rolling backward at N=8192, K=8, and the
     funnel's re-rolling path's own shape (N=REROLL_N, K=256, init_eps 0.01:
     the rollout and the reroll against the plain versions in slices of
     PLAIN_CHUNK chains, and the reroll from a seed against the replay
     kernel, with the replay's plain version in float64 the arbiter of a
     leaf beyond the limit); CAIS with clipping; one whole funnel_k8 step with the
     variational draw trained.
 24. the D = 10 paths through the CLI, each form's launches counted from 0
     just before its run and no other kernel launched: funnel_k8's flags for
     FUNNEL_PATH_ITERS steps (rollout FUNNEL_PATH_ITERS + 30, sweep
     FUNNEL_PATH_ITERS; ELBO above its value at init), ULA_sn and ULA with
     the same flags and the VarGrad loss (replay) for FUNNEL_SHORT_ITERS, the
     re-rolling backward at N=REROLL_N, K=256 for REROLL_ITERS steps, each
     followed by the 30 x 2000 evaluation; no NaN loss, no divergence.
 25. timing (CUDA events, plain, kernel, kernel, plain) of the D = 10 forms
     on the funnel at funnel_k8's shape and the stress shape, each beside its
     bound (_work_od at dim 10) and its device time per launch under
     torch.profiler; funnel_k8's optimizer step over 50 and 200 steps
     against the eager step, with its device busy share.
 26. the underdamped family's new forms against their plain versions: the
     underdamped rollout and KL sweep of all seven specs on gmm and the
     funnel at the test size (N=256 / 128, K=8 / 6, emb 16; the sweeps with
     the float64 arbiter); at each new path's shapes (UD_NEW_SHAPES: the
     exact and exact_fwd modes on many_gmm at N=2000, K=256, emb 130; LDVI
     on gmm at N=300, K=8 and N=2000, K=256, emb 20; CAIS_UHA on the funnel
     at N=300, K=32, emb 48 and N=2000, K=256) rollout and sweep; CAIS_UHA
     with its target score clip engaged (init_sigma 3; the count of clipped
     elements must be above 0) and its noise stack; the sweep at four groups
     (N=8192, K=8); the UHA rollout and sweep on the funnel (lfsteps 1 and 3
     at the test size, N=300, K=8 and N=2000, K=256) and its noise stack;
     one whole step of each new path's flags.
 27. the new forms' paths through the CLI, each form's launches counted
     from 0 just before its run and no other kernel launched: CAIS_UHA on
     the funnel at K=32 (funnel_k8's other flags, FUNNEL_EPS_DICT[32]) for
     CAIS_UHA_PATH_ITERS steps (underdamped rollout CAIS_UHA_PATH_ITERS +
     30, sweep CAIS_UHA_PATH_ITERS; ELBO above its value at init), the exact
     and exact_fwd modes on many_gmm with the LDVI flags, LDVI with the
     gmm_cais flags and UHA with funnel_k8's for UD_SHORT_ITERS, each
     followed by the evaluation; MCD_DNF with a PIS net (dds_grad) refused
     with no launch.
 28. timing (CUDA events, plain, kernel, kernel, plain) of the new forms at
     their paths' shapes, each beside its bound (_work_ud, _work_uha) and
     its device time per launch under torch.profiler; the CAIS_UHA funnel
     optimizer step over 50 and 200 steps against the eager step, with its
     device busy share.
 29. the PIS nets ("dds", "dds_grad", the net a template parameter of B1, B2,
     B3 and B5) against the plain versions, under injected noise: on
     many_gmm (units [64, 64]), gmm and the funnel ([16, 16]) at the test
     size, every rollout form (CAIS, CAIS_VAR, ULA_sn; noise stack), the KL
     sweep's carry and per-point forms (float64 arbiter), the replay and
     the reroll (and the reroll from a seed against the replay kernel); at
     the recipes' full width (N=2000 and 500, K=256, init_eps 1.0, cos_sq,
     init_sigma 60; VarGrad at 15) rollout, sweep, replay and reroll; the
     sweeps and the reroll at four groups (N=8192); the reroll at
     N=REROLL_N from a seed against the replay kernel (float64 arbiter);
     the count of score elements past dds_grad's clip (must be above 0);
     the whole steps of many_gmm_kl_dds, many_gmm_kl_dds_grad and VarGrad
     with dds.
 30. the PIS paths through the CLI, each form's launches counted from 0
     just before its run and no other kernel: many_gmm_kl_dds's and
     many_gmm_kl_dds_grad's flags for PIS_PATH_ITERS steps (rollout
     PIS_PATH_ITERS + 30, sweep PIS_PATH_ITERS; ELBO above its value at
     init), ULA_sn with dds, the gmm_cais flags with dds and funnel_k8's with
     dds_grad for PIS_SHORT_ITERS, VarGrad with dds (replay) for
     PIS_SHORT_ITERS and the re-rolling backward at N=REROLL_N for
     REROLL_ITERS; an inf loss (a chain past many_gmm's floor) is no
     divergence.
 31. timing (CUDA events, plain, kernel, kernel, plain) of every PIS form at
     its path's shape, each beside its bound (_work_pis) and its device time
     per launch under torch.profiler, the instances' registers and spill
     stores from ptxas, and both recipes' optimizer steps over 50 and 200
     steps against the eager step, with their device busy share.
 32. the wide forms (the 1600-D LGCP, unwhitened and whitened) against their
     plain versions: the inlined score and Hessian product (a probe kernel
     running the same device functions) against float64 at N=20 and N=500,
     at the variational start and at moved states (limit 1e-5 of the
     largest entry); the wide rollout under injected noise at N=20 and 37
     (K=8, with the trajectory store, 37 a partial tile) and N=500 (the
     evaluation's) against the plain version (TOL_FULL, the float64
     arbiter); its noise stack injected again (the same bits); the split
     sweep (B12) at N=20 and N=37: eps, betas, vd, every net leaf of the
     batched weight pass, g_z0 and gsn (GRAD_TOL_FULL, the float64
     arbiter); one whole lgcp_k8 step each through the kernels against the
     plain versions, the float64 step arbitrating.
 33. lgcp_k8's path through the CLI: LGCP_MFVI_ITERS MFVI iterations, then
     LGCP_PATH_ITERS steps (wide rollout LGCP_PATH_ITERS + 30 launches,
     split sweep LGCP_PATH_ITERS, no other kernel; no NaN loss, the ELBO
     above its value at init, the same MFVI before both), then whitened
     for LGCP_WHITENED_ITERS steps.
 34. timing (CUDA events, plain, kernel, kernel, plain) of the wide rollout
     (N=20 with its stores, N=500 without) and the split sweep at lgcp_k8's
     shapes, each beside its bound (_work_wide) and its device time per
     launch under torch.profiler, the instances' registers and spill
     stores from ptxas, and the lgcp_k8 optimizer step over 50 and 200
     steps against the eager step, with its device busy share.
 35. MCD_DNF's forms (zero drift, two geffner nets: dnf_rollout<D> in B1,
     kl_dnf_sweep<NG, D> in B3) against their plain versions under injected
     noise: at the test size on many_gmm, gmm and the funnel (the sweep under
     three schedules, the noise stacks), at full width (many_gmm, N=2000 and
     500, K=256, emb 130), at four groups (N=8192, K=8) and on the funnel at
     funnel_k8's shape and at N=2000, K=256 (TOL_SMALL / TOL_FULL,
     GRAD_TOL_SMALL / GRAD_TOL_FULL per leaf, sn2's included, the float64
     arbiter); the whole DNF step of each path's flags.
 36. the DNF paths through the CLI, each form's launches counted from 0 just
     before its run and no other kernel: the KL cell's flags on many_gmm with
     the mode swapped for DNF_PATH_ITERS steps, the gmm_cais flags and
     funnel_k8's for DNF_SHORT_ITERS (rollout iters + 30, sweep iters), each
     followed by the evaluation; no NaN loss, no divergence, the ELBO above
     its value at init on each.
 37. timing (CUDA events, plain, kernel, kernel, plain) of both DNF forms at
     each path's shape (the rollout also at the evaluation's N=500), each
     beside its bound (_work_dnf) and its device time per launch under
     torch.profiler, the instances' registers and spill stores from ptxas,
     and the many_gmm DNF optimizer step over 50 and 200 steps against the
     eager step, with its device busy share.
 38. the Bayesian logistic regressions' instances (australian D=15,
     ionosphere D=35, sonar D=61: overdamped_rollout<LogregTarget<D, R>,
     GeffnerNet, true, 1> in B1, kl_reverse_sweep<NG, LogregTarget<D, R>,
     true, GeffnerNet> in B3, the dataset read in place) against their plain
     versions: the inlined score and Hessian product through a probe kernel
     against float64 (512 points, logits past 88; limit 1e-5 of the point's
     scale); the CAIS rollout under injected noise at the test size (N=64,
     K=6, emb 16) and at the posterior protocol's (N=300, K=8, emb 20, grad
     clipping; TOL_SMALL / TOL_FULL, the float64 arbiter), its noise stack;
     the CAIS sweep at both sizes and at four groups (N=8192, K=4;
     GRAD_TOL_SMALL / GRAD_TOL_FULL, the float64 arbiter); the whole
     MCD_CAIS_sn step of each set's flags.
 39. each set's protocol flags through the CLI, cut to LOGREG_MFVI_ITERS
     MFVI iterations and LOGREG_PATH_ITERS steps, then the 10 x 500
     evaluation: the set's rollout launched LOGREG_PATH_ITERS + 10 times and
     its sweep LOGREG_PATH_ITERS times, no other kernel; no NaN loss, no
     divergence, the ELBO above its value at init after the same MFVI.
 40. timing (CUDA events, plain, kernel, kernel, plain; at K=256 the plain
     versions once) of both instances of each set at N=300 for K=8 and
     K=256, each beside its bound (_work_logreg) and its device time per
     launch under torch.profiler, the instances' registers and spill stores
     from ptxas, and the log_sonar optimizer step over 50 and 200 steps
     against the eager step, with its device busy share.
Then a line with each phase's seconds, a JSON line with each kernel's
launches, error, times and bound, and as the last line {"ok": true,
"device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

FLAGSHIP = (
    "--config.model many_gmm --config.boundmode MCD_CAIS_var_sn "
    "--config.N 2000 --config.nbridges 256 --config.emb_dim 130 "
    "--config.init_eps 0.65 --config.init_sigma 15 --config.grad_clipping True "
    "--config.train_eps False --config.train_vi False --config.iters 0 "
    "--noconfig.pretrain_mfvi --config.n_samples 500 --config.n_input_dist_seeds 30"
).split()

# 1000 steps (2000 before the PIS phases 29-31 joined the run, to keep it
# near half its time limit).
TRAIN_ITERS = 1000
TRAIN = FLAGSHIP + ["--config.iters", str(TRAIN_ITERS), "--config.lr", "0.005",
                    "--config.log.every", "1"]

KL_FLAGS = (
    "--config.model many_gmm --config.boundmode MCD_CAIS_sn "
    "--config.N 2000 --config.nbridges 256 --config.emb_dim 130 "
    "--config.init_eps 0.1 --config.init_sigma 15 --config.grad_clipping True "
    "--config.train_eps False --config.train_vi False --config.lr 0.005 "
    "--noconfig.pretrain_mfvi --config.n_samples 500 --config.n_input_dist_seeds 30 "
    "--config.log.every 1"
).split()

# LDVI: the underdamped mode whose score net sees [z, rho'] (in_dim 2 + 2 +
# 130), gamma eps = 0.25 (tests/test_pallas_kl.py:283-284), KL loss.
LDVI_FLAGS = (
    "--config.model many_gmm --config.boundmode MCD_U_a-lp-sn "
    "--config.N 2000 --config.nbridges 256 --config.emb_dim 130 "
    "--config.init_eps 0.05 --config.init_gamma 5.0 --config.init_sigma 15 "
    "--config.grad_clipping True --config.train_eps False --config.train_vi False "
    "--config.lr 0.005 --noconfig.pretrain_mfvi --config.n_samples 500 "
    "--config.n_input_dist_seeds 30 --config.log.every 1"
).split()

# UHA, the default boundmode: no net; md (the momentum log-scale) is not
# trained, eps and eta are, from eps 0.05 and eta 0.5.
UHA_FLAGS = (
    "--config.model many_gmm --config.boundmode UHA "
    "--config.N 2000 --config.nbridges 256 --config.lfsteps 1 "
    "--config.init_eps 0.05 --config.init_eta 0.5 --config.init_sigma 15 "
    "--config.train_eps True --config.train_vi False --config.lr 0.005 "
    "--noconfig.pretrain_mfvi --config.n_samples 500 --config.n_input_dist_seeds 30 "
    "--config.log.every 1"
).split()

# Where (K + 1) * N * 2 * 4 bytes of trajectory pass the 256 MiB budget at
# K=256 (N > 130560) and backward="auto" takes the re-rolling kernel.
REROLL_N, REROLL_ITERS = 131072, 5
# Chains per slice where a plain version runs in slices at N=REROLL_N.
PLAIN_CHUNK = 8192

# The card's published peaks (NVIDIA H100 SXM data sheet): FP32 outside the
# tensor cores and device memory.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# Kernel vs plain twin under the same noise. Small size: the CPU tests'
# tolerance. Full width (K=256): the two sum the 132-wide products in
# different orders and 256 steps compound it, so w (|w| ~ 1e3) gets an
# absolute floor; both limits sit a few times above what an H100 gave at
# N=2000 (z 9.5e-6 abs; w 5.9e-3 abs, 5.3e-6 rel; PERF.md).
TOL_SMALL = {"z_atol": 2e-4, "z_rtol": 1e-4, "w_atol": 5e-4, "w_rtol": 1e-4}
TOL_FULL = {"z_atol": 1e-4, "z_rtol": 0.0, "w_atol": 2e-2, "w_rtol": 1e-5}
TRAJ_ATOL, TRAJ_SHARE = 1e-2, 1e-3
# Gradients, per leaf: |g_kernel - g_plain| <= rel * |g_plain| + floor. At
# full width the two sum 514k points in f32 in different orders.
GRAD_TOL_SMALL = (1e-4, 1e-6)
GRAD_TOL_FULL = (1e-3, 0.0)
# The KL sweep chains the state cotangent through all K steps, so rounding
# compounds along it. Where a leaf misses GRAD_TOL_FULL the plain version in
# float64 arbitrates: the kernel passes if it is at most F64_SLACK times as
# far from the float64 gradient as the float32 plain version is.
F64_SLACK = 4.0
# The re-rolling backward from a seed against the replay kernel on the
# trajectory the rollout stored from that seed, per leaf.
REROLL_VS_REPLAY_TOL = (1e-4, 0.0)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase_device() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke.py runs on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1 device] {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()} torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from cmcd_tpu_torch.ops import (
        build,
        kl,
        kl_split,
        kl_uha,
        kl_underdamped,
        overdamped,
        overdamped_wide,
        uha,
        underdamped,
        vargrad,
    )

    sources = ("overdamped", "vargrad", "kl", "underdamped", "kl_underdamped", "uha", "kl_uha",
               "overdamped_wide", "kl_split", "overdamped_logreg", "kl_logreg")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, started together
        libs = list(pool.map(build.build, sources))
    for module in (overdamped, vargrad, kl, underdamped, kl_underdamped, uha, kl_uha,
                   overdamped_wide, kl_split):
        module._library()
    overdamped._library("overdamped_logreg")
    kl._library("kl_logreg")
    secs = time.perf_counter() - t0
    for so in libs:
        with open(so[:-3] + ".log") as f:
            ptxas = [ln.strip() for ln in f
                     if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
        print(f"[2 build] {os.path.relpath(so)} | " + " | ".join(ptxas), flush=True)
    print(f"[2 build] all {len(sources)} sources in {secs:.2f} s", flush=True)


def _pis_tree(rng, dim, units, arch):
    """A PIS net's weights in the JAX layout from a numpy generator: haiku's
    scale 1 / sqrt(fan_in), the output layers (zero at init) at 0.05 as the
    JAX tests randomise them, a phase away from zero."""
    c = units[0]
    dense = lambda i, o, std=None: {"w": rng.normal(0, std or 1 / math.sqrt(i), (i, o)),
                                    "b": rng.normal(0, 1e-2, o)}
    tree = {"timestep_phase": rng.normal(0, 0.3, c),
            "state_net": [dense(dim + c, units[0]), dense(units[0], units[1]),
                          dense(units[1], dim, 0.05)]}
    coder = [dense(2 * c, c), dense(c, c)]
    if arch == "dds":
        tree["time_coder"] = coder
    else:
        tree["time_coder_state"] = coder
        tree["time_coder_grad"] = ([dense(2 * c, c)] + [dense(c, c) for _ in units]
                                   + [dense(c, dim, 0.05)])
    return tree


def make_problem(n, k, emb_dim, *, seed, factor_sn=0.3, sigma=3.0, eps=0.1, din=None,
                 noise_rows=None, target="many_gmm", net="geffner", units=(64, 64), sn2=False):
    """Inputs from a numpy seed: net weights on din input columns ahead of
    the embedding (default the target's dim; JAX layout, converted; din 0: no
    net), or with net "dds" / "dds_grad" a PIS net of widths `units` on the
    state, z0, w0, non-uniform betas, noise (noise_rows, default K, x N x
    dim), the target's kernel-form score (many_gmm or the 3-mode gmm, dim 2;
    the funnel or the standard normal, dim 10); with sn2 (MCD_DNF) a second
    geffner net of the same width, factor_sn 0.2, drawn last."""
    from cmcd_tpu_torch.distributions import std_normal_log_prob
    from cmcd_tpu_torch.ops.target_grads import KERNEL_DIMS, score_for_target
    from cmcd_tpu_torch.schedules import betas_from_grid, make_beta_grid_params
    from cmcd_tpu_torch.targets import Target, load_target
    from cmcd_tpu_torch.utils.convert import geffner_from_jax, pis_from_jax

    rng = np.random.default_rng(seed)
    dim = KERNEL_DIMS[target]
    din = dim if din is None else din
    in_dim = din + emb_dim
    dense = lambda i, o: {"w": rng.normal(0, math.sqrt(2 / (i + o)), (i, o)),
                          "b": rng.normal(0, 1e-2, o)}
    tree = {"layers": [dense(in_dim, in_dim), dense(in_dim, in_dim)],
            "head": dense(in_dim, dim), "emb": rng.normal(0, 1.0, (k, emb_dim)),
            "factor_sn": np.float32(factor_sn)}
    dev = torch.device("cuda")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mg, gx, tx = make_beta_grid_params(k, device=dev)
    mg = f32(rng.uniform(0.5, 1.5, mg.shape[0]))
    tgt = (Target("std_normal", dim, std_normal_log_prob) if target == "std_normal"
           else load_target(target, device=dev))
    if net != "geffner":
        sn = pis_from_jax(_pis_tree(rng, dim, units, net), dev, target_log_prob=tgt.log_prob)
    else:
        sn = geffner_from_jax(tree, dev) if din else None
    out = dict(
        z0=f32(sigma * rng.standard_normal((n, dim))),
        w0=f32(rng.standard_normal(n)),
        betas=betas_from_grid(mg, gx, tx).contiguous(),
        eps=f32(eps),
        vd_mean=f32([0.5 * (-1) ** d for d in range(dim)]),
        vd_logdiag=f32([math.log(sigma)] * dim),
        grad_logp=score_for_target(tgt, dev),
        sn=sn,
        noise=f32(rng.standard_normal((noise_rows or k, n, dim))),
        dim=dim,
        nbridges=k,
    )
    if sn2:  # drawn after everything else, so the other inputs keep their bits
        tree2 = {"layers": [dense(in_dim, in_dim), dense(in_dim, in_dim)],
                 "head": dense(in_dim, dim), "emb": rng.normal(0, 1.0, (k, emb_dim)),
                 "factor_sn": np.float32(0.2)}
        out["sn2"] = geffner_from_jax(tree2, dev)
    return out


def _split(case):
    """A problem of make_problem as (the wrappers' positional arguments from
    z0 to grad_logp, their keyword arguments, the injected noise)."""
    kw = dict(case)
    noise = kw.pop("noise")
    names = ("z0", "w0", "betas", "eps", "vd_mean", "vd_logdiag", "grad_logp")
    return [kw.pop(a) for a in names], kw, noise


def _rollouts(wrappers=None):
    """(kernel wrapper, plain version) of a rollout: `wrappers`, or the
    overdamped tile form's."""
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )

    return wrappers or (evolve_overdamped_fused, evolve_overdamped_fused_plain)


def compare(case, spec, tol, wrappers=None, **kw):
    evolve_overdamped_fused, evolve_overdamped_fused_plain = _rollouts(wrappers)
    args = dict(case)
    pos = [args.pop(a) for a in ("z0", "w0", "betas", "eps", "vd_mean", "vd_logdiag", "grad_logp")]
    z_k, w_k, t_k = evolve_overdamped_fused(*pos, spec, **args, return_trajectory=True, **kw)
    z_p, w_p, t_p = evolve_overdamped_fused_plain(*pos, spec, **args, return_trajectory=True,
                                                  **kw)
    z_n, w_n = evolve_overdamped_fused(*pos, spec, **args, **kw)
    torch.cuda.synchronize()
    dz, dw = (z_k - z_p).abs(), (w_k - w_p).abs()
    # Mid-path the two rollouts drift apart further than at the end (rounding
    # differences grow along the path and contract again near the modes): the
    # stored path is held to TRAJ_ATOL everywhere and to the z tolerance in
    # all but TRAJ_SHARE of its elements.
    dt = (t_k - t_p).abs()
    bad_t = dt > tol["z_atol"] + tol["z_rtol"] * t_p.abs()
    traj_ok = float(dt.max()) <= TRAJ_ATOL and float(bad_t.float().mean()) <= TRAJ_SHARE
    # Storing the trajectory changes nothing else, and its ends are exact.
    same = bool(torch.equal(z_n, z_k) and torch.equal(w_n, w_k)
                and torch.equal(t_k[0], pos[0]) and torch.equal(t_k[-1], z_k))
    bad_z = dz > tol["z_atol"] + tol["z_rtol"] * z_p.abs()
    bad_w = dw > tol["w_atol"] + tol["w_rtol"] * w_p.abs()
    stats = {
        "z_max_abs": float(dz.max()),
        "z_max_rel": float((dz / z_p.abs().clamp_min(1e-6)).max()),
        "w_max_abs": float(dw.max()),
        "w_max_rel": float((dw / w_p.abs().clamp_min(1e-6)).max()),
        "traj_max_abs": float(dt.max()),
        "z_bad": int(bad_z.any(-1).sum()),
        "w_bad": int(bad_w.sum()),
        "traj_beyond_z_tol": int(bad_t.sum()),
        "traj_ok": traj_ok,
        "traj_ends_exact_and_outputs_unchanged": same,
        "finite": bool(torch.isfinite(z_k).all() and torch.isfinite(w_k).all()),
    }
    good = not (stats["z_bad"] or stats["w_bad"]) and traj_ok and same
    return stats, good and stats["finite"]


def _flat(grads):
    """A backward kernel's gradient dict as {leaf name: tensor} (DNF's
    second net's leaves as "sn2.<name>")."""
    return {**{k: v for k, v in grads.items() if k not in ("sn", "sn2")}, **grads.get("sn", {}),
            **{f"sn2.{name}": v for name, v in grads.get("sn2", {}).items()}}


def _grad_errors(got, want, tol):
    """Per leaf |got - want| against rel * |want| + floor (norms in f64):
    (worst error / |want|, its leaf, all within tolerance)."""
    rel, floor = tol
    worst, worst_leaf, ok = 0.0, "", True
    for name, w in want.items():
        g = got[name]
        if g is None or not bool(torch.isfinite(g).all()):
            return math.inf, name, False
        err = float((g.double() - w.double()).norm())
        ref = float(w.double().norm())
        ok &= err <= rel * ref + floor
        if err / max(ref, 1e-30) > worst:
            worst, worst_leaf = err / max(ref, 1e-30), name
    return worst, worst_leaf, ok


def compare_backward(case, tol, **kw):
    """The replay backward kernel against its plain version, from the plain
    rollout's trajectory and a random cotangent."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused_plain
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_replay,
        evolve_vargrad_bwd_replay_plain,
    )

    pos, args, noise = _split(case)
    _, _, traj = evolve_overdamped_fused_plain(*pos, CAIS_VAR, **args, noise=noise,
                                               return_trajectory=True, **kw)
    gen = torch.Generator(device="cuda").manual_seed(17)
    cot = torch.randn(pos[0].shape[0], generator=gen, device="cuda")
    g_k = evolve_vargrad_bwd_replay(traj, cot, *pos[2:], CAIS_VAR, **args, **kw)
    g_p = evolve_vargrad_bwd_replay_plain(traj, cot, *pos[2:], CAIS_VAR, **args, **kw)
    torch.cuda.synchronize()
    return _grad_errors(_flat(g_k), _flat(g_p), tol)


def compare_noise_stack(case, spec=None, wrappers=None, **kw):
    """The rollout's noise stack is what the kernel used: its Philox draws,
    injected again, give the same z, w and trajectory bit for bit (spec
    default CAIS)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS

    evolve_overdamped_fused = _rollouts(wrappers)[0]
    spec = spec or CAIS
    pos, args, _ = _split(case)
    seed = torch.tensor([13], device="cuda")
    z, w, traj, draws = evolve_overdamped_fused(*pos, spec, **args, seed=seed,
                                                return_trajectory=True, return_noise=True, **kw)
    z2, w2, traj2, same = evolve_overdamped_fused(*pos, spec, **args, noise=draws,
                                                  return_trajectory=True, return_noise=True, **kw)
    torch.cuda.synchronize()
    stats = {"z_equal": bool(torch.equal(z, z2)), "w_equal": bool(torch.equal(w, w2)),
             "traj_equal": bool(torch.equal(traj, traj2)), "injected_handed_on": same is draws,
             "mean": float(draws.mean()), "std": float(draws.std())}
    # The draws' moments within 0.01, or 5 standard errors of so few draws.
    m = draws.numel()
    good = (all(stats[k] for k in ("z_equal", "w_equal", "traj_equal", "injected_handed_on"))
            and abs(stats["mean"]) < max(0.01, 5 / math.sqrt(m))
            and abs(stats["std"] - 1.0) < max(0.01, 5 / math.sqrt(2 * m)))
    return stats, good


def _norm_errors(got, ref):
    return {name: float((got[name].double() - r.double()).norm()) for name, r in ref.items()}


def compare_sweep(case, tol, arbitrate=False, spec=None, **kw):
    """The KL reverse-sweep kernel (spec default CAIS, the carry form)
    against its plain version, from the plain rollout's trajectory, its noise
    and random cotangents: every gradient leaf and dL/dz0. arbitrate: False,
    or True (every leaf) or a tuple of leaf names, for which the plain
    version in float64 is computed too: a leaf so named beyond `tol` still
    passes if the kernel is at most F64_SLACK times as far from the float64
    value as the float32 plain version is (an empty tuple only reports)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused_plain

    spec = spec or CAIS
    pos, args, noise = _split(case)
    _, _, traj = evolve_overdamped_fused_plain(*pos, spec, **args, noise=noise,
                                               return_trajectory=True, **kw)
    gen = torch.Generator(device="cuda").manual_seed(19)
    n = pos[0].shape[0]
    cot = torch.randn(n, generator=gen, device="cuda")
    g_zf = torch.randn(n, pos[0].shape[1], generator=gen, device="cuda")
    tree = lambda out: {**_flat(out[0]), "g_z0": out[1]}
    got = tree(evolve_kl_bwd(traj, noise, cot, g_zf, *pos[2:], spec, **args, **kw))
    want = tree(evolve_kl_bwd_plain(traj, noise, cot, g_zf, *pos[2:], spec, **args, **kw))
    torch.cuda.synchronize()
    worst, leaf, ok = _grad_errors(got, want, tol)
    line = f"worst relative error {worst:.3e} (leaf {leaf}), limit {tol}"
    if arbitrate is not False:
        ref = tree(evolve_kl_bwd_plain(traj.double(), noise.double(), cot, g_zf, *pos[2:], spec,
                                       **args, **kw))
        ok, more = _arbitrate(got, want, ref, tol, None if arbitrate is True else arbitrate)
        line += more
    return worst, line, ok


def _arbitrate(got, want, ref, tol, leaves=None):
    """A float32 kernel result `got` against its float32 plain version
    `want`, per leaf, with the plain version in float64 (`ref`) as arbiter:
    a leaf beyond `tol` passes if it is one of `leaves` (default all) and
    the kernel is at most F64_SLACK times as far from the float64 value as
    the float32 plain version is. Returns (ok, the words for the report)."""
    e_k, e_p, e_kp = _norm_errors(got, ref), _norm_errors(want, ref), _norm_errors(got, want)
    rel, floor = tol
    needed = [name for name in ref if e_kp[name] > rel * float(want[name].double().norm()) + floor]
    ok = all(bool(torch.isfinite(g).all()) for g in got.values()) and all(
        (leaves is None or name in leaves) and e_k[name] <= F64_SLACK * e_p[name]
        for name in needed)
    rel64 = lambda e: max(e[name] / max(float(ref[name].norm()), 1e-30) for name in ref)
    return ok, (f"; against float64: kernel {rel64(e_k):.3e}, float32 plain {rel64(e_p):.3e} "
                f"(worst leaf each); leaves that needed the float64 arbiter: {needed or 'none'}")


def compare_reroll(case, tol, **kw):
    """The re-rolling backward kernel under injected noise against its plain
    version (the plain rollout, then the replay's plain version)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_reroll,
        evolve_vargrad_bwd_reroll_plain,
    )

    pos, args, noise = _split(case)
    gen = torch.Generator(device="cuda").manual_seed(17)
    cot = torch.randn(pos[0].shape[0], generator=gen, device="cuda")
    rest = (pos[0], cot, *pos[2:], CAIS_VAR)
    g_k = evolve_vargrad_bwd_reroll(*rest, **args, noise=noise, **kw)
    g_p = evolve_vargrad_bwd_reroll_plain(*rest, **args, noise=noise, **kw)
    torch.cuda.synchronize()
    return _grad_errors(_flat(g_k), _flat(g_p), tol)


def _chain_chunks(n, chunk):
    return [slice(a, min(a + chunk, n)) for a in range(0, n, chunk)]


def compare_rollout_chunked(case, spec, tol, chunk, **kw):
    """The rollout kernel on all N chains at once against its plain version
    on slices of `chunk` chains (chains are independent), under the same
    injected noise: final z and w. For an N whose plain rollout is too large
    for one pass. Up to TRAJ_SHARE of the chains may miss `tol` if the plain
    version in float64 arbitrates for them."""
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )
    from cmcd_tpu_torch.train.trainer import double_tree

    pos, args, noise = _split(case)
    z_k, w_k = evolve_overdamped_fused(*pos, spec, **args, noise=noise, **kw)
    parts = [evolve_overdamped_fused_plain(pos[0][sl], pos[1][sl], *pos[2:], spec, **args,
                                           noise=noise[:, sl].contiguous(), **kw)
             for sl in _chain_chunks(pos[0].shape[0], chunk)]
    z_p, w_p = (torch.cat([part[i] for part in parts]) for i in (0, 1))
    torch.cuda.synchronize()
    dz, dw = (z_k - z_p).abs(), (w_k - w_p).abs()
    bad = ((dz > tol["z_atol"] + tol["z_rtol"] * z_p.abs()).any(-1)
           | (dw > tol["w_atol"] + tol["w_rtol"] * w_p.abs()))
    stats = {
        "z_max_abs": float(dz[~bad].max()), "w_max_abs": float(dw[~bad].max()),
        "chains_beyond_tol": int(bad.sum()), "share_beyond_tol": float(bad.float().mean()),
        "z_max_abs_beyond_tol": float(dz.max()), "w_max_abs_beyond_tol": float(dw.max()),
        "finite": bool(torch.isfinite(z_k).all() and torch.isfinite(w_k).all()),
    }
    good = stats["finite"] and stats["share_beyond_tol"] <= TRAJ_SHARE
    if bad.any():
        # Among so many chains a few amplify the two float32 summation orders
        # past the limit by the last step (mid-path the N=2000 check sees the
        # same). The plain version in float64 on those chains arbitrates: per
        # chain the kernel's distance from it over the float32 plain version's,
        # whose median may be at most F64_SLACK (the norms over those chains,
        # which one chain can dominate, are printed beside it).
        f64 = lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point() else t
        args64 = dict(args, **{net: double_tree(args[net]) for net in ("sn", "sn2")
                           if args.get(net) is not None})
        z_d, w_d = evolve_overdamped_fused_plain(
            *(f64(t[bad]) for t in pos[:2]), *(f64(t) for t in pos[2:]), spec, **args64,
            noise=noise[:, bad].double(), **kw)
        def far(a_k, a_p, ref):
            e_k, e_p = ((a[bad].double() - ref).abs().reshape(len(ref), -1).amax(1)
                        for a in (a_k, a_p))
            return {"kernel": float(e_k.norm()), "plain": float(e_p.norm()),
                    "median_ratio": float((e_k / e_p.clamp_min(1e-30)).median())}

        stats["against_float64"] = {"z": far(z_k, z_p, z_d), "w": far(w_k, w_p, w_d)}
        good &= all(v["median_ratio"] <= F64_SLACK for v in stats["against_float64"].values())
    return stats, good


def compare_reroll_chunked(case, tol, chunk, **kw):
    """The re-rolling backward kernel on all N chains at once against its
    plain version on slices of `chunk` chains, summed in float64 (the
    gradient is a sum over chains), under the same injected noise. Returns
    (worst relative error, its leaf, ok, ms of the chunked plain pass)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_reroll,
        evolve_vargrad_bwd_reroll_plain,
    )

    pos, args, noise = _split(case)
    gen = torch.Generator(device="cuda").manual_seed(17)
    cot = torch.randn(pos[0].shape[0], generator=gen, device="cuda")
    g_k = _flat(evolve_vargrad_bwd_reroll(pos[0], cot, *pos[2:], CAIS_VAR, **args, noise=noise,
                                          **kw))
    total = {}

    def plain_pass():
        total.clear()
        for sl in _chain_chunks(pos[0].shape[0], chunk):
            part = _flat(evolve_vargrad_bwd_reroll_plain(
                pos[0][sl], cot[sl], *pos[2:], CAIS_VAR, **args,
                noise=noise[:, sl].contiguous(), **kw))
            for name, g in part.items():
                total[name] = total.get(name, 0.0) + g.double()

    plain_ms = _wall_ms(plain_pass)
    return (*_grad_errors(g_k, total, tol), plain_ms)


def _reroll_and_replay(case, **kw):
    """From one seed: the rollout kernel stores its trajectory and the replay
    kernel reads it; the re-rolling kernel makes the trajectory again from
    (z0, seed). Returns (the replay's gradient, the re-rolling kernel's, the
    trajectory, the cotangent)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
    from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay, evolve_vargrad_bwd_reroll

    pos, args, _ = _split(case)
    seed = torch.tensor([29], device="cuda")
    _, _, traj = evolve_overdamped_fused(*pos, CAIS_VAR, **args, seed=seed,
                                         return_trajectory=True, **kw)
    gen = torch.Generator(device="cuda").manual_seed(17)
    cot = torch.randn(pos[0].shape[0], generator=gen, device="cuda")
    g_replay = evolve_vargrad_bwd_replay(traj, cot, *pos[2:], CAIS_VAR, **args, **kw)
    g_reroll = evolve_vargrad_bwd_reroll(pos[0], cot, *pos[2:], CAIS_VAR, **args, seed=seed, **kw)
    torch.cuda.synchronize()
    return _flat(g_replay), _flat(g_reroll), traj, cot


def compare_reroll_with_replay(case, **kw):
    """The re-rolling kernel against the replay kernel from one seed: the two
    gradients agree if it draws the rollout's numbers."""
    g_replay, g_reroll, _, _ = _reroll_and_replay(case, **kw)
    return _grad_errors(g_reroll, g_replay, REROLL_VS_REPLAY_TOL)


def compare_reroll_with_replay_f64(case, chunk, **kw):
    """compare_reroll_with_replay with an arbiter: the replay's plain version
    on the stored trajectory in float32 and in float64 (in slices of `chunk`
    chains, summed in float64). A leaf beyond REROLL_VS_REPLAY_TOL still
    passes if the re-rolling kernel is at most F64_SLACK times as far from
    the float64 gradient as the float32 plain version is. Returns (worst
    error, its leaf, ok, the words for the report)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay_plain

    g_replay, g_reroll, traj, cot = _reroll_and_replay(case, **kw)
    worst, leaf, _ = _grad_errors(g_reroll, g_replay, REROLL_VS_REPLAY_TOL)
    pos, args, _ = _split(case)
    plain = {torch.float32: {}, torch.float64: {}}
    for sl in _chain_chunks(cot.shape[0], chunk):
        for dtype, total in plain.items():
            part = _flat(evolve_vargrad_bwd_replay_plain(
                traj[:, sl].to(dtype), cot[sl], *pos[2:], CAIS_VAR, **args, **kw))
            for name, g in part.items():
                total[name] = total.get(name, 0.0) + g.double()
    ref = plain[torch.float64]
    e_k, e_p, e_r = (_norm_errors(g, ref) for g in (g_reroll, plain[torch.float32], g_replay))
    rel, floor = REROLL_VS_REPLAY_TOL
    needed = [name for name, w in g_replay.items()
              if float((g_reroll[name].double() - w.double()).norm())
              > rel * float(w.double().norm()) + floor]
    ok = all(bool(torch.isfinite(g).all()) for g in g_reroll.values()) and all(
        e_k[name] <= F64_SLACK * e_p[name] for name in needed)
    rel64 = lambda e: {name: e[name] / max(float(ref[name].norm()), 1e-30) for name in needed}
    return worst, leaf, ok, (
        f"; leaves that needed the float64 arbiter: {needed or 'none'}"
        + (f", their distance from float64 (relative): re-rolling kernel "
           f"{json.dumps(rel64(e_k))}, replay kernel {json.dumps(rel64(e_r))}, float32 plain "
           f"{json.dumps(rel64(e_p))} (limit {F64_SLACK} times the plain's)" if needed else ""))


def compare_training_step(flags=None, name="VarGrad", arbitrate=False, tag="3 compare"):
    """One whole training step at the flagship size with factor_sn 0.3, a
    head of scale 0.05 (as the CPU tests) and injected draws: the mode's
    fused loss through the kernels against the same call through the plain
    versions, loss and every gradient leaf."""
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.train.trainer import double_tree, tree_leaf_names, tree_leaves

    from cmcd_tpu_torch.integrators import UNDERDAMPED

    cfg, setup, target, params, ctx = flagship(flags)
    loss_fn, _ = fused_training_path(setup, cfg.N)
    gen = torch.Generator(device="cuda").manual_seed(23)
    sn = params["train"].get("sn")
    with torch.no_grad():  # a live net that leaves the chains inside the target's support
        if hasattr(sn, "factor_sn"):
            sn.factor_sn.fill_(0.3)
            sn.head.weight.normal_(0.0, 0.05, generator=gen)
            if "sn2" in params["train"]:  # DNF's second net, as make_problem's
                params["train"]["sn2"].factor_sn.fill_(0.2)
                params["train"]["sn2"].head.weight.normal_(0.0, 0.05, generator=gen)
        elif sn is not None:  # a PIS net: its output layers (zero at init), as the JAX tests
            sn.state_net[-1].weight.normal_(0.0, 0.05, generator=gen)
            if hasattr(sn, "time_coder_grad"):
                sn.time_coder_grad[-1].weight.normal_(0.0, 0.05, generator=gen)
    # An underdamped or UHA rollout draws the initial momentum too: K + 1 rows.
    rows = cfg.nbridges + (cfg.boundmode in UNDERDAMPED or cfg.boundmode == "UHA")
    draws = dict(base_normals=torch.randn(cfg.N, setup.dim, generator=gen, device="cuda"),
                 noise=torch.randn(rows, cfg.N, setup.dim, generator=gen, device="cuda"))
    names = tree_leaf_names(params["train"])
    plain = dict(plain=True)

    def value_and_grads(tree, kw, cast=lambda t: t):
        tree_l = tree_leaves(tree["train"])
        for leaf in tree_l:
            leaf.requires_grad_(True)
        loss, _ = loss_fn(tree, cfg.N, ctx, setup, target, **kw,
                          **{k: cast(v) for k, v in draws.items()})
        grads = torch.autograd.grad(loss, tree_l, allow_unused=True)
        return float(loss.detach()), {n: g for n, g in zip(names, grads) if g is not None}

    (l_k, g_k), (l_p, g_p) = value_and_grads(params, {}), value_and_grads(params, plain)
    torch.cuda.synchronize()
    worst, leaf, ok = _grad_errors(g_k, g_p, GRAD_TOL_FULL)
    loss_rel = abs(l_k - l_p) / abs(l_p)
    line = ""
    if arbitrate:
        # The whole step again in float64 (plain versions on a float64 copy
        # of the parameters and draws): the arbiter of the two float32 paths.
        _, g_d = value_and_grads(double_tree(params), plain, lambda t: t.double())
        e_k, e_p = _norm_errors(g_k, g_d), _norm_errors(g_p, g_d)
        rel, floor = GRAD_TOL_FULL
        needed = [n for n, e in _norm_errors(g_k, g_p).items()
                  if e > rel * float(g_p[n].double().norm()) + floor]
        ok = all(bool(torch.isfinite(g).all()) for g in g_k.values()) and all(
            e_k[n] <= F64_SLACK * e_p[n] for n in needed)
        rel64 = lambda e: max(e[n] / max(float(g_d[n].norm()), 1e-30) for n in g_d)
        line = (f"; against the float64 step: kernels {rel64(e_k):.3e}, float32 plain versions "
                f"{rel64(e_p):.3e} (worst leaf each); leaves that needed the float64 arbiter "
                f"(kernels at most {F64_SLACK} times as far): "
                f"{[(n, e_k[n] / max(e_p[n], 1e-30)) for n in needed] or 'none'}")
    print(f"[{tag}] {name} training step N={cfg.N} K={cfg.nbridges}: loss kernel {l_k!r} "
          f"plain {l_p!r} (rel {loss_rel:.3e}, limit 1e-4), {len(g_p)} gradient leaves, worst "
          f"relative error {worst:.3e} (leaf {leaf}, limit {GRAD_TOL_FULL[0]}){line}", flush=True)
    # Below the VarGrad loss's clamp at 1e7, where the gradient would be zero.
    return ok and loss_rel <= 1e-4 and set(g_k) == set(g_p) and l_p < 1e7


def phase_compare():
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR

    small = make_problem(256, 8, 16, seed=0)
    ok = True
    for name, spec, kw in (
        ("CAIS_VAR", CAIS_VAR, dict(grad_clipping=True)),
        ("CAIS_VAR cos_sq", CAIS_VAR, dict(grad_clipping=True, eps_schedule="cos_sq")),
        ("CAIS", CAIS, dict(grad_clipping=True, eps_schedule="linear")),
        ("CAIS_VAR noclip", CAIS_VAR, dict(grad_clipping=False)),
    ):
        stats, good = compare(small, spec, TOL_SMALL, **kw)
        ok &= good
        print(f"[3 compare] rollout small N=256 K=8 emb16 {name}: {json.dumps(stats)}", flush=True)
    max_err = 0.0
    for n, seed in ((2000, 1), (500, 5)):
        full = make_problem(n, 256, 130, seed=seed, sigma=15.0, eps=0.65)
        stats, good = compare(full, CAIS_VAR, TOL_FULL, grad_clipping=True)
        ok &= good
        max_err = max(max_err, stats["z_max_abs"], stats["w_max_abs"], stats["traj_max_abs"])
        print(f"[3 compare] rollout full N={n} K=256 emb130 CAIS_VAR: {json.dumps(stats)} "
              f"tol {json.dumps(TOL_FULL)}", flush=True)
        # The KL path's rollout at the same two shapes: spec CAIS (no clip on
        # the variational score) at the KL recipe's step size.
        full = make_problem(n, 256, 130, seed=seed + 10, sigma=15.0, eps=0.1)
        stats, good = compare(full, CAIS, TOL_FULL, grad_clipping=True)
        ok &= good
        max_err = max(max_err, stats["z_max_abs"], stats["w_max_abs"], stats["traj_max_abs"])
        print(f"[3 compare] rollout full N={n} K=256 emb130 CAIS: {json.dumps(stats)} "
              f"tol {json.dumps(TOL_FULL)}", flush=True)

    for name, kw in (
        ("", dict(grad_clipping=True)),
        ("cos_sq", dict(grad_clipping=True, eps_schedule="cos_sq")),
        ("linear noclip", dict(grad_clipping=False, eps_schedule="linear")),
    ):
        worst, leaf, good = compare_backward(make_problem(250, 8, 16, seed=3), GRAD_TOL_SMALL, **kw)
        ok &= good
        print(f"[3 compare] backward small N=250 K=8 emb16 {name}: worst relative error "
              f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_SMALL}, ok {good}", flush=True)
    bwd_err = 0.0
    for n, seed in ((2000, 6), (1001, 7)):
        full = make_problem(n, 256, 130, seed=seed, sigma=15.0, eps=0.65)
        worst, leaf, good = compare_backward(full, GRAD_TOL_FULL, grad_clipping=True)
        ok &= good
        bwd_err = max(bwd_err, worst)
        print(f"[3 compare] backward full N={n} K=256 emb130: worst relative error "
              f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_FULL}, ok {good}", flush=True)
    ok &= compare_training_step()

    stats, good = compare_noise_stack(make_problem(2000, 256, 130, seed=8, sigma=15.0),
                                      grad_clipping=True)
    ok &= good
    print(f"[3 compare] rollout noise stack N=2000 K=256 emb130 CAIS: {json.dumps(stats)}",
          flush=True)
    for name, kw in (
        ("", dict(grad_clipping=True)),
        ("cos_sq", dict(grad_clipping=True, eps_schedule="cos_sq")),
        ("linear", dict(grad_clipping=True, eps_schedule="linear")),
        ("noclip", dict(grad_clipping=False)),
        ("linear noclip", dict(grad_clipping=False, eps_schedule="linear")),
    ):
        _, line, good = compare_sweep(make_problem(128, 6, 16, seed=3, sigma=8.0),
                                      GRAD_TOL_SMALL, **kw)
        ok &= good
        print(f"[3 compare] KL sweep small N=128 K=6 emb16 {name}: {line}, ok {good}", flush=True)
        worst, leaf, good = compare_reroll(make_problem(250, 8, 16, seed=3), GRAD_TOL_SMALL, **kw)
        ok &= good
        print(f"[3 compare] reroll small N=250 K=8 emb16 {name}: worst relative error "
              f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_SMALL}, ok {good}", flush=True)
    # N=6000 is past 132 tiles of 32 chains: the sweeps run four groups of
    # feature threads there and a block walks more than one tile.
    kl_err = reroll_err = 0.0
    for n, seed in ((2000, 6), (1001, 7), (6000, 9)):
        full = make_problem(n, 256, 130, seed=seed, sigma=15.0)
        worst, line, good = compare_sweep(full, GRAD_TOL_FULL, arbitrate=True, grad_clipping=True)
        ok &= good
        kl_err = max(kl_err, worst)
        print(f"[3 compare] KL sweep full N={n} K=256 emb130: {line}, ok {good}", flush=True)
        full = make_problem(n, 256, 130, seed=seed, sigma=15.0, eps=0.65)
        worst, leaf, good = compare_reroll(full, GRAD_TOL_FULL, grad_clipping=True)
        ok &= good
        reroll_err = max(reroll_err, worst)
        print(f"[3 compare] reroll full N={n} K=256 emb130 (injected noise, vs plain): worst "
              f"relative error {worst:.3e} (leaf {leaf}), limit {GRAD_TOL_FULL}, ok {good}",
              flush=True)
        worst, leaf, good = compare_reroll_with_replay(full, grad_clipping=True)
        ok &= good
        print(f"[3 compare] reroll full N={n} K=256 emb130 (seed, vs the replay kernel on the "
              f"rollout's trajectory): worst relative error {worst:.3e} (leaf {leaf}), limit "
              f"{REROLL_VS_REPLAY_TOL}, ok {good}", flush=True)
    # The re-rolling path's own shape (four groups, 32 tiles per block). The
    # plain versions' one batched pass does not fit the card there, and chains
    # are independent: they run on slices of PLAIN_CHUNK chains, the rollout's
    # results joined, the gradient's summed.
    big = make_problem(REROLL_N, 256, 130, seed=10, sigma=15.0, eps=0.65)
    stats, good = compare_rollout_chunked(big, CAIS_VAR, TOL_FULL, PLAIN_CHUNK, grad_clipping=True)
    ok &= good
    max_err = max(max_err, stats["z_max_abs"], stats["w_max_abs"])
    print(f"[3 compare] rollout full N={REROLL_N} K=256 emb130 CAIS_VAR (plain version in slices "
          f"of {PLAIN_CHUNK} chains): {json.dumps(stats)} tol {json.dumps(TOL_FULL)}", flush=True)
    worst, leaf, good, reroll_big_plain_ms = compare_reroll_chunked(
        big, GRAD_TOL_FULL, PLAIN_CHUNK, grad_clipping=True)
    ok &= good
    reroll_big_err = worst
    print(f"[3 compare] reroll full N={REROLL_N} K=256 emb130 (injected noise, vs plain in slices "
          f"of {PLAIN_CHUNK} chains, summed; {reroll_big_plain_ms:.1f} ms): worst relative error "
          f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_FULL}, ok {good}", flush=True)
    worst, leaf, good = compare_reroll_with_replay(big, grad_clipping=True)
    ok &= good
    print(f"[3 compare] reroll full N={REROLL_N} K=256 emb130 (seed, vs the replay kernel on the "
          f"rollout's trajectory): worst relative error {worst:.3e} (leaf {leaf}), limit "
          f"{REROLL_VS_REPLAY_TOL}, ok {good}", flush=True)
    del big
    ok &= compare_training_step(KL_FLAGS + ["--config.iters", "0"], "KL", arbitrate=True)
    if not ok:
        fail("a kernel and its plain version disagree beyond tolerance")
    return max_err, bwd_err, kl_err, max(reroll_err, reroll_big_err), (reroll_big_err,
                                                                       reroll_big_plain_ms)


def flagship(flags=None):
    """(config, setup, target, params, ctx) as main.run_experiment builds
    them for `flags` (default: the flagship VarGrad flags)."""
    from cmcd_tpu_torch.main import init_experiment, parse_flags

    cfg = parse_flags(flags or FLAGSHIP)
    target, setup, params, ctx = init_experiment(cfg, torch.device("cuda"))
    return cfg, setup, target, params, ctx


def phase_main_path():
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused

    cfg = parse_flags(FLAGSHIP)
    evolve_overdamped_fused.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = evolve_overdamped_fused.launches
    print(f"[4 evaluation path] ELBO {out['final_elbo']!r} +- {out['final_elbo_std']!r} "
          f"ln Z {out['final_ln_Z']!r} +- {out['final_ln_Z_std']!r} launches {launches} "
          f"wall {wall:.3f} s samples {out['samples'].shape}", flush=True)
    if launches != cfg.n_input_dist_seeds:
        fail(f"main path launched the kernel {launches} times, expected "
             f"{cfg.n_input_dist_seeds}")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("main path ELBO / ln Z not finite")
    if out["neg_elbos"].shape != (30, 500) or out["samples"].shape != (15000, 2):
        fail(f"main path shapes {out['neg_elbos'].shape} {out['samples'].shape}")
    if not np.isfinite(out["samples"]).all():
        fail("main path samples not finite")
    return launches


def _evaluate(state, rollout, seed):
    """One 30 x 500 evaluation of the flagship params through `rollout`."""
    from cmcd_tpu_torch.ops.fused import compute_elbos_fused
    from cmcd_tpu_torch.train import evaluate

    cfg, setup, target, params, ctx = state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fn = lambda p, n, g: compute_elbos_fused(p, n, setup, target, generator=g, rollout=rollout)
    return evaluate(params, ctx, setup, generator=gen, n_samples=cfg.n_samples,
                    n_input_dist_seeds=cfg.n_input_dist_seeds, elbo_fn=fn)


def phase_statistics():
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )

    state = flagship()
    k = _evaluate(state, evolve_overdamped_fused, seed=11)
    p = _evaluate(state, evolve_overdamped_fused_plain, seed=12)
    line = {}
    ok = True
    for key in ("final_elbo", "final_ln_Z"):
        se = math.hypot(k[key + "_std"], p[key + "_std"]) / math.sqrt(30)
        z = abs(k[key] - p[key]) / se
        line[key] = {"kernel": k[key], "plain": p[key], "combined_se": se, "z": z}
        ok &= z <= 4.0
    print(f"[5 statistics] {json.dumps(line)}", flush=True)
    if not ok:
        fail("Philox kernel and torch.randn plain evaluations differ by > 4 SE")


def _event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _profile(fn):
    """Device time over one call of fn (torch.profiler), read from the
    device's own records only (kernels, memcpy, memset); the CPU op that
    launched a kernel carries the same time again, so CPU rows are left out.
    Returns (wall ms under the profiler, busy ms as the union of the device
    intervals, the device records [name, ms, count] by time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall_ms(fn)
    # Kernels, memcpy and memset only: an annotation such as the optimizer's
    # step spans the kernels it launched and would count them twice by name.
    records = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)
                     and not e.name.startswith("Optimizer."))
    busy_us, reach = 0.0, -math.inf
    by_name = {}
    for start, end, name in records:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e3, count + 1)
    top = sorted(([n[:60], ms, c] for n, (ms, c) in by_name.items()), key=lambda r: -r[1])
    top = top[:6] + [["all device records", sum(ms for ms, _ in by_name.values()),
                      sum(c for _, c in by_name.values())]]
    return wall, busy_us / 1e3, top


def _device_ms(fn, reps, kernel):
    """Device time per launch of the kernel named `kernel` over reps calls
    of fn, from torch.profiler's records of that kernel alone (the wrapper's
    host work and any other device record left out); None if the profiler
    recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and f"::{kernel}<" in e.name]
    return sum(spans) / 1e3 / len(spans) if spans else None


def phase_timing():
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )

    rollout = {}
    for n in (500, 2000):
        case = make_problem(n, 256, 130, seed=2, sigma=15.0, eps=0.65)
        case.pop("noise")
        pos = [case.pop(a) for a in ("z0", "w0", "betas", "eps", "vd_mean", "vd_logdiag",
                                     "grad_logp")]
        seed = torch.tensor([7], device="cuda")
        kern = lambda: evolve_overdamped_fused(*pos, CAIS_VAR, **case, grad_clipping=True,
                                               seed=seed)
        plain = lambda: evolve_overdamped_fused_plain(*pos, CAIS_VAR, **case,
                                                      grad_clipping=True, seed=7)
        times = rollout[f"N{n}"] = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn, reps = (plain, 2) if name == "plain" else (kern, 20)
            times[name].append(_event_ms(fn, reps))
    state = flagship()
    evals = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        r = evolve_overdamped_fused_plain if name == "plain" else evolve_overdamped_fused
        evals[name].append(_wall_ms(lambda: _evaluate(state, r, seed=3)))
    prof_wall, prof_dev, top = _profile(lambda: _evaluate(state, evolve_overdamped_fused, 4))
    print(f"[6 timing] rollout K=256 ms {json.dumps(rollout)} | "
          f"evaluate 30x500 ms {json.dumps(evals)}", flush=True)
    print(f"[6 profile] kernel evaluate 30x500: wall {prof_wall!r} ms under the "
          f"profiler, device busy {prof_dev!r} ms ({100 * prof_dev / prof_wall!r}%), "
          f"device records [name, ms, count] {json.dumps(top)}; busy over the "
          f"fastest unprofiled kernel evaluate {100 * prof_dev / min(evals['kernel'])!r}%",
          flush=True)
    return min(rollout["N500"]["kernel"]), min(rollout["N500"]["plain"]), evals


def phase_training_path():
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
    from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay

    cfg = parse_flags(TRAIN)
    evolve_overdamped_fused.launches = 0
    evolve_vargrad_bwd_replay.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = evolve_overdamped_fused.launches, evolve_vargrad_bwd_replay.launches
    result = out["train"]
    losses = result.losses.double()
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    print(f"[7 training path] {cfg.iters} steps N={cfg.N} K={cfg.nbridges}: rollout launches "
          f"{fwd} backward launches {bwd} wall {wall:.3f} s ({1e3 * wall / cfg.iters:.3f} ms per "
          f"step, evaluation and init included) | loss mean first 100 {first!r} last 100 "
          f"{last!r} ratio {last / first!r} | after training ELBO {out['final_elbo']!r} +- "
          f"{out['final_elbo_std']!r} ln Z {out['final_ln_Z']!r} +- {out['final_ln_Z_std']!r} "
          f"diverged {result.diverged} steps_done {result.steps_done}", flush=True)
    if fwd != cfg.iters + cfg.n_input_dist_seeds or bwd != cfg.iters:
        fail(f"training path launched rollout {fwd} and backward {bwd} times, expected "
             f"{cfg.iters + cfg.n_input_dist_seeds} and {cfg.iters}")
    if len(losses) != cfg.iters or bool(torch.isnan(losses).any()):
        fail(f"training path logged {len(losses)} losses, NaN among them: "
             f"{bool(torch.isnan(losses).any())}")
    if result.diverged or result.steps_done != cfg.iters:
        fail("training path diverged")
    if not last < 0.5 * first:
        fail(f"training loss did not halve: first 100 {first}, last 100 {last}")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("training path ELBO / ln Z not finite")
    if out["neg_elbos"].shape != (30, 500) or not np.isfinite(out["samples"]).all():
        fail("training path evaluation output malformed")
    return fwd, bwd


def _work(n, k, in_dim, n_mix=40):
    """Least time the card could take for one call of each kernel at these
    shapes: FP32 operations over the FP32 peak against bytes (every input
    read once, every output written once) over the memory rate."""
    points = (k + 1) * n
    score = 6 * n_mix                                     # per point: distances, exp, sums
    net_apply = in_dim * in_dim + 4 * in_dim              # FMAs: layer 2, layer 1's z part, head
    weights = 4 * (2 * in_dim + k * in_dim + k * (in_dim - 2) + in_dim * in_dim + 3 * in_dim
                   + 2 + 2 * n_mix)
    fwd_flops = 2 * points * (net_apply + score)
    fwd_bytes = 4 * (3 * n + k) + weights + 4 * (3 * n) + 8 * points  # z0, w0, betas; z, w, traj
    # Backward: the apply again, W2 g_a2, the outer product into dW2.
    bwd_flops = 2 * points * (3 * in_dim * in_dim + 8 * in_dim + score)
    bwd_bytes = 8 * points + 4 * (n + k) + weights + 4 * (in_dim * in_dim + 5 * in_dim + 8
                                                          + (k + 1) * (2 * in_dim + 2))
    # KL sweep: the backward's work plus the 40-component Hessian product per
    # point; reads trajectory, noise, cot and g_zfinal, writes dL/dz0 too.
    kl_flops = bwd_flops + 2 * points * 10 * n_mix
    kl_bytes = bwd_bytes + 8 * k * n + 16 * n
    # Reroll: the backward's work on a trajectory it makes itself (one apply
    # per point serves both); reads z0 instead of the trajectory.
    reroll_flops = bwd_flops + 2 * points * 8
    reroll_bytes = bwd_bytes - 8 * points + 8 * n + 8
    return (_bound(fwd_flops, fwd_bytes), _bound(bwd_flops, bwd_bytes),
            _bound(kl_flops, kl_bytes), _bound(reroll_flops, reroll_bytes))


def _bound(flops, nbytes):
    """The least time for `flops` FP32 operations and `nbytes` of device
    memory traffic at the card's published peaks, and which of the two sets it."""
    return {
        "bound_ms": 1e3 * max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES),
        "bound_by": "operations" if flops / PEAK_FLOPS >= nbytes / PEAK_BYTES else "bytes",
        "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
    }


def phase_training_timing():
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.fused_train import var_bound_fused
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_replay,
        evolve_vargrad_bwd_replay_plain,
    )
    from cmcd_tpu_torch.train import train

    case = make_problem(2000, 256, 130, seed=2, sigma=15.0, eps=0.65)
    case.pop("noise")
    pos = [case.pop(a) for a in ("z0", "w0", "betas", "eps", "vd_mean", "vd_logdiag", "grad_logp")]
    seed = torch.tensor([7], device="cuda")
    kw = dict(case, grad_clipping=True)
    _, _, traj = evolve_overdamped_fused(*pos, CAIS_VAR, **kw, seed=seed, return_trajectory=True)
    cot = torch.randn(2000, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    fns = {
        "rollout": (lambda: evolve_overdamped_fused(*pos, CAIS_VAR, **kw, seed=seed), 20),
        "rollout_traj": (lambda: evolve_overdamped_fused(*pos, CAIS_VAR, **kw, seed=seed,
                                                         return_trajectory=True), 20),
        "rollout_traj_plain": (lambda: evolve_overdamped_fused_plain(
            *pos, CAIS_VAR, **kw, seed=7, return_trajectory=True), 2),
        "backward": (lambda: evolve_vargrad_bwd_replay(traj, cot, *pos[2:], CAIS_VAR, **kw), 20),
        "backward_plain": (lambda: evolve_vargrad_bwd_replay_plain(
            traj, cot, *pos[2:], CAIS_VAR, **kw), 2),
    }
    times = {name: [] for name in fns}
    for name in ("rollout_traj_plain", "backward_plain", "rollout", "rollout_traj", "backward",
                 "backward", "rollout_traj", "rollout", "backward_plain", "rollout_traj_plain"):
        fn, reps = fns[name]
        times[name].append(_event_ms(fn, reps))
    print(f"[8 timing] kernels N=2000 K=256 emb130 ms {json.dumps(times)}", flush=True)

    # One optimizer step (train() itself, loss read at the end only).
    cfg, setup, target, params, ctx = flagship()
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi, cfg.train_betas)
    fused = lambda p, n, c, s, generator: var_bound_fused(p, n, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        gen = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=0.005, iters=iters, batch_size=cfg.N,
                             generator=gen, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=iters, nan_check_every=10**9)

    steps(fused, 5)()
    step_ms = {"eager": [], "kernel": []}
    for name in ("eager", "kernel", "kernel", "eager"):
        loss_fn, iters = (bounds.var_bound, 3) if name == "eager" else (fused, 50)
        step_ms[name].append(_wall_ms(steps(loss_fn, iters)) / iters)
    print(f"[8 timing] optimizer step N=2000 K=256 ms per step {json.dumps(step_ms)} "
          f"(kernel: 50 steps, eager: 3 steps per reading)", flush=True)
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    print(f"[8 profile] 10 fused steps: wall {prof_wall!r} ms under the profiler, device busy "
          f"{prof_dev!r} ms ({100 * prof_dev / prof_wall!r}%), per step busy {prof_dev / 10!r} "
          f"ms, device records [name, ms, count] {json.dumps(top)}; busy over the fastest "
          f"unprofiled step {100 * prof_dev / 10 / min(step_ms['kernel'])!r}%", flush=True)
    return times, step_ms


def phase_kl_training_path():
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
    from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay, evolve_vargrad_bwd_reroll

    # The same evaluation (same seeds) at the initial parameters first.
    init = run_experiment(parse_flags(KL_FLAGS + ["--config.iters", "0"]))
    cfg = parse_flags(KL_FLAGS + ["--config.iters", str(TRAIN_ITERS)])
    counters = (evolve_overdamped_fused, evolve_kl_bwd, evolve_vargrad_bwd_replay,
                evolve_vargrad_bwd_reroll)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, replay, reroll = (fn.launches for fn in counters)
    result = out["train"]
    losses = result.losses.double()
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    print(f"[9 KL training path] {cfg.iters} steps N={cfg.N} K={cfg.nbridges} "
          f"{cfg.boundmode}: rollout launches {fwd} reverse-sweep launches {bwd} (VarGrad "
          f"backward launches {replay + reroll}) wall {wall:.3f} s ({1e3 * wall / cfg.iters:.3f} "
          f"ms per step, evaluation and init included) | loss mean first 100 {first!r} last 100 "
          f"{last!r} | ELBO {init['final_elbo']!r} -> {out['final_elbo']!r} +- "
          f"{out['final_elbo_std']!r} ln Z {init['final_ln_Z']!r} -> {out['final_ln_Z']!r} +- "
          f"{out['final_ln_Z_std']!r} diverged {result.diverged} steps_done {result.steps_done}",
          flush=True)
    if fwd != cfg.iters + cfg.n_input_dist_seeds or bwd != cfg.iters or replay or reroll:
        fail(f"KL training path launched rollout {fwd}, reverse sweep {bwd}, VarGrad backward "
             f"{replay + reroll} times, expected {cfg.iters + cfg.n_input_dist_seeds}, "
             f"{cfg.iters}, 0")
    if len(losses) != cfg.iters or bool(torch.isnan(losses).any()):
        fail(f"KL training path logged {len(losses)} losses, NaN among them: "
             f"{bool(torch.isnan(losses).any())}")
    if result.diverged or result.steps_done != cfg.iters:
        fail("KL training path diverged")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("KL training path ELBO / ln Z not finite")
    if not out["final_elbo"] > init["final_elbo"]:
        fail(f"KL training did not raise the ELBO: {init['final_elbo']} -> {out['final_elbo']}")
    if out["neg_elbos"].shape != (30, 500) or not np.isfinite(out["samples"]).all():
        fail("KL training path evaluation output malformed")
    return fwd, bwd


def phase_reroll_path():
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
    from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay, evolve_vargrad_bwd_reroll

    cfg = parse_flags(FLAGSHIP + ["--config.N", str(REROLL_N), "--config.iters",
                                  str(REROLL_ITERS), "--config.lr", "0.005",
                                  "--config.log.every", "1"])
    counters = (evolve_overdamped_fused, evolve_vargrad_bwd_reroll, evolve_vargrad_bwd_replay)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    fwd, reroll, replay = (fn.launches for fn in counters)
    traj_mib = (cfg.nbridges + 1) * cfg.N * 2 * 4 / 2**20
    losses = out["train"].losses.double()
    print(f"[10 reroll path] {cfg.iters} steps N={cfg.N} K={cfg.nbridges} {cfg.boundmode}: "
          f"rollout launches {fwd} reroll launches {reroll} replay launches {replay} wall "
          f"{wall:.3f} s | peak device memory {peak / 2**20:.1f} MiB ({(peak - before) / 2**20:.1f} "
          f"MiB above the start; the trajectory alone would be {traj_mib:.1f} MiB) | losses "
          f"{[float(x) for x in losses]!r} | ELBO {out['final_elbo']!r} ln Z {out['final_ln_Z']!r}",
          flush=True)
    if fwd != cfg.iters + cfg.n_input_dist_seeds or reroll != cfg.iters or replay:
        fail(f"reroll path launched rollout {fwd}, reroll {reroll}, replay {replay} times, "
             f"expected {cfg.iters + cfg.n_input_dist_seeds}, {cfg.iters}, 0")
    if len(losses) != cfg.iters or bool(torch.isnan(losses).any()) or out["train"].diverged:
        fail("reroll path: NaN loss or diverged")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("reroll path ELBO / ln Z not finite")
    return reroll, peak


def phase_kl_timing():
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR
    from cmcd_tpu_torch.ops.fused_train import kl_bound_fused
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_reroll,
        evolve_vargrad_bwd_reroll_plain,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.randn(2000, generator=gen, device="cuda")
    g_zf = torch.randn(2000, 2, generator=gen, device="cuda")

    def problem(eps):
        pos, kw, _ = _split(make_problem(2000, 256, 130, seed=2, sigma=15.0, eps=eps))
        return pos, dict(kw, grad_clipping=True)

    pos, kw = problem(0.1)       # the KL recipe's step size
    _, _, traj, noise = evolve_overdamped_fused(*pos, CAIS, **kw, seed=seed,
                                                return_trajectory=True, return_noise=True)
    vpos, vkw = problem(0.65)    # the VarGrad recipe's
    fns = {
        "rollout_traj_noise": (lambda: evolve_overdamped_fused(
            *pos, CAIS, **kw, seed=seed, return_trajectory=True, return_noise=True), 20),
        "kl_sweep": (lambda: evolve_kl_bwd(traj, noise, cot, g_zf, *pos[2:], CAIS, **kw), 10),
        "kl_sweep_plain": (lambda: evolve_kl_bwd_plain(traj, noise, cot, g_zf, *pos[2:], CAIS,
                                                       **kw), 1),
        "reroll": (lambda: evolve_vargrad_bwd_reroll(vpos[0], cot, *vpos[2:], CAIS_VAR, **vkw,
                                                     seed=seed), 10),
        "reroll_plain": (lambda: evolve_vargrad_bwd_reroll_plain(
            vpos[0], cot, *vpos[2:], CAIS_VAR, **vkw, seed=7), 1),
    }
    times = {name: [] for name in fns}
    for name in ("kl_sweep_plain", "reroll_plain", "kl_sweep", "reroll", "rollout_traj_noise",
                 "rollout_traj_noise", "reroll", "kl_sweep", "reroll_plain", "kl_sweep_plain"):
        fn, reps = fns[name]
        times[name].append(_event_ms(fn, reps))
    print(f"[11 timing] kernels N=2000 K=256 emb130 ms {json.dumps(times)}", flush=True)

    # The re-rolling path's own shape, and what the kernel allocates there.
    big_z0 = 15.0 * torch.randn(REROLL_N, 2, generator=gen, device="cuda")
    big_w0 = torch.zeros(REROLL_N, device="cuda")
    big_cot = torch.randn(REROLL_N, generator=gen, device="cuda")
    big = {
        "rollout": lambda: evolve_overdamped_fused(big_z0, big_w0, *vpos[2:], CAIS_VAR, **vkw,
                                                   seed=seed),
        "reroll": lambda: evolve_vargrad_bwd_reroll(big_z0, big_cot, *vpos[2:], CAIS_VAR, **vkw,
                                                    seed=seed),
    }
    big_ms = {name: [_event_ms(fn, 2) for _ in range(2)] for name, fn in big.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    big["reroll"]()
    torch.cuda.synchronize()
    scratch = (torch.cuda.max_memory_allocated() - before) / 2**20
    print(f"[11 timing] kernels N={REROLL_N} K=256 emb130 ms {json.dumps(big_ms)}; one reroll "
          f"call allocates {scratch:.1f} MiB at its peak", flush=True)

    cfg, setup, target, params, ctx = flagship(KL_FLAGS + ["--config.iters", "0"])
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi, cfg.train_betas)
    fused = lambda p, n, c, s, generator: kl_bound_fused(p, n, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        g = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=0.005, iters=iters, batch_size=cfg.N,
                             generator=g, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=iters, nan_check_every=10**9)

    steps(fused, 5)()
    step_ms = {"eager": [], "kernel": []}
    for name in ("eager", "kernel", "kernel", "eager"):
        loss_fn, iters = (bounds.kl_bound, 1) if name == "eager" else (fused, 50)
        step_ms[name].append(_wall_ms(steps(loss_fn, iters)) / iters)
    print(f"[11 timing] KL optimizer step N=2000 K=256 ms per step {json.dumps(step_ms)} "
          f"(kernel: 50 steps, eager: 1 step per reading)", flush=True)
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    print(f"[11 profile] 10 fused KL steps: wall {prof_wall!r} ms under the profiler, device "
          f"busy {prof_dev!r} ms ({100 * prof_dev / prof_wall!r}%), per step busy "
          f"{prof_dev / 10!r} ms, device records [name, ms, count] {json.dumps(top)}; busy over "
          f"the fastest unprofiled step {100 * prof_dev / 10 / min(step_ms['kernel'])!r}%",
          flush=True)
    return {**times, **{f"{name}_big": ms for name, ms in big_ms.items()}}, step_ms

def make_ud_problem(n, k, emb_dim, spec, *, seed, sigma=3.0, eps=0.05, gamma=5.0, eta=0.5,
                    target="many_gmm"):
    """make_problem for an underdamped spec: a net on the spec's input ([z],
    [z, rho] or none), gamma and eta, noise (K + 1, N, dim)."""
    from cmcd_tpu_torch.ops.target_grads import KERNEL_DIMS
    from cmcd_tpu_torch.ops.underdamped import net_input_width

    case = make_problem(n, k, emb_dim, seed=seed, sigma=sigma, eps=eps,
                        din=net_input_width(spec, KERNEL_DIMS[target]), noise_rows=k + 1,
                        target=target)
    case["gamma"], case["eta"] = (torch.tensor(v, device="cuda") for v in (gamma, eta))
    return case


def _ud_split(case):
    """An underdamped problem as (the wrappers' positional arguments from z0
    to grad_logp, their keyword arguments, the injected noise)."""
    kw = dict(case)
    noise = kw.pop("noise")
    names = ("z0", "w0", "betas", "eps", "gamma", "eta", "vd_mean", "vd_logdiag", "grad_logp")
    return [kw.pop(a) for a in names], kw, noise


def compare_ud(case, spec, tol):
    """The underdamped rollout kernel against its plain version under the
    same injected noise: z, w and both stored paths (held as B1's path)."""
    from cmcd_tpu_torch.ops.underdamped import (
        evolve_underdamped_fused,
        evolve_underdamped_fused_plain,
    )

    pos, kw, noise = _ud_split(case)
    z_k, w_k, zt_k, rt_k, d_k = evolve_underdamped_fused(*pos, spec, **kw, noise=noise,
                                                         return_state=True)
    z_p, w_p, zt_p, rt_p, _ = evolve_underdamped_fused_plain(*pos, spec, **kw, noise=noise,
                                                             return_state=True)
    z_n, w_n = evolve_underdamped_fused(*pos, spec, **kw, noise=noise)
    torch.cuda.synchronize()
    dz, dw = (z_k - z_p).abs(), (w_k - w_p).abs()
    bad_z = dz > tol["z_atol"] + tol["z_rtol"] * z_p.abs()
    bad_w = dw > tol["w_atol"] + tol["w_rtol"] * w_p.abs()
    stats = {"z_max_abs": float(dz.max()), "w_max_abs": float(dw.max()),
             "w_max_rel": float((dw / w_p.abs().clamp_min(1e-6)).max()),
             "z_bad": int(bad_z.any(-1).sum()), "w_bad": int(bad_w.sum())}
    paths_ok = True
    for name, t_k, t_p in (("ztraj", zt_k, zt_p), ("rtraj", rt_k, rt_p)):
        dt = (t_k - t_p).abs()
        beyond = float((dt > tol["z_atol"] + tol["z_rtol"] * t_p.abs()).float().mean())
        stats[f"{name}_max_abs"] = float(dt.max())
        stats[f"{name}_share_beyond_z_tol"] = beyond
        paths_ok &= float(dt.max()) <= TRAJ_ATOL and beyond <= TRAJ_SHARE
    # Storing changes nothing else; the stores' ends are exact; injected
    # noise is handed on as it is.
    stats["stores_ok"] = paths_ok
    stats["ends_exact_outputs_unchanged_noise_handed_on"] = bool(
        torch.equal(z_n, z_k) and torch.equal(w_n, w_k) and d_k is noise
        and torch.equal(zt_k[0], pos[0]) and torch.equal(zt_k[-1], z_k)
        and torch.equal(rt_k[0], noise[0]))
    stats["finite"] = bool(torch.isfinite(z_k).all() and torch.isfinite(w_k).all())
    if spec.cais:  # the target score's elements past CAIS_UHA's clip along the path
        stats["clipped_score_elements"] = clipped_elements(pos[-1], zt_p)
    good = (not (stats["z_bad"] or stats["w_bad"]) and paths_ok and stats["finite"]
            and stats["ends_exact_outputs_unchanged_noise_handed_on"])
    return stats, good


def clipped_elements(score, ztraj):
    """How many elements of the target score at the stored positions lie past
    CAIS_UHA's clip (|gt| > 1e2): the clip and its VJP are only held to their
    plain versions where this is not 0."""
    from cmcd_tpu_torch.integrators.underdamped import CAIS_UHA_CLIP

    return int((score(ztraj.reshape(-1, ztraj.shape[-1])).abs() > CAIS_UHA_CLIP).sum())


def compare_ud_noise_stack(case, spec):
    """The underdamped rollout's noise stack is what the kernel used: its
    Philox draws (row 0 the initial momentum), injected again, give the same
    z, w and stores bit for bit."""
    from cmcd_tpu_torch.ops.underdamped import evolve_underdamped_fused

    pos, kw, _ = _ud_split(case)
    seed = torch.tensor([31], device="cuda")
    first = evolve_underdamped_fused(*pos, spec, **kw, seed=seed, return_state=True)
    again = evolve_underdamped_fused(*pos, spec, **kw, noise=first[4], return_state=True)
    torch.cuda.synchronize()
    draws = first[4]
    stats = {"same_bits": [bool(torch.equal(a, b)) for a, b in zip(first[:4], again[:4])],
             "mean": float(draws.mean()), "std": float(draws.std())}
    good = (all(stats["same_bits"]) and abs(stats["mean"]) < 0.01
            and abs(stats["std"] - 1.0) < 0.01)
    return stats, good


def compare_ud_sweep(case, spec, tol, arbitrate=False):
    """The underdamped KL sweep kernel against its plain version, from the
    plain rollout's stores and random cotangents: every gradient leaf and
    dL/dz0, with the plain version in float64 as arbiter if asked."""
    from cmcd_tpu_torch.ops.kl_underdamped import (
        evolve_kl_bwd_underdamped,
        evolve_kl_bwd_underdamped_plain,
    )
    from cmcd_tpu_torch.ops.underdamped import evolve_underdamped_fused_plain

    pos, kw, noise = _ud_split(case)
    _, _, zt, rt, dr = evolve_underdamped_fused_plain(*pos, spec, **kw, noise=noise,
                                                      return_state=True)
    gen = torch.Generator(device="cuda").manual_seed(19)
    n, dim = pos[0].shape
    cot = torch.randn(n, generator=gen, device="cuda")
    g_zf = torch.randn(n, dim, generator=gen, device="cuda")
    tree = lambda out: {**_flat(out[0]), "g_z0": out[1]}
    got = tree(evolve_kl_bwd_underdamped(zt, rt, dr, cot, g_zf, *pos[2:], spec, **kw))
    want = tree(evolve_kl_bwd_underdamped_plain(zt, rt, dr, cot, g_zf, *pos[2:], spec, **kw))
    torch.cuda.synchronize()
    worst, leaf, ok = _grad_errors(got, want, tol)
    line = f"worst relative error {worst:.3e} (leaf {leaf}), limit {tol}"
    if spec.cais:
        line += f", clipped score elements on the path {clipped_elements(pos[-1], zt)}"
    if arbitrate:
        ref = tree(evolve_kl_bwd_underdamped_plain(zt.double(), rt.double(), dr.double(), cot,
                                                   g_zf, *pos[2:], spec, **kw))
        ok, more = _arbitrate(got, want, ref, tol)
        line += more
    return worst, line, ok


def phase_ud_compare():
    from cmcd_tpu_torch.integrators import UNDERDAMPED

    ldvi = UNDERDAMPED["MCD_U_a-lp-sn"]
    ok, max_err, sweep_err = True, 0.0, 0.0
    for mode, spec in UNDERDAMPED.items():
        stats, good = compare_ud(make_ud_problem(256, 8, 16, spec, seed=0, sigma=8.0), spec,
                                 TOL_SMALL)
        ok &= good
        print(f"[12 compare] underdamped rollout small N=256 K=8 emb16 {mode}: "
              f"{json.dumps(stats)}", flush=True)
    for n, seed in ((2000, 1), (500, 5)):
        full = make_ud_problem(n, 256, 130, ldvi, seed=seed, sigma=15.0)
        stats, good = compare_ud(full, ldvi, TOL_FULL)
        ok &= good
        max_err = max(max_err, stats["z_max_abs"], stats["w_max_abs"], stats["ztraj_max_abs"],
                      stats["rtraj_max_abs"])
        print(f"[12 compare] underdamped rollout full N={n} K=256 emb130 LDVI: "
              f"{json.dumps(stats)} tol {json.dumps(TOL_FULL)}", flush=True)
    stats, good = compare_ud_noise_stack(make_ud_problem(2000, 256, 130, ldvi, seed=8,
                                                         sigma=15.0), ldvi)
    ok &= good
    print(f"[12 compare] underdamped noise stack N=2000 K=256 emb130 LDVI: {json.dumps(stats)}",
          flush=True)
    for mode in ("MCD_U_a-lp", "MCD_U_a-lp-sna", "MCD_U_a-lp-sn"):
        spec = UNDERDAMPED[mode]
        _, line, good = compare_ud_sweep(make_ud_problem(128, 6, 16, spec, seed=3, sigma=8.0),
                                         spec, GRAD_TOL_SMALL)
        ok &= good
        print(f"[12 compare] underdamped KL sweep small N=128 K=6 emb16 {mode}: {line}, "
              f"ok {good}", flush=True)
    for n, seed in ((2000, 6), (1001, 7)):
        worst, line, good = compare_ud_sweep(make_ud_problem(n, 256, 130, ldvi, seed=seed,
                                                             sigma=15.0),
                                             ldvi, GRAD_TOL_FULL, arbitrate=True)
        ok &= good
        sweep_err = max(sweep_err, worst)
        print(f"[12 compare] underdamped KL sweep full N={n} K=256 emb130 LDVI: {line}, "
              f"ok {good}", flush=True)
    ok &= compare_training_step(LDVI_FLAGS + ["--config.iters", "0"], "LDVI KL", arbitrate=True,
                                tag="12 compare")
    if not ok:
        fail("an underdamped kernel and its plain version disagree beyond tolerance")
    return max_err, sweep_err


def phase_ud_eval_path():
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.underdamped import evolve_underdamped_fused

    cfg = parse_flags(LDVI_FLAGS + ["--config.iters", "0"])
    evolve_underdamped_fused.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = evolve_underdamped_fused.launches
    print(f"[13 LDVI evaluation path] ELBO {out['final_elbo']!r} +- {out['final_elbo_std']!r} "
          f"ln Z {out['final_ln_Z']!r} +- {out['final_ln_Z_std']!r} launches {launches} "
          f"wall {wall:.3f} s", flush=True)
    if launches != cfg.n_input_dist_seeds:
        fail(f"LDVI evaluation launched the underdamped rollout {launches} times, expected "
             f"{cfg.n_input_dist_seeds}")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("LDVI evaluation ELBO / ln Z not finite")
    if out["neg_elbos"].shape != (30, 500) or not np.isfinite(out["samples"]).all():
        fail("LDVI evaluation output malformed")
    return launches, out


def phase_ud_training_path(init):
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd
    from cmcd_tpu_torch.ops.kl_underdamped import evolve_kl_bwd_underdamped
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
    from cmcd_tpu_torch.ops.underdamped import evolve_underdamped_fused

    cfg = parse_flags(LDVI_FLAGS + ["--config.iters", str(TRAIN_ITERS)])
    counters = (evolve_underdamped_fused, evolve_kl_bwd_underdamped, evolve_overdamped_fused,
                evolve_kl_bwd)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, od_fwd, od_bwd = (fn.launches for fn in counters)
    result = out["train"]
    losses = result.losses.double()
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    print(f"[14 LDVI KL training path] {cfg.iters} steps N={cfg.N} K={cfg.nbridges} "
          f"{cfg.boundmode}: underdamped rollout launches {fwd} underdamped sweep launches {bwd} "
          f"(overdamped kernels {od_fwd + od_bwd}) wall {wall:.3f} s "
          f"({1e3 * wall / cfg.iters:.3f} ms per step, evaluation and init included) | loss "
          f"mean first 100 {first!r} last 100 {last!r} | ELBO {init['final_elbo']!r} -> "
          f"{out['final_elbo']!r} +- {out['final_elbo_std']!r} ln Z {init['final_ln_Z']!r} -> "
          f"{out['final_ln_Z']!r} +- {out['final_ln_Z_std']!r} diverged {result.diverged} "
          f"steps_done {result.steps_done}", flush=True)
    if fwd != cfg.iters + cfg.n_input_dist_seeds or bwd != cfg.iters or od_fwd or od_bwd:
        fail(f"LDVI training path launched the underdamped rollout {fwd}, its sweep {bwd}, "
             f"overdamped kernels {od_fwd + od_bwd} times, expected "
             f"{cfg.iters + cfg.n_input_dist_seeds}, {cfg.iters}, 0")
    if len(losses) != cfg.iters or bool(torch.isnan(losses).any()):
        fail(f"LDVI training path logged {len(losses)} losses, NaN among them: "
             f"{bool(torch.isnan(losses).any())}")
    if result.diverged or result.steps_done != cfg.iters:
        fail("LDVI training path diverged")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("LDVI training path ELBO / ln Z not finite")
    if not out["final_elbo"] > init["final_elbo"]:
        fail(f"LDVI training did not raise the ELBO: {init['final_elbo']} -> {out['final_elbo']}")
    if out["neg_elbos"].shape != (30, 500) or not np.isfinite(out["samples"]).all():
        fail("LDVI training path evaluation output malformed")
    return fwd, bwd


def _work_ud(n, k, in_dim, target="many_gmm", dim=2, din=4, fwd_net=False):
    """Least time the card could take for one call of each underdamped
    kernel at these shapes (the rule of _work) for a target of dimension
    dim: (rollout without stores, rollout with stores, sweep). in_dim: the
    net on din input columns (0: no net); fwd_net: CAIS_UHA's second apply
    a step at [z, rho] (and its VJP in the sweep)."""
    score, hvp, n_par = TARGET_WORK[target]
    nets = (2 if fwd_net else 1) if in_dim else 0
    net_apply = in_dim * in_dim + (din + dim) * in_dim   # FMAs: layer 2, layer 1's x part, head
    steps = k * n
    weights = 4 * (din * in_dim + k * in_dim + k * (in_dim - din) + in_dim * in_dim
                   + (2 + dim) * in_dim + dim) if in_dim else 0
    fwd_flops = 2 * steps * (nets * net_apply + score + 12 * dim) + 2 * n * score
    fwd_bytes = 4 * ((dim + 1) * n + k + n_par + 2 * dim) + weights + 4 * ((dim + 1) * n)
    stores = 3 * 4 * dim * (k + 1) * n                    # z, rho and draws
    # The sweep: per step and net the apply, W2 g_a2 and the dW2 outer
    # product; per point the score and its Hessian product. Reads the three
    # stacks, cot and g_zfinal; writes dL/dz0 and the per-block and per-point
    # sums.
    bwd_flops = (2 * steps * nets * (3 * in_dim * in_dim + (2 * din + 2 * dim) * in_dim)
                 + 2 * (k + 1) * n * (score + hvp + 30 * dim))
    sums = 4 * (in_dim * in_dim + (1 + dim + din) * in_dim + 3 + 3 * dim
                + (k + 1) * (2 * in_dim + 2)) if in_dim else 4 * (3 + 2 * dim + 2 * (k + 1))
    bwd_bytes = stores + 4 * (2 * n + k + n_par + 2 * dim) + weights + 8 * dim * n + sums
    return (_bound(fwd_flops, fwd_bytes), _bound(fwd_flops, fwd_bytes + stores),
            _bound(bwd_flops, bwd_bytes))


def phase_ud_timing():
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators import UNDERDAMPED
    from cmcd_tpu_torch.ops.fused_train import kl_bound_fused
    from cmcd_tpu_torch.ops.kl_underdamped import (
        evolve_kl_bwd_underdamped,
        evolve_kl_bwd_underdamped_plain,
    )
    from cmcd_tpu_torch.ops.underdamped import (
        evolve_underdamped_fused,
        evolve_underdamped_fused_plain,
    )
    from cmcd_tpu_torch.train import train

    ldvi = UNDERDAMPED["MCD_U_a-lp-sn"]
    seed = torch.tensor([7], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.randn(2000, generator=gen, device="cuda")
    g_zf = torch.randn(2000, 2, generator=gen, device="cuda")
    pos, kw, _ = _ud_split(make_ud_problem(2000, 256, 130, ldvi, seed=2, sigma=15.0))
    pos5, kw5, _ = _ud_split(make_ud_problem(500, 256, 130, ldvi, seed=3, sigma=15.0))
    _, _, zt, rt, dr = evolve_underdamped_fused(*pos, ldvi, **kw, seed=seed, return_state=True)
    fns = {
        "rollout": (lambda: evolve_underdamped_fused(*pos, ldvi, **kw, seed=seed), 20),
        "rollout_stores": (lambda: evolve_underdamped_fused(*pos, ldvi, **kw, seed=seed,
                                                            return_state=True), 20),
        "rollout_n500": (lambda: evolve_underdamped_fused(*pos5, ldvi, **kw5, seed=seed), 20),
        "rollout_stores_plain": (lambda: evolve_underdamped_fused_plain(
            *pos, ldvi, **kw, seed=7, return_state=True), 2),
        "sweep": (lambda: evolve_kl_bwd_underdamped(zt, rt, dr, cot, g_zf, *pos[2:], ldvi, **kw),
                  10),
        "sweep_plain": (lambda: evolve_kl_bwd_underdamped_plain(zt, rt, dr, cot, g_zf, *pos[2:],
                                                                ldvi, **kw), 1),
    }
    times = {name: [] for name in fns}
    for name in ("rollout_stores_plain", "sweep_plain", "rollout", "rollout_stores",
                 "rollout_n500", "sweep", "sweep", "rollout_n500", "rollout_stores", "rollout",
                 "sweep_plain", "rollout_stores_plain"):
        fn, reps = fns[name]
        times[name].append(_event_ms(fn, reps))
    print(f"[15 timing] underdamped kernels N=2000 K=256 emb130 (N=500 where named) ms "
          f"{json.dumps(times)}", flush=True)

    cfg, setup, target, params, ctx = flagship(LDVI_FLAGS + ["--config.iters", "0"])
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi, cfg.train_betas)
    fused = lambda p, n, c, s, generator: kl_bound_fused(p, n, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        g = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=0.005, iters=iters, batch_size=cfg.N,
                             generator=g, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=iters, nan_check_every=10**9)

    steps(fused, 5)()
    step_ms = {"eager": [], "kernel": []}
    for name in ("eager", "kernel", "kernel", "eager"):
        loss_fn, iters = (bounds.kl_bound, 1) if name == "eager" else (fused, 50)
        step_ms[name].append(_wall_ms(steps(loss_fn, iters)) / iters)
    print(f"[15 timing] LDVI optimizer step N=2000 K=256 ms per step {json.dumps(step_ms)} "
          f"(kernel: 50 steps, eager: 1 step per reading)", flush=True)
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    print(f"[15 profile] 10 fused LDVI steps: wall {prof_wall!r} ms under the profiler, device "
          f"busy {prof_dev!r} ms ({100 * prof_dev / prof_wall!r}%), per step busy "
          f"{prof_dev / 10!r} ms, device records [name, ms, count] {json.dumps(top)}; busy over "
          f"the fastest unprofiled step {100 * prof_dev / 10 / min(step_ms['kernel'])!r}%",
          flush=True)
    return times, step_ms


def make_uha_problem(n, k, target_name, *, seed, sigma=3.0, eps=0.05, eta=0.5, lfsteps=1):
    """Inputs of the UHA kernels from a numpy seed: z0, non-uniform betas, eps,
    eta, a momentum log-scale md away from zero, vd params, the target's score
    and noise (K + 1, N, dim)."""
    from cmcd_tpu_torch.ops.target_grads import KERNEL_DIMS, score_for_target
    from cmcd_tpu_torch.schedules import betas_from_grid, make_beta_grid_params
    from cmcd_tpu_torch.targets import load_target

    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mg, gx, tx = make_beta_grid_params(k, device=dev)
    mg = f32(rng.uniform(0.5, 1.5, mg.shape[0]))
    dim = KERNEL_DIMS[target_name]
    return dict(
        z0=f32(sigma * rng.standard_normal((n, dim))),
        betas=betas_from_grid(mg, gx, tx).contiguous(),
        eps=f32(eps),
        eta=f32(eta),
        md=f32([(0.1, -0.2)[d % 2] for d in range(dim)]),
        vd_mean=f32([0.5 * (-1) ** d for d in range(dim)]),
        vd_logdiag=f32([math.log(sigma)] * dim),
        grad_logp=score_for_target(load_target(target_name, device=dev), dev),
        noise=f32(rng.standard_normal((k + 1, n, dim))),
        dim=dim,
        nbridges=k,
        lfsteps=lfsteps,
    )


def _uha_split(case):
    """A UHA problem as (the wrappers' positional arguments from z0 to
    grad_logp, their keyword arguments, the injected noise)."""
    kw = dict(case)
    noise = kw.pop("noise")
    names = ("z0", "betas", "eps", "eta", "md", "vd_mean", "vd_logdiag", "grad_logp")
    return [kw.pop(a) for a in names], kw, noise


def compare_uha(case, tol):
    """The UHA rollout kernel against its plain version under the same
    injected noise: z, w and both stored paths (held as B1's path)."""
    from cmcd_tpu_torch.ops.uha import evolve_uha_fused, evolve_uha_fused_plain

    pos, kw, noise = _uha_split(case)
    z_k, w_k, zt_k, rt_k, d_k = evolve_uha_fused(*pos, **kw, noise=noise, return_state=True)
    z_p, w_p, zt_p, rt_p, _ = evolve_uha_fused_plain(*pos, **kw, noise=noise, return_state=True)
    z_n, w_n = evolve_uha_fused(*pos, **kw, noise=noise)
    torch.cuda.synchronize()
    dz, dw = (z_k - z_p).abs(), (w_k - w_p).abs()
    bad_z = dz > tol["z_atol"] + tol["z_rtol"] * z_p.abs()
    bad_w = dw > tol["w_atol"] + tol["w_rtol"] * w_p.abs()
    stats = {"z_max_abs": float(dz.max()), "w_max_abs": float(dw.max()),
             "w_max_rel": float((dw / w_p.abs().clamp_min(1e-6)).max()),
             "w_abs_max": float(w_p.abs().max()),
             "z_bad": int(bad_z.any(-1).sum()), "w_bad": int(bad_w.sum())}
    paths_ok = True
    for name, t_k, t_p in (("ztraj", zt_k, zt_p), ("rtraj", rt_k, rt_p)):
        dt = (t_k - t_p).abs()
        beyond = float((dt > tol["z_atol"] + tol["z_rtol"] * t_p.abs()).float().mean())
        stats[f"{name}_max_abs"] = float(dt.max())
        stats[f"{name}_share_beyond_z_tol"] = beyond
        paths_ok &= float(dt.max()) <= TRAJ_ATOL and beyond <= TRAJ_SHARE
    # Storing changes nothing else; the stores' ends are exact; injected
    # noise is handed on as it is.
    stats["stores_ok"] = paths_ok
    stats["ends_exact_outputs_unchanged_noise_handed_on"] = bool(
        torch.equal(z_n, z_k) and torch.equal(w_n, w_k) and d_k is noise
        and torch.equal(zt_k[0], pos[0]) and torch.equal(zt_k[-1], z_k))
    stats["finite"] = bool(torch.isfinite(z_k).all() and torch.isfinite(w_k).all())
    good = (not (stats["z_bad"] or stats["w_bad"]) and paths_ok and stats["finite"]
            and stats["ends_exact_outputs_unchanged_noise_handed_on"])
    return stats, good


def compare_uha_noise_stack(case):
    """The UHA rollout's noise stack is what the kernel used: its Philox draws
    (row 0 the initial momentum's), injected again, give the same z, w and
    stores bit for bit."""
    from cmcd_tpu_torch.ops.uha import evolve_uha_fused

    pos, kw, _ = _uha_split(case)
    seed = torch.tensor([37], device="cuda")
    first = evolve_uha_fused(*pos, **kw, seed=seed, return_state=True)
    again = evolve_uha_fused(*pos, **kw, noise=first[4], return_state=True)
    torch.cuda.synchronize()
    draws = first[4]
    stats = {"same_bits": [bool(torch.equal(a, b)) for a, b in zip(first[:4], again[:4])],
             "mean": float(draws.mean()), "std": float(draws.std())}
    good = (all(stats["same_bits"]) and abs(stats["mean"]) < 0.01
            and abs(stats["std"] - 1.0) < 0.01)
    return stats, good


def compare_uha_sweep(case, tol, arbitrate=False):
    """The UHA sweep kernel against its plain version, from the plain
    rollout's stores and random cotangents: every gradient leaf and dL/dz0,
    with the plain version in float64 as arbiter if asked."""
    from cmcd_tpu_torch.ops.kl_uha import evolve_kl_bwd_uha, evolve_kl_bwd_uha_plain
    from cmcd_tpu_torch.ops.uha import evolve_uha_fused_plain

    pos, kw, noise = _uha_split(case)
    _, _, zt, rt, dr = evolve_uha_fused_plain(*pos, **kw, noise=noise, return_state=True)
    gen = torch.Generator(device="cuda").manual_seed(29)
    n, dim = pos[0].shape
    cot = torch.randn(n, generator=gen, device="cuda")
    g_zf = torch.randn(n, dim, generator=gen, device="cuda")
    tree = lambda out: {**out[0], "g_z0": out[1]}
    got = tree(evolve_kl_bwd_uha(zt, rt, dr, cot, g_zf, *pos[1:], **kw))
    want = tree(evolve_kl_bwd_uha_plain(zt, rt, dr, cot, g_zf, *pos[1:], **kw))
    torch.cuda.synchronize()
    worst, leaf, ok = _grad_errors(got, want, tol)
    line = f"worst relative error {worst:.3e} (leaf {leaf}), limit {tol}"
    if arbitrate:
        ref = tree(evolve_kl_bwd_uha_plain(zt.double(), rt.double(), dr.double(), cot, g_zf,
                                           *pos[1:], **kw))
        ok, more = _arbitrate(got, want, ref, tol)
        line += more
    return worst, line, ok


def phase_uha_compare():
    ok, max_err, sweep_err = True, 0.0, 0.0
    for name, sigma in (("many_gmm", 8.0), ("gmm", 3.0)):
        for lf in (1, 3):
            stats, good = compare_uha(make_uha_problem(256, 8, name, seed=0, sigma=sigma,
                                                       lfsteps=lf), TOL_SMALL)
            ok &= good
            print(f"[16 compare] UHA rollout small N=256 K=8 {name} lfsteps {lf}: "
                  f"{json.dumps(stats)}", flush=True)
            _, line, good = compare_uha_sweep(make_uha_problem(256, 8, name, seed=3, sigma=sigma,
                                                               lfsteps=lf), GRAD_TOL_SMALL)
            ok &= good
            print(f"[16 compare] UHA sweep small N=256 K=8 {name} lfsteps {lf}: {line}, ok {good}",
                  flush=True)
    for n, seed in ((2000, 1), (500, 5)):
        stats, good = compare_uha(make_uha_problem(n, 256, "many_gmm", seed=seed, sigma=15.0),
                                  TOL_FULL)
        ok &= good
        max_err = max(max_err, stats["z_max_abs"], stats["w_max_abs"], stats["ztraj_max_abs"],
                      stats["rtraj_max_abs"])
        print(f"[16 compare] UHA rollout full N={n} K=256 many_gmm: {json.dumps(stats)} "
              f"tol {json.dumps(TOL_FULL)}", flush=True)
        worst, line, good = compare_uha_sweep(
            make_uha_problem(n, 256, "many_gmm", seed=seed + 1, sigma=15.0), GRAD_TOL_FULL,
            arbitrate=True)
        ok &= good
        sweep_err = max(sweep_err, worst)
        print(f"[16 compare] UHA sweep full N={n} K=256 many_gmm: {line}, ok {good}", flush=True)
    stats, good = compare_uha_noise_stack(make_uha_problem(2000, 256, "many_gmm", seed=8,
                                                           sigma=15.0))
    ok &= good
    print(f"[16 compare] UHA noise stack N=2000 K=256 many_gmm: {json.dumps(stats)}", flush=True)
    ok &= compare_training_step(UHA_FLAGS + ["--config.iters", "0"], "UHA KL", arbitrate=True,
                                tag="16 compare")
    if not ok:
        fail("a UHA kernel and its plain version disagree beyond tolerance")
    return max_err, sweep_err


def phase_uha_eval_path():
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.uha import MAX_LFSTEPS, evolve_uha_fused

    cfg = parse_flags(UHA_FLAGS + ["--config.iters", "0"])
    evolve_uha_fused.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = evolve_uha_fused.launches
    print(f"[17 UHA evaluation path] ELBO {out['final_elbo']!r} +- {out['final_elbo_std']!r} "
          f"ln Z {out['final_ln_Z']!r} +- {out['final_ln_Z_std']!r} launches {launches} "
          f"wall {wall:.3f} s", flush=True)
    if launches != cfg.n_input_dist_seeds:
        fail(f"UHA evaluation launched the UHA rollout {launches} times, expected "
             f"{cfg.n_input_dist_seeds}")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("UHA evaluation ELBO / ln Z not finite")
    if out["neg_elbos"].shape != (30, 500) or not np.isfinite(out["samples"]).all():
        fail("UHA evaluation output malformed")
    # What no kernel covers raises on the card instead of running eagerly: a
    # leapfrog longer than the kernels take.
    for extra in (["--config.lfsteps", str(MAX_LFSTEPS + 1)],):
        try:
            run_experiment(parse_flags(UHA_FLAGS + ["--config.iters", "0"] + extra))
        except NotImplementedError as err:
            print(f"[17 UHA evaluation path] {' '.join(extra)}: refused ({err})", flush=True)
        else:
            fail(f"UHA with {' '.join(extra)} ran on the card without a kernel")
    if evolve_uha_fused.launches != launches:
        fail("a refused UHA configuration launched the UHA rollout")
    return launches, out


def phase_uha_training_path(init):
    from cmcd_tpu_torch.main import parse_flags, run_experiment
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd
    from cmcd_tpu_torch.ops.kl_uha import evolve_kl_bwd_uha
    from cmcd_tpu_torch.ops.kl_underdamped import evolve_kl_bwd_underdamped
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused
    from cmcd_tpu_torch.ops.uha import evolve_uha_fused
    from cmcd_tpu_torch.ops.underdamped import evolve_underdamped_fused
    from cmcd_tpu_torch.ops.vargrad import evolve_vargrad_bwd_replay, evolve_vargrad_bwd_reroll

    cfg = parse_flags(UHA_FLAGS + ["--config.iters", str(TRAIN_ITERS)])
    counters = (evolve_uha_fused, evolve_kl_bwd_uha)
    others = (evolve_overdamped_fused, evolve_vargrad_bwd_replay, evolve_vargrad_bwd_reroll,
              evolve_kl_bwd, evolve_underdamped_fused, evolve_kl_bwd_underdamped)
    for fn in counters + others:
        fn.launches = 0
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = (fn.launches for fn in counters)
    other = sum(fn.launches for fn in others)
    result = out["train"]
    losses = result.losses.double()
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    eps, eta = (float(result.params["train"][k]) for k in ("eps", "eta"))
    print(f"[18 UHA KL training path] {cfg.iters} steps N={cfg.N} K={cfg.nbridges} "
          f"lfsteps {cfg.lfsteps}: UHA rollout launches {fwd} UHA sweep launches {bwd} (other "
          f"kernels {other}) wall {wall:.3f} s ({1e3 * wall / cfg.iters:.3f} ms per step, "
          f"evaluation and init included) | loss mean first 100 {first!r} last 100 {last!r} | "
          f"eps {eps!r} eta {eta!r} | ELBO {init['final_elbo']!r} -> {out['final_elbo']!r} +- "
          f"{out['final_elbo_std']!r} ln Z {init['final_ln_Z']!r} -> {out['final_ln_Z']!r} +- "
          f"{out['final_ln_Z_std']!r} diverged {result.diverged} steps_done "
          f"{result.steps_done}", flush=True)
    if fwd != cfg.iters + cfg.n_input_dist_seeds or bwd != cfg.iters or other:
        fail(f"UHA training path launched the UHA rollout {fwd}, its sweep {bwd}, other kernels "
             f"{other} times, expected {cfg.iters + cfg.n_input_dist_seeds}, {cfg.iters}, 0")
    if len(losses) != cfg.iters or bool(torch.isnan(losses).any()):
        fail(f"UHA training path logged {len(losses)} losses, NaN among them: "
             f"{bool(torch.isnan(losses).any())}")
    if result.diverged or result.steps_done != cfg.iters:
        fail("UHA training path diverged")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail("UHA training path ELBO / ln Z not finite")
    if not out["final_elbo"] > init["final_elbo"]:
        fail(f"UHA training did not raise the ELBO: {init['final_elbo']} -> {out['final_elbo']}")
    if out["neg_elbos"].shape != (30, 500) or not np.isfinite(out["samples"]).all():
        fail("UHA training path evaluation output malformed")
    return fwd, bwd


def _work_uha(n, k, lfsteps=1, target="many_gmm", dim=2):
    """Least time the card could take for one call of each UHA kernel at
    these shapes (the rule of _work) for a target of dimension dim: (rollout
    without stores, rollout with stores, sweep)."""
    score, hvp, n_par = TARGET_WORK[target]   # FMAs per score, per Hessian product
    state = 6 * dim                           # FMAs per bridge: refresh, kicks, drifts, weight
    fwd_flops = 2 * n * (k * (lfsteps * score + lfsteps * state) + score)
    fwd_bytes = 4 * ((dim + 1) * n + k + 2 + 3 * dim + n_par) + 4 * ((dim + 1) * n)
    stores = 3 * 4 * dim * (k + 1) * n        # z, rho and draws
    # The sweep: per bridge 2 L - 1 scores and L Hessian products, per point
    # the score again; reads the three stacks, cot and g_zfinal; writes
    # dL/dz0 and the sums.
    bwd_flops = 2 * n * (k * ((2 * lfsteps - 1) * score + lfsteps * hvp + 20 * dim) + score
                         + hvp)
    bwd_bytes = (stores + 4 * ((dim + 1) * n + k + 2 + 3 * dim + n_par) + 4 * dim * n
                 + 4 * (2 + 3 * dim + k))
    return (_bound(fwd_flops, fwd_bytes), _bound(fwd_flops, fwd_bytes + stores),
            _bound(bwd_flops, bwd_bytes))


def phase_uha_timing():
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.ops.fused_train import kl_bound_fused
    from cmcd_tpu_torch.ops.kl_uha import evolve_kl_bwd_uha, evolve_kl_bwd_uha_plain
    from cmcd_tpu_torch.ops.uha import evolve_uha_fused, evolve_uha_fused_plain
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.randn(2000, generator=gen, device="cuda")
    g_zf = torch.randn(2000, 2, generator=gen, device="cuda")
    pos, kw, _ = _uha_split(make_uha_problem(2000, 256, "many_gmm", seed=2, sigma=15.0))
    pos5, kw5, _ = _uha_split(make_uha_problem(500, 256, "many_gmm", seed=3, sigma=15.0))
    _, _, zt, rt, dr = evolve_uha_fused(*pos, **kw, seed=seed, return_state=True)
    fns = {
        "rollout": (lambda: evolve_uha_fused(*pos, **kw, seed=seed), 50),
        "rollout_stores": (lambda: evolve_uha_fused(*pos, **kw, seed=seed, return_state=True),
                           50),
        "rollout_n500": (lambda: evolve_uha_fused(*pos5, **kw5, seed=seed), 50),
        "rollout_stores_plain": (lambda: evolve_uha_fused_plain(*pos, **kw, seed=7,
                                                                return_state=True), 2),
        "sweep": (lambda: evolve_kl_bwd_uha(zt, rt, dr, cot, g_zf, *pos[1:], **kw), 20),
        "sweep_plain": (lambda: evolve_kl_bwd_uha_plain(zt, rt, dr, cot, g_zf, *pos[1:], **kw),
                        1),
    }
    times = {name: [] for name in fns}
    for name in ("rollout_stores_plain", "sweep_plain", "rollout", "rollout_stores",
                 "rollout_n500", "sweep", "sweep", "rollout_n500", "rollout_stores", "rollout",
                 "sweep_plain", "rollout_stores_plain"):
        fn, reps = fns[name]
        times[name].append(_event_ms(fn, reps))
    print(f"[19 timing] UHA kernels N=2000 K=256 lfsteps 1 many_gmm (N=500 where named) ms "
          f"{json.dumps(times)}", flush=True)

    cfg, setup, target, params, ctx = flagship(UHA_FLAGS + ["--config.iters", "0"])
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi, cfg.train_betas)
    fused = lambda p, n, c, s, generator: kl_bound_fused(p, n, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        g = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=0.005, iters=iters, batch_size=cfg.N,
                             generator=g, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=iters, nan_check_every=10**9)

    steps(fused, 5)()
    step_ms = {"eager": [], "kernel": []}
    for name in ("eager", "kernel", "kernel", "eager"):
        loss_fn, iters = (bounds.kl_bound, 1) if name == "eager" else (fused, 50)
        step_ms[name].append(_wall_ms(steps(loss_fn, iters)) / iters)
    print(f"[19 timing] UHA optimizer step N=2000 K=256 ms per step {json.dumps(step_ms)} "
          f"(kernel: 50 steps, eager: 1 step per reading)", flush=True)
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    print(f"[19 profile] 10 fused UHA steps: wall {prof_wall!r} ms under the profiler, device "
          f"busy {prof_dev!r} ms ({100 * prof_dev / prof_wall!r}%), per step busy "
          f"{prof_dev / 10!r} ms, device records [name, ms, count] {json.dumps(top)}; busy over "
          f"the fastest unprofiled step {100 * prof_dev / 10 / min(step_ms['kernel'])!r}%",
          flush=True)
    return times, step_ms


# The overdamped forms of this slice: the 3-mode gmm recipes
# (experiments/recipes.py: gmm_cais, gmm_cais_tuned, gmm_ula) and ULA / ULA_sn
# on many_gmm at the flagship's width.
GMM_CAIS_FLAGS = (
    "--config.model gmm --config.boundmode MCD_CAIS_sn --config.N 300 --config.nbridges 8 "
    "--config.emb_dim 20 --config.init_eps 0.01 --config.init_sigma 1 --config.train_vi True "
    "--config.train_eps False --config.lr 0.001 --noconfig.pretrain_mfvi --config.n_samples 500 "
    "--config.n_input_dist_seeds 30 --config.log.every 1"
).split()
GMM_CAIS_TUNED_FLAGS = GMM_CAIS_FLAGS + (
    "--config.nbridges 256 --config.init_eps 0.00125 --config.eps_schedule cos_sq").split()
GMM_ULA_FLAGS = (
    "--config.model gmm --config.boundmode MCD_ULA --config.N 300 --config.nbridges 8 "
    "--config.init_eps 0.05 --config.init_sigma 3 --config.lr 0.01 --noconfig.pretrain_mfvi "
    "--config.n_samples 500 --config.n_input_dist_seeds 30 --config.log.every 1"
).split()
# ULA_sn and ULA at the KL recipe's width and step size (KL_FLAGS' mode swapped).
ULA_SN_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_ULA_sn" for f in KL_FLAGS]
ULA_MG_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_ULA" for f in KL_FLAGS]
# The VarGrad kernels' gmm forms: the gmm CAIS recipe's shape in VarGrad, and
# at REROLL_N chains and K=256, where "auto" takes the re-rolling backward.
GMM_VAR_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_CAIS_var_sn" for f in GMM_CAIS_FLAGS]
# The gmm paths: 700 steps (2000 until the PIS phases, 1000 until the logreg
# phases 38-40).
OD_PATH_ITERS, OD_WIDE_ITERS = 700, 200


def _od_wrappers():
    """Every kernel wrapper of the port, for the launch counts of a path."""
    from cmcd_tpu_torch.ops import (
        kl,
        kl_split,
        kl_uha,
        kl_underdamped,
        overdamped,
        overdamped_wide,
        uha,
        underdamped,
        vargrad,
    )

    return (overdamped.evolve_overdamped_fused, kl.evolve_kl_bwd,
            vargrad.evolve_vargrad_bwd_replay, vargrad.evolve_vargrad_bwd_reroll,
            underdamped.evolve_underdamped_fused, kl_underdamped.evolve_kl_bwd_underdamped,
            uha.evolve_uha_fused, kl_uha.evolve_kl_bwd_uha,
            overdamped_wide.evolve_overdamped_wide, kl_split.evolve_kl_split)


def _reset_launches():
    for fn in _od_wrappers():
        fn.launches = 0
        if hasattr(fn, "form_launches"):
            fn.form_launches = {}


def _launch_table():
    """{wrapper name: (launches, {form: launches})} of every wrapper with a launch."""
    return {fn.__name__: (fn.launches, dict(getattr(fn, "form_launches", {})))
            for fn in _od_wrappers() if fn.launches}


def phase_od_compare():
    """The overdamped kernels' new forms against their plain versions (phase 20)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR, ULA, ULA_SN
    from cmcd_tpu_torch.ops.vargrad import sweep_grid

    ok, errors = True, {}

    def keep(key, value, n=None):
        """The worst error of a form on a target; with n, also under the
        instance sweep_grid takes at n chains (key/NG=groups)."""
        keys = [key] + ([f"{key}/NG={sweep_grid(n, 'cuda')[0]}"] if n else [])
        for k in keys:
            errors[k] = max(errors.get(k, 0.0), value)

    specs = (("CAIS", CAIS), ("CAIS_VAR", CAIS_VAR), ("ULA", ULA), ("ULA_sn", ULA_SN))
    for target in ("many_gmm", "gmm"):
        sigma = 8.0 if target == "many_gmm" else 3.0
        for name, spec in specs:
            case = make_problem(256, 8, 16, seed=0, sigma=sigma, target=target)
            stats, good = compare(case, spec, TOL_SMALL, grad_clipping=True)
            ok &= good
            keep(f"rollout {name}/{target}", max(stats["z_max_abs"], stats["w_max_abs"]))
            print(f"[20 compare] rollout small N=256 K=8 emb16 {name} {target}: "
                  f"{json.dumps(stats)}", flush=True)
            stats, good = compare_noise_stack(case, spec, grad_clipping=True)
            ok &= good
            print(f"[20 compare] rollout noise stack N=256 K=8 {name} {target}: "
                  f"{json.dumps(stats)}", flush=True)
        for name, spec in (("CAIS", CAIS), ("ULA", ULA), ("ULA_sn", ULA_SN)):
            for sched, clip in (("", True), ("cos_sq", False), ("linear", True)):
                # Float64 is reported for every case; it arbitrates only the
                # eps leaf of gmm under cos_sq, whose terms cancel (PERF.md §2).
                arbiter = ("eps",) if (target, sched) == ("gmm", "cos_sq") else ()
                worst, line, good = compare_sweep(
                    make_problem(128, 6, 16, seed=3, sigma=sigma, target=target),
                    GRAD_TOL_SMALL, arbitrate=arbiter, spec=spec, grad_clipping=clip,
                    eps_schedule=sched)
                ok &= good
                keep(f"sweep {name}/{target}", worst)
                print(f"[20 compare] KL sweep small N=128 K=6 emb16 {name} {target} "
                      f"{sched or 'constant'} clip {clip}: {line}, ok {good}", flush=True)
    # The VarGrad kernels' gmm instances.
    for sched in ("", "cos_sq"):
        case = make_problem(250, 8, 16, seed=3, target="gmm")
        worst, leaf, good = compare_backward(case, GRAD_TOL_SMALL, grad_clipping=True,
                                             eps_schedule=sched)
        ok &= good
        keep("replay/gmm", worst)
        print(f"[20 compare] backward small N=250 K=8 emb16 gmm {sched or 'constant'}: worst "
              f"relative error {worst:.3e} (leaf {leaf}), limit {GRAD_TOL_SMALL}, ok {good}",
              flush=True)
        worst, leaf, good = compare_reroll(case, GRAD_TOL_SMALL, grad_clipping=True,
                                           eps_schedule=sched)
        ok &= good
        keep("reroll/gmm", worst)
        print(f"[20 compare] reroll small N=250 K=8 emb16 gmm {sched or 'constant'}: worst "
              f"relative error {worst:.3e} (leaf {leaf}), limit {GRAD_TOL_SMALL}, ok {good}",
              flush=True)
        worst, leaf, good = compare_reroll_with_replay(case, grad_clipping=True,
                                                       eps_schedule=sched)
        ok &= good
        print(f"[20 compare] reroll small N=250 K=8 emb16 gmm (seed, vs the replay kernel): "
              f"worst relative error {worst:.3e} (leaf {leaf}), limit {REROLL_VS_REPLAY_TOL}, "
              f"ok {good}", flush=True)
    # Full width: ULA and ULA_sn on many_gmm at the KL recipe's step size, and
    # the gmm CAIS recipes' shapes (K=8 and the tuned K=256 with cos_sq).
    wide = [("ULA", ULA, "many_gmm", 2000, 256, 130, 0.1, 15.0, ""),
            ("ULA", ULA, "many_gmm", 500, 256, 130, 0.1, 15.0, ""),
            ("ULA_sn", ULA_SN, "many_gmm", 2000, 256, 130, 0.1, 15.0, ""),
            ("ULA_sn", ULA_SN, "many_gmm", 500, 256, 130, 0.1, 15.0, ""),
            ("CAIS", CAIS, "gmm", 300, 256, 20, 0.00125, 1.0, "cos_sq"),
            ("CAIS", CAIS, "gmm", 500, 256, 20, 0.00125, 1.0, "cos_sq"),
            ("CAIS", CAIS, "gmm", 300, 8, 20, 0.01, 1.0, "")]
    for i, (name, spec, target, n, k, emb, eps, sigma, sched) in enumerate(wide):
        case = make_problem(n, k, emb, seed=30 + i, sigma=sigma, eps=eps, target=target)
        stats, good = compare(case, spec, TOL_FULL, grad_clipping=True, eps_schedule=sched)
        ok &= good
        keep(f"rollout {name}/{target}", max(stats["z_max_abs"], stats["w_max_abs"]))
        print(f"[20 compare] rollout full N={n} K={k} emb{emb} {name} {target} "
              f"{sched or 'constant'} eps {eps}: {json.dumps(stats)} tol {json.dumps(TOL_FULL)}",
              flush=True)
        if n == 500:
            continue  # the evaluation's N: the rollout only
        worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=spec,
                                          grad_clipping=True, eps_schedule=sched)
        ok &= good
        keep(f"sweep {name}/{target}", worst)
        print(f"[20 compare] KL sweep full N={n} K={k} emb{emb} {name} {target} "
              f"{sched or 'constant'}: {line}, ok {good}", flush=True)
    # Whole KL steps with the variational draw trained (train_vi), through the
    # kernels against the plain versions.
    for flags, name in ((GMM_CAIS_FLAGS, "gmm_cais KL (train_vi)"),
                        (GMM_CAIS_TUNED_FLAGS, "gmm_cais_tuned KL (train_vi)"),
                        (GMM_ULA_FLAGS, "gmm_ula KL (train_vi)"),
                        (ULA_SN_FLAGS, "ULA_sn many_gmm KL")):
        ok &= compare_training_step(flags + ["--config.iters", "0"], name, arbitrate=True,
                                    tag="20 compare")
    if not ok:
        fail("an overdamped kernel form and its plain version disagree beyond tolerance")
    return errors


def _od_path(flags, iters, tag, expect, elbo_must_rise=True):
    """run_experiment with `flags` for `iters` steps (and the 30 x 500
    evaluation) after the same evaluation at the initial parameters; the
    launches of every kernel wrapper must be exactly `expect` ({wrapper:
    {form: count}}), no loss NaN, no divergence, and (if asked: the 2000-step
    recipe paths) the ELBO above its value at init. Returns (launch table,
    output, wall s)."""
    from cmcd_tpu_torch.main import parse_flags, run_experiment

    init = run_experiment(parse_flags(flags + ["--config.iters", "0"]))
    cfg = parse_flags(flags + ["--config.iters", str(iters)])
    _reset_launches()
    t0 = time.perf_counter()
    out = run_experiment(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = _launch_table()
    result = out["train"]
    losses = result.losses.double()
    first, last = float(losses[:100].mean()), float(losses[-100:].mean())
    p = result.params["train"]
    eps = float(p["eps"]) if "eps" in p else float(result.params["notrain"]["eps"])
    print(f"[{tag}] {cfg.boundmode} {cfg.model} {cfg.iters} steps N={cfg.N} K={cfg.nbridges}: "
          f"launches {json.dumps(table)} wall {wall:.3f} s ({1e3 * wall / cfg.iters:.3f} ms per "
          f"step, evaluation and init included) | loss mean first 100 {first!r} last 100 "
          f"{last!r} | eps {eps!r} | ELBO {init['final_elbo']!r} -> {out['final_elbo']!r} +- "
          f"{out['final_elbo_std']!r} ln Z {init['final_ln_Z']!r} -> {out['final_ln_Z']!r} +- "
          f"{out['final_ln_Z_std']!r} diverged {result.diverged} steps_done {result.steps_done}",
          flush=True)
    want = {name: (sum(forms.values()), forms) for name, forms in expect.items()}
    if table != want:
        fail(f"{tag}: launches {table}, expected {want}")
    if len(losses) != cfg.iters or bool(torch.isnan(losses).any()):
        fail(f"{tag}: {len(losses)} losses logged, NaN among them: "
             f"{bool(torch.isnan(losses).any())}")
    if result.diverged or result.steps_done != cfg.iters:
        fail(f"{tag}: training diverged")
    if not (math.isfinite(out["final_elbo"]) and math.isfinite(out["final_ln_Z"])):
        fail(f"{tag}: ELBO / ln Z not finite")
    if elbo_must_rise and not out["final_elbo"] > init["final_elbo"]:
        fail(f"{tag}: training did not raise the ELBO: {init['final_elbo']} -> "
             f"{out['final_elbo']}")
    if (out["neg_elbos"].shape != (cfg.n_input_dist_seeds, cfg.n_samples)
            or not np.isfinite(out["samples"]).all()):
        fail(f"{tag}: evaluation output malformed")
    return table, out, wall


def phase_od_paths():
    """The gmm recipes' paths and ULA / ULA_sn on many_gmm through the CLI
    (phase 21): each form's launches, counted from 0 just before its run."""
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    replay, reroll = "evolve_vargrad_bwd_replay", "evolve_vargrad_bwd_reroll"
    seeds = 30
    runs = {}
    for key, flags, iters in (("CAIS/gmm", GMM_CAIS_FLAGS, OD_PATH_ITERS),
                              ("ULA/gmm", GMM_ULA_FLAGS, OD_PATH_ITERS),
                              ("ULA_sn/many_gmm", ULA_SN_FLAGS, OD_WIDE_ITERS),
                              ("ULA/many_gmm", ULA_MG_FLAGS, OD_WIDE_ITERS)):
        expect = {rollout: {key: iters + seeds}, sweep: {key: iters}}
        runs[key] = _od_path(flags, iters, "21 path", expect,
                             elbo_must_rise=iters == OD_PATH_ITERS)
    # The VarGrad kernels' gmm forms: replay at the recipe's shape, reroll
    # past the trajectory budget (K=256, REROLL_N chains; a few steps, the
    # ELBO not gated).
    runs["replay/gmm"] = _od_path(GMM_VAR_FLAGS, OD_WIDE_ITERS, "21 path", {
        rollout: {"CAIS/gmm": OD_WIDE_ITERS + seeds}, replay: {"gmm": OD_WIDE_ITERS}},
        elbo_must_rise=False)
    big = GMM_VAR_FLAGS + ["--config.nbridges", "256", "--config.N", str(REROLL_N)]
    runs["reroll/gmm"] = _od_path(big, REROLL_ITERS, "21 path", {
        rollout: {"CAIS/gmm": REROLL_ITERS + seeds}, reroll: {"gmm": REROLL_ITERS}},
        elbo_must_rise=False)
    return {key: table for key, (table, _, _) in runs.items()}


# Per point, FP32 operations of a target's score and of its Hessian product
# (the many_gmm mixture's 40 components, the 3-mode gmm's 6 pairs, the
# funnel's O(D) sums at D = 10, the standard normal's negation) and its
# constants (n_par floats), for the bounds of _work_od.
TARGET_WORK = {"many_gmm": (6 * 40, 10 * 40, 80), "gmm": (120, 80, 18),
               "funnel": (40, 60, 1), "std_normal": (10, 10, 1)}


def _work_od(n, k, in_dim, target="many_gmm", net_fwd=True, dim=2):
    """Least time the card could take for one call of an overdamped form at
    these shapes (the rule of _work) for a target of dimension dim:
    {"rollout" (with trajectory and noise stores), "sweep" (KL), "replay",
    "reroll" (VarGrad)}. in_dim 0: no net (ULA); net_fwd False: the net in
    the backward kernel only (ULA_sn: K applies, not K + 1)."""
    score, hvp, n_par = TARGET_WORK[target]
    points = (k + 1) * n
    state = 10 * dim                                       # per point: means, clips, weight
    applies = (points if net_fwd else k * n) if in_dim else 0
    net_apply = in_dim * in_dim + 2 * dim * in_dim         # layer 2; layer 1's z part, head
    weights = 4 * (dim * in_dim + k * in_dim + k * max(in_dim - dim, 0) + in_dim * in_dim
                   + in_dim + dim * in_dim + dim) if in_dim else 0
    fwd_flops = 2 * (applies * net_apply + points * (score + state))
    stores = 4 * dim * points + 4 * dim * k * n             # trajectory, noise
    fwd_bytes = (4 * ((dim + 1) * n + k + n_par + 3 * dim) + weights + 4 * ((dim + 1) * n)
                 + stores)
    bwd_flops = 2 * (applies * (3 * in_dim * in_dim + (4 + 2 * dim) * in_dim)
                     + points * (score + hvp + 20 * dim))
    sums = 4 * (in_dim * in_dim + (1 + 2 * dim) * in_dim + 3 * dim + 2
                + (k + 1) * (2 * in_dim + 2)) if in_dim else 4 * (1 + 2 * dim + k)
    bwd_bytes = stores + 4 * (n + k + n_par) + weights + 8 * dim * n + sums
    # VarGrad: the apply again, W2 g_a2 and the outer product per point, no
    # Hessian product; replay reads the trajectory, reroll makes it again.
    var_flops = 2 * (applies * (3 * in_dim * in_dim + (4 + 2 * dim) * in_dim)
                     + points * (score + state))
    var_bytes = 4 * dim * points + 4 * (n + k + n_par) + weights + sums
    return {"rollout": _bound(fwd_flops, fwd_bytes), "sweep": _bound(bwd_flops, bwd_bytes),
            "replay": _bound(var_flops, var_bytes),
            "reroll": _bound(var_flops + 8 * dim * points,
                             var_bytes - 4 * dim * points + 4 * dim * n + 8)}


def phase_od_timing():
    """CUDA-event times of the new forms beside their bounds, and the gmm
    recipes' optimizer steps (phase 22)."""
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import CAIS, ULA, ULA_SN
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    shapes = {  # form: (spec, target, N, K, emb, eps, sigma, schedule)
        "ULA/many_gmm": (ULA, "many_gmm", 2000, 256, 130, 0.1, 15.0, ""),
        "ULA_sn/many_gmm": (ULA_SN, "many_gmm", 2000, 256, 130, 0.1, 15.0, ""),
        "ULA/gmm": (ULA, "gmm", 300, 8, 20, 0.05, 3.0, ""),
        "CAIS/gmm": (CAIS, "gmm", 300, 8, 20, 0.01, 1.0, ""),
        "CAIS/gmm K=256 cos_sq": (CAIS, "gmm", 300, 256, 20, 0.00125, 1.0, "cos_sq"),
    }
    times, bounds_ = {}, {}
    for form, (spec, target, n, k, emb, eps, sigma, sched) in shapes.items():
        pos, kw, _ = _split(make_problem(n, k, emb, seed=2, sigma=sigma, eps=eps, target=target))
        kw = dict(kw, grad_clipping=True, eps_schedule=sched)
        gen = torch.Generator(device="cuda").manual_seed(5)
        cot = torch.randn(n, generator=gen, device="cuda")
        g_zf = torch.randn(n, 2, generator=gen, device="cuda")
        _, _, traj, noise = evolve_overdamped_fused(*pos, spec, **kw, seed=seed,
                                                    return_trajectory=True, return_noise=True)
        plain_reps = 2 if k <= 8 else 1
        fns = {
            "rollout": (lambda: evolve_overdamped_fused(
                *pos, spec, **kw, seed=seed, return_trajectory=True, return_noise=True), 20),
            "rollout_plain": (lambda: evolve_overdamped_fused_plain(
                *pos, spec, **kw, seed=7, return_trajectory=True, return_noise=True), plain_reps),
            "sweep": (lambda: evolve_kl_bwd(traj, noise, cot, g_zf, *pos[2:], spec, **kw), 10),
            "sweep_plain": (lambda: evolve_kl_bwd_plain(traj, noise, cot, g_zf, *pos[2:], spec,
                                                        **kw), plain_reps),
        }
        t = times[form] = {name: [] for name in fns}
        for name in ("rollout_plain", "sweep_plain", "rollout", "sweep", "sweep", "rollout",
                     "sweep_plain", "rollout_plain"):
            fn, reps = fns[name]
            t[name].append(_event_ms(fn, reps))
        # The event times above include each call's host work; the kernels'
        # own device time per launch beside them.
        kernels = ("ula_rollout", "kl_ula_sweep") if spec == ULA else (
            "overdamped_rollout", "kl_reverse_sweep")
        t["rollout_device"] = _device_ms(fns["rollout"][0], 10, kernels[0])
        t["sweep_device"] = _device_ms(fns["sweep"][0], 10, kernels[1])
        in_dim = 0 if spec == ULA else 2 + emb
        bounds_[form] = _work_od(n, k, in_dim, target, net_fwd=spec.fwd_sn)
        print(f"[22 timing] {form} N={n} K={k} emb{emb if in_dim else '-'} ms {json.dumps(t)}; "
              f"bounds rollout {json.dumps(bounds_[form]['rollout'])} sweep "
              f"{json.dumps(bounds_[form]['sweep'])}", flush=True)
    # The VarGrad kernels' gmm instances at the gmm CAIS recipe's shape.
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_replay,
        evolve_vargrad_bwd_replay_plain,
        evolve_vargrad_bwd_reroll,
        evolve_vargrad_bwd_reroll_plain,
    )

    pos, kw, _ = _split(make_problem(300, 8, 20, seed=4, sigma=1.0, eps=0.01, target="gmm"))
    kw = dict(kw, grad_clipping=True)
    cot = torch.randn(300, generator=torch.Generator(device="cuda").manual_seed(6), device="cuda")
    _, _, traj = evolve_overdamped_fused(*pos, CAIS_VAR, **kw, seed=seed, return_trajectory=True)
    fns = {
        "replay": (lambda: evolve_vargrad_bwd_replay(traj, cot, *pos[2:], CAIS_VAR, **kw), 20),
        "replay_plain": (lambda: evolve_vargrad_bwd_replay_plain(traj, cot, *pos[2:], CAIS_VAR,
                                                                 **kw), 2),
        "reroll": (lambda: evolve_vargrad_bwd_reroll(pos[0], cot, *pos[2:], CAIS_VAR, **kw,
                                                     seed=seed), 20),
        "reroll_plain": (lambda: evolve_vargrad_bwd_reroll_plain(pos[0], cot, *pos[2:], CAIS_VAR,
                                                                 **kw, seed=7), 2),
    }
    t = times["VarGrad/gmm"] = {name: [] for name in fns}
    for name in ("replay_plain", "reroll_plain", "replay", "reroll", "reroll", "replay",
                 "reroll_plain", "replay_plain"):
        fn, reps = fns[name]
        t[name].append(_event_ms(fn, reps))
    for kind in ("replay", "reroll"):
        t[f"{kind}_device"] = _device_ms(fns[kind][0], 10, f"vargrad_{kind}")
    bounds_["VarGrad/gmm"] = _work_od(300, 8, 22, "gmm")
    print(f"[22 timing] VarGrad gmm N=300 K=8 emb20 ms {json.dumps(t)}; bounds replay "
          f"{json.dumps(bounds_['VarGrad/gmm']['replay'])} reroll "
          f"{json.dumps(bounds_['VarGrad/gmm']['reroll'])}", flush=True)
    # The evaluation's N=500 rollouts of the many_gmm forms.
    for form in ("ULA/many_gmm", "ULA_sn/many_gmm"):
        spec = shapes[form][0]
        pos, kw, _ = _split(make_problem(500, 256, 130, seed=3, sigma=15.0, eps=0.1))
        times[form]["rollout_n500"] = [_event_ms(lambda: evolve_overdamped_fused(
            *pos, spec, **kw, grad_clipping=True, seed=seed), 20) for _ in range(2)]

    step_ms = {}
    for name, flags in (("gmm_cais", GMM_CAIS_FLAGS), ("gmm_ula", GMM_ULA_FLAGS),
                        ("ULA_sn many_gmm", ULA_SN_FLAGS)):
        cfg, setup, target, params, ctx = flagship(flags + ["--config.iters", "0"])
        trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi,
                                             cfg.train_betas)
        fused_loss, _ = fused_training_path(setup, cfg.N)
        fused = lambda p, n, c, s, generator: fused_loss(p, n, c, s, target, generator=generator)

        def steps(loss_fn, iters):
            g = torch.Generator(device="cuda").manual_seed(1)
            return lambda: train(setup, params, ctx, lr=cfg.lr, iters=iters, batch_size=cfg.N,
                                 generator=g, trainable=trainable, loss_fn=loss_fn,
                                 steps_per_call=iters, nan_check_every=10**9)

        steps(fused, 5)()
        eager_iters = 3 if cfg.nbridges <= 8 else 1
        ms = step_ms[name] = {"eager": [], "kernel": []}
        for which in ("eager", "kernel", "kernel", "eager"):
            loss_fn, iters = (bounds.kl_bound, eager_iters) if which == "eager" else (fused, 50)
            ms[which].append(_wall_ms(steps(loss_fn, iters)) / iters)
        if cfg.nbridges <= 8:
            # A host-bound step: train()'s set-up alone (0 steps), and the
            # step over a window ten times as long, to hold the 50-step
            # reading against the CLI log's median.
            ms["setup_ms"] = [_wall_ms(steps(fused, 0)) for _ in range(2)]
            ms["kernel_200"] = [_wall_ms(steps(fused, 200)) / 200]
        prof_wall, prof_dev, top = _profile(steps(fused, 10))
        print(f"[22 timing] {name} optimizer step N={cfg.N} K={cfg.nbridges} ms per step "
              f"{json.dumps(ms)} (kernel: 50 steps, kernel_500: 500, eager: {eager_iters} per "
              f"reading; setup_ms: train() with 0 steps, ms per call); 10 fused "
              f"steps under the profiler: wall {prof_wall!r} ms, device busy {prof_dev!r} ms, per "
              f"step {prof_dev / 10!r} ms ({100 * prof_dev / 10 / min(ms['kernel'])!r}% of the "
              f"fastest unprofiled step), device records {json.dumps(top)}", flush=True)
    return times, bounds_, step_ms


def _od_kernel_entries(errors, paths, times, bounds_, err_is):
    """The kernels line's entries of the overdamped forms of phases 20-22:
    each form's launches on its own path (phase 21), its worst error against
    the plain version (phase 20), its times (phase 22) and bound."""
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    entries = []
    for form, (r_name, s_name) in {
            "ULA/many_gmm": ("ula_rollout<ManyGmmTarget>", "kl_ula_sweep<ManyGmmTarget>"),
            "ULA/gmm": ("ula_rollout<Gmm3Target>", "kl_ula_sweep<Gmm3Target>"),
            "ULA_sn/many_gmm": ("overdamped_rollout<ManyGmmTarget, false, 0>",
                                "kl_reverse_sweep<NG, ManyGmmTarget, false>"),
            "CAIS/gmm": ("overdamped_rollout<Gmm3Target, true, 1>",
                         "kl_reverse_sweep<NG, Gmm3Target, true>")}.items():
        name, target = form.split("/")
        t, b, table = times[form], bounds_[form], paths[form]
        entries.append({
            "name": r_name, "route": "cuda", "source": "cmcd_tpu_torch/csrc/overdamped.cu",
            "replaces": "cmcd_tpu/ops/pallas_overdamped.py:102", "form": form,
            "launches": table[rollout][1][form],
            "max_abs_err": errors[f"rollout {name}/{target}"],
            "ms": min(t["rollout"]), "device_ms": t["rollout_device"],
            "plain_ms": min(t["rollout_plain"]), **keep(b["rollout"]), "library_ms": None,
            **({"ms_at_n500": min(t["rollout_n500"])} if "rollout_n500" in t else {}),
            **({"ms_at_k256_cos_sq": min(times["CAIS/gmm K=256 cos_sq"]["rollout"]),
                "bound_ms_at_k256_cos_sq": bounds_["CAIS/gmm K=256 cos_sq"]["rollout"][
                    "bound_ms"]} if form == "CAIS/gmm" else {}),
        })
        entries.append({
            "name": s_name, "route": "cuda", "source": "cmcd_tpu_torch/csrc/kl.cu",
            "replaces": "cmcd_tpu/ops/pallas_kl.py:49", "form": form,
            "launches": table[sweep][1][form],
            "max_abs_err": errors[f"sweep {name}/{target}"], "max_abs_err_is": err_is,
            "ms": min(t["sweep"]), "device_ms": t["sweep_device"],
            "plain_ms": min(t["sweep_plain"]), **keep(b["sweep"]), "library_ms": None,
            **({"ms_at_k256_cos_sq": min(times["CAIS/gmm K=256 cos_sq"]["sweep"]),
                "bound_ms_at_k256_cos_sq": bounds_["CAIS/gmm K=256 cos_sq"]["sweep"][
                    "bound_ms"]} if form == "CAIS/gmm" else {}),
        })
    t, b = times["VarGrad/gmm"], bounds_["VarGrad/gmm"]
    for kind, wrapper, replaces, path in (
            ("replay", "evolve_vargrad_bwd_replay", "cmcd_tpu/ops/pallas_vargrad.py:67",
             "replay/gmm"),
            ("reroll", "evolve_vargrad_bwd_reroll", "cmcd_tpu/ops/pallas_vargrad.py:385",
             "reroll/gmm")):
        entries.append({
            "name": f"vargrad_{kind}<Gmm3Target>", "route": "cuda",
            "source": "cmcd_tpu_torch/csrc/vargrad.cu", "replaces": replaces, "form": "gmm",
            "launches": paths[path][wrapper][1]["gmm"],
            "max_abs_err": errors[f"{kind}/gmm"], "max_abs_err_is": err_is,
            "ms": min(t[kind]), "device_ms": t[f"{kind}_device"],
            "plain_ms": min(t[f"{kind}_plain"]), **keep(b[kind]), "library_ms": None,
        })
    return entries



# Neal's funnel (dim 10) at funnel_k8's flags (experiments/recipes.py:31-50;
# FUNNEL_EPS_DICT[8] sets init_eps 0.1 and lr 0.01), the same flags in the
# other overdamped modes, and the compares' two shapes: funnel_k8's own and
# a full-depth stress shape (K=256, FUNNEL_EPS_DICT[256]'s init_eps 0.01).
FUNNEL_FLAGS = (
    "--config.model funnel --config.boundmode MCD_CAIS_sn --config.N 300 --config.nbridges 8 "
    "--config.emb_dim 48 --config.init_eps 0.1 --config.init_sigma 1 --config.train_vi True "
    "--config.train_eps False --config.lr 0.01 --config.eps_schedule cos_sq "
    "--noconfig.pretrain_mfvi --config.n_samples 2000 --config.n_input_dist_seeds 30 "
    "--config.log.every 1"
).split()
FUNNEL_MODE_FLAGS = {mode: [f if f != "MCD_CAIS_sn" else mode for f in FUNNEL_FLAGS]
                     for mode in ("MCD_CAIS_var_sn", "MCD_ULA_sn", "MCD_ULA")}
# 1000 steps (2000 before the DNF phases 35-37 joined the run, to keep it
# under 900 s); the ELBO must still rise.
FUNNEL_PATH_ITERS, FUNNEL_SHORT_ITERS = 1000, 200
FUNNEL_SHAPES = {"funnel_k8": (300, 8, 48, 0.1), "stress": (2000, 256, 48, 0.01)}
# A funnel_k8-like shape whose chain count passes 32 chains a tile times the
# H100's 132 SMs: the sweeps and the reroll take four groups (sweep_grid).
FUNNEL_NG4 = (8192, 8, 48, 0.1)


def _score_and_hvp_through_kernels(target):
    """The kernels' score and Hessian product of `target` (D = 10) against
    the plain versions in float32 and float64, at 512 points whose v runs
    from -20 to 8 (x at the funnel's own spread e^{v/2}), read through the
    net-free forms at K = 1, eps 1, beta 1, no noise: the rollout's step is
    z + score(z); the sweep's dL/dz0 for g_zfinal = u and no weight
    cotangent on the path (z0, z0) is u + H(z0) u. Returns
    ({what: worst row error relative to the row's scale}, ok)."""
    from cmcd_tpu_torch.integrators.overdamped import ULA
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused

    case = make_problem(512, 1, 4, seed=41, din=0, target=target)
    gen = torch.Generator(device="cuda").manual_seed(43)
    n, dim = 512, case["dim"]
    v = torch.linspace(-20.0, 8.0, n, device="cuda")
    x = torch.randn(n, dim - 1, generator=gen, device="cuda") * torch.exp(v / 2)[:, None]
    z0 = torch.cat([v[:, None], x], 1).contiguous()
    u = torch.randn(n, dim, generator=gen, device="cuda")
    score = case["grad_logp"]
    kw = dict(dim=dim, nbridges=1, sn=None, eps_schedule="", grad_clipping=False)
    args = (torch.ones(1, device="cuda"), torch.tensor(1.0, device="cuda"), case["vd_mean"],
            case["vd_logdiag"], score, ULA)
    z1, _ = evolve_overdamped_fused(z0, torch.zeros(n, device="cuda"), *args,
                                    noise=torch.zeros(1, n, dim, device="cuda"), **kw)
    traj = torch.stack([z0, z0]).contiguous()
    g, g_z0 = evolve_kl_bwd(traj, torch.zeros(1, n, dim, device="cuda"),
                            torch.zeros(n, device="cuda"), u, *args, **kw)
    torch.cuda.synchronize()
    got = {"score": (z1 - z0).double(), "hvp": (g_z0 - u).double()}
    scale = {"score": z0.double().norm(dim=1), "hvp": u.double().norm(dim=1)}
    want32 = {"score": score(z0).double(), "hvp": score.hvp(z0, u).double()}
    want64 = {"score": score(z0.double()), "hvp": score.hvp(z0.double(), u.double())}
    errs, ok = {}, True
    for what in ("score", "hvp"):
        row = scale[what] + want64[what].norm(dim=1)
        e_k = float(((got[what] - want64[what]).norm(dim=1) / row).max())
        e_p = float(((want32[what] - want64[what]).norm(dim=1) / row).max())
        errs[what] = {"kernel_vs_float64": e_k, "float32_plain_vs_float64": e_p,
                      "kernel_vs_float32_plain": float(
                          ((got[what] - want32[what]).norm(dim=1) / row).max())}
        ok &= bool(torch.isfinite(got[what]).all()) and e_k <= 1e-5
    return errs, ok


def phase_funnel_compare():
    """Every D = 10 form against its plain version on the funnel and the
    standard normal (phase 23)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR, ULA, ULA_SN
    from cmcd_tpu_torch.ops.vargrad import sweep_grid

    ok, errors = True, {}

    def keep(key, value, n=None):
        """The worst error of a form on a target; with n, also under the
        instance sweep_grid takes at n chains (key/NG=groups)."""
        keys = [key] + ([f"{key}/NG={sweep_grid(n, 'cuda')[0]}"] if n else [])
        for k in keys:
            errors[k] = max(errors.get(k, 0.0), value)

    for target in ("funnel", "std_normal"):
        errs, good = _score_and_hvp_through_kernels(target)
        ok &= good
        print(f"[23 compare] {target} score and Hessian product through the kernels, v in "
              f"[-20, 8] (row error over the row's scale, limit 1e-5 against float64): "
              f"{json.dumps(errs)}, ok {good}", flush=True)
    specs = (("CAIS", CAIS), ("CAIS_VAR", CAIS_VAR), ("ULA_sn", ULA_SN), ("ULA", ULA))
    for target in ("funnel", "std_normal"):
        for shape, (n, k, emb, eps) in FUNNEL_SHAPES.items():
            tol = TOL_SMALL if k <= 8 else TOL_FULL
            for i, (name, spec) in enumerate(specs):
                case = make_problem(n, k, emb, seed=50 + i, sigma=1.0, eps=eps, target=target)
                kw = dict(eps_schedule="cos_sq")
                stats, good = compare(case, spec, tol, **kw)
                ok &= good
                keep(f"rollout {name}/{target}", max(stats["z_max_abs"], stats["w_max_abs"]))
                print(f"[23 compare] rollout {shape} N={n} K={k} emb{emb} {name} {target}: "
                      f"{json.dumps(stats)} tol {json.dumps(tol)}", flush=True)
                if shape == "funnel_k8":
                    stats, good = compare_noise_stack(case, spec, **kw)
                    ok &= good
                    print(f"[23 compare] rollout noise stack {shape} {name} {target}: "
                          f"{json.dumps(stats)}", flush=True)
                if spec == CAIS_VAR:
                    for kind, fn in (("replay", compare_backward), ("reroll", compare_reroll)):
                        worst, leaf, good = fn(case, GRAD_TOL_FULL, **kw)
                        ok &= good
                        keep(f"{kind}/{target}", worst, n if kind == "reroll" else None)
                        print(f"[23 compare] {kind} {shape} N={n} K={k} emb{emb} {target}: "
                              f"worst relative error {worst:.3e} (leaf {leaf}), limit "
                              f"{GRAD_TOL_FULL}, ok {good}", flush=True)
                    worst, leaf, good = compare_reroll_with_replay(case, **kw)
                    ok &= good
                    print(f"[23 compare] reroll {shape} {target} (seed, vs the replay kernel): "
                          f"worst relative error {worst:.3e} (leaf {leaf}), limit "
                          f"{REROLL_VS_REPLAY_TOL}, ok {good}", flush=True)
                    continue
                worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=spec,
                                                  **kw)
                ok &= good
                keep(f"sweep {name}/{target}", worst, n if spec != ULA else None)
                print(f"[23 compare] KL sweep {shape} N={n} K={k} emb{emb} {name} {target}: "
                      f"{line}, ok {good}", flush=True)
    # Four groups: the shapes above take two on the H100 (63 tiles or fewer),
    # funnel_k8's re-rolling path at N=REROLL_N takes four.
    n, k, emb, eps = FUNNEL_NG4
    for big in (n, REROLL_N):
        groups, blocks = sweep_grid(big, "cuda")
        if groups != 4 or blocks >= -(-big // 32):
            fail(f"N={big} does not take four groups with more tiles than blocks "
                 f"({groups} groups, {blocks} blocks)")
    kw = dict(eps_schedule="cos_sq")
    for target in ("funnel", "std_normal"):
        for i, (name, spec) in enumerate((("CAIS", CAIS), ("ULA_sn", ULA_SN))):
            case = make_problem(n, k, emb, seed=70 + i, sigma=1.0, eps=eps, target=target)
            worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=spec,
                                              **kw)
            ok &= good
            keep(f"sweep {name}/{target}", worst, n)
            print(f"[23 compare] KL sweep four groups N={n} K={k} emb{emb} {name} {target}: "
                  f"{line}, ok {good}", flush=True)
        case = make_problem(n, k, emb, seed=72, sigma=1.0, eps=eps, target=target)
        worst, leaf, good = compare_reroll(case, GRAD_TOL_FULL, **kw)
        ok &= good
        keep(f"reroll/{target}", worst, n)
        print(f"[23 compare] reroll four groups N={n} K={k} emb{emb} {target}: worst relative "
              f"error {worst:.3e} (leaf {leaf}), limit {GRAD_TOL_FULL}, ok {good}", flush=True)
        worst, leaf, good = compare_reroll_with_replay(case, **kw)
        ok &= good
        print(f"[23 compare] reroll four groups N={n} {target} (seed, vs the replay kernel): "
              f"worst relative error {worst:.3e} (leaf {leaf}), limit {REROLL_VS_REPLAY_TOL}, "
              f"ok {good}", flush=True)
    # The re-rolling path's own shape (phase 24's five steps): the plain
    # versions in slices of PLAIN_CHUNK chains, as phase 3 for many_gmm.
    eps = FUNNEL_SHAPES["stress"][3]
    big = make_problem(REROLL_N, 256, emb, seed=73, sigma=1.0, eps=eps, target="funnel")
    stats, good = compare_rollout_chunked(big, CAIS_VAR, TOL_FULL, PLAIN_CHUNK, **kw)
    ok &= good
    keep("rollout CAIS_VAR/funnel", max(stats["z_max_abs"], stats["w_max_abs"]))
    print(f"[23 compare] rollout N={REROLL_N} K=256 emb{emb} CAIS_VAR funnel (plain version in "
          f"slices of {PLAIN_CHUNK} chains): {json.dumps(stats)} tol {json.dumps(TOL_FULL)}",
          flush=True)
    worst, leaf, good, plain_ms = compare_reroll_chunked(big, GRAD_TOL_FULL, PLAIN_CHUNK, **kw)
    ok &= good
    keep("reroll/funnel", worst, REROLL_N)
    errors["reroll/funnel/path_n"] = worst
    print(f"[23 compare] reroll N={REROLL_N} K=256 emb{emb} funnel (injected noise, vs plain in "
          f"slices of {PLAIN_CHUNK} chains, summed; {plain_ms:.1f} ms): worst relative error "
          f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_FULL}, ok {good}", flush=True)
    # The eps leaf of this sum over 33 million (chain, point) terms is
    # ill-conditioned at init_eps 0.01: every float32 order (the two kernels',
    # the plain version's) lands a few 1e-4 from the float64 sum, so the
    # float64 arbiter decides a leaf beyond the limit.
    worst, leaf, good, more = compare_reroll_with_replay_f64(big, PLAIN_CHUNK, **kw)
    ok &= good
    print(f"[23 compare] reroll N={REROLL_N} K=256 emb{emb} funnel (seed, vs the replay kernel "
          f"on the rollout's trajectory): worst relative error {worst:.3e} (leaf {leaf}), limit "
          f"{REROLL_VS_REPLAY_TOL}{more}, ok {good}", flush=True)
    del big
    # The clips at D = 10 (funnel_k8 does not clip), and one whole funnel_k8
    # step with the variational draw trained.
    case = make_problem(300, 8, 48, seed=60, sigma=1.0, eps=0.1, target="funnel")
    stats, good = compare(case, CAIS, TOL_SMALL, eps_schedule="cos_sq", grad_clipping=True)
    ok &= good
    worst, line, good2 = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=CAIS,
                                       eps_schedule="cos_sq", grad_clipping=True)
    ok &= good2
    print(f"[23 compare] funnel_k8 CAIS funnel with clipping: rollout {json.dumps(stats)}; KL "
          f"sweep {line}, ok {good and good2}", flush=True)
    ok &= compare_training_step(FUNNEL_FLAGS + ["--config.iters", "0"], "funnel_k8 KL (train_vi)",
                                arbitrate=True, tag="23 compare")
    if not ok:
        fail("a D = 10 kernel form and its plain version disagree beyond tolerance")
    return errors


def phase_funnel_paths():
    """funnel_k8's path through the CLI and the other D = 10 forms' (phase
    24): each form's launches, counted from 0 just before its run."""
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    replay, reroll = "evolve_vargrad_bwd_replay", "evolve_vargrad_bwd_reroll"
    seeds = 30
    runs = {}
    for key, flags, iters in (
            ("CAIS/funnel", FUNNEL_FLAGS, FUNNEL_PATH_ITERS),
            ("ULA_sn/funnel", FUNNEL_MODE_FLAGS["MCD_ULA_sn"], FUNNEL_SHORT_ITERS),
            ("ULA/funnel", FUNNEL_MODE_FLAGS["MCD_ULA"], FUNNEL_SHORT_ITERS)):
        expect = {rollout: {key: iters + seeds}, sweep: {key: iters}}
        runs[key] = _od_path(flags, iters, "24 path", expect,
                             elbo_must_rise=iters == FUNNEL_PATH_ITERS)
    var = FUNNEL_MODE_FLAGS["MCD_CAIS_var_sn"]
    runs["replay/funnel"] = _od_path(var, FUNNEL_SHORT_ITERS, "24 path", {
        rollout: {"CAIS/funnel": FUNNEL_SHORT_ITERS + seeds}, replay: {"funnel": FUNNEL_SHORT_ITERS}},
        elbo_must_rise=False)
    # Past the trajectory budget "auto" takes the re-rolling backward: K=256
    # (init_eps 0.01 from FUNNEL_EPS_DICT[256]) at REROLL_N chains.
    big = var + ["--config.nbridges", "256", "--config.N", str(REROLL_N)]
    runs["reroll/funnel"] = _od_path(big, REROLL_ITERS, "24 path", {
        rollout: {"CAIS/funnel": REROLL_ITERS + seeds}, reroll: {"funnel": REROLL_ITERS}},
        elbo_must_rise=False)
    return {key: table for key, (table, _, _) in runs.items()}


def phase_funnel_timing():
    """CUDA-event and device times of the D = 10 forms at funnel_k8's shape
    and the stress shape beside their bounds, and funnel_k8's optimizer step
    (phase 25)."""
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR, ULA, ULA_SN
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_replay,
        evolve_vargrad_bwd_replay_plain,
        evolve_vargrad_bwd_reroll,
        evolve_vargrad_bwd_reroll_plain,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    order = ("plain", "kernel", "kernel", "plain")
    times, bounds_ = {}, {}
    for shape, (n, k, emb, eps) in FUNNEL_SHAPES.items():
        plain_reps = 2 if k <= 8 else 1
        for name, spec in (("CAIS", CAIS), ("ULA_sn", ULA_SN), ("ULA", ULA)):
            pos, kw, _ = _split(make_problem(n, k, emb, seed=2, sigma=1.0, eps=eps,
                                             target="funnel"))
            kw = dict(kw, eps_schedule="cos_sq")
            gen = torch.Generator(device="cuda").manual_seed(5)
            cot = torch.randn(n, generator=gen, device="cuda")
            g_zf = torch.randn(n, 10, generator=gen, device="cuda")
            _, _, traj, noise = evolve_overdamped_fused(*pos, spec, **kw, seed=seed,
                                                        return_trajectory=True, return_noise=True)
            fns = {
                "rollout": (lambda: evolve_overdamped_fused(
                    *pos, spec, **kw, seed=seed, return_trajectory=True, return_noise=True), 20),
                "rollout_plain": (lambda: evolve_overdamped_fused_plain(
                    *pos, spec, **kw, seed=7, return_trajectory=True, return_noise=True),
                    plain_reps),
                "sweep": (lambda: evolve_kl_bwd(traj, noise, cot, g_zf, *pos[2:], spec, **kw), 10),
                "sweep_plain": (lambda: evolve_kl_bwd_plain(traj, noise, cot, g_zf, *pos[2:],
                                                            spec, **kw), plain_reps),
            }
            t = times[f"{name}/funnel {shape}"] = {key: [] for key in fns}
            for which in order:
                for kind in ("rollout", "sweep"):
                    key = kind if which == "kernel" else f"{kind}_plain"
                    fn, reps = fns[key]
                    t[key].append(_event_ms(fn, reps))
            kernels = ("ula_rollout", "kl_ula_sweep") if spec == ULA else (
                "overdamped_rollout", "kl_reverse_sweep")
            t["rollout_device"] = _device_ms(fns["rollout"][0], 10, kernels[0])
            t["sweep_device"] = _device_ms(fns["sweep"][0], 10, kernels[1])
            in_dim = 0 if spec == ULA else 10 + emb
            b = bounds_[f"{name}/funnel {shape}"] = _work_od(n, k, in_dim, "funnel",
                                                             net_fwd=spec.fwd_sn, dim=10)
            print(f"[25 timing] {name} funnel {shape} N={n} K={k} emb"
                  f"{emb if in_dim else '-'} ms {json.dumps(t)}; bounds rollout "
                  f"{json.dumps(b['rollout'])} sweep {json.dumps(b['sweep'])}", flush=True)
        pos, kw, _ = _split(make_problem(n, k, emb, seed=4, sigma=1.0, eps=eps, target="funnel"))
        kw = dict(kw, eps_schedule="cos_sq")
        cot = torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(6),
                          device="cuda")
        _, _, traj = evolve_overdamped_fused(*pos, CAIS_VAR, **kw, seed=seed,
                                             return_trajectory=True)
        fns = {
            "replay": (lambda: evolve_vargrad_bwd_replay(traj, cot, *pos[2:], CAIS_VAR, **kw),
                       20),
            "replay_plain": (lambda: evolve_vargrad_bwd_replay_plain(
                traj, cot, *pos[2:], CAIS_VAR, **kw), plain_reps),
            "reroll": (lambda: evolve_vargrad_bwd_reroll(pos[0], cot, *pos[2:], CAIS_VAR, **kw,
                                                         seed=seed), 20),
            "reroll_plain": (lambda: evolve_vargrad_bwd_reroll_plain(
                pos[0], cot, *pos[2:], CAIS_VAR, **kw, seed=7), plain_reps),
        }
        t = times[f"VarGrad/funnel {shape}"] = {key: [] for key in fns}
        for which in order:
            for kind in ("replay", "reroll"):
                key = kind if which == "kernel" else f"{kind}_plain"
                fn, reps = fns[key]
                t[key].append(_event_ms(fn, reps))
        for kind in ("replay", "reroll"):
            t[f"{kind}_device"] = _device_ms(fns[kind][0], 10, f"vargrad_{kind}")
        b = bounds_[f"VarGrad/funnel {shape}"] = _work_od(n, k, 10 + emb, "funnel", dim=10)
        print(f"[25 timing] VarGrad funnel {shape} N={n} K={k} emb{emb} ms {json.dumps(t)}; "
              f"bounds replay {json.dumps(b['replay'])} reroll {json.dumps(b['reroll'])}",
              flush=True)

    cfg, setup, target, params, ctx = flagship(FUNNEL_FLAGS + ["--config.iters", "0"])
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi, cfg.train_betas)
    fused_loss, _ = fused_training_path(setup, cfg.N)
    fused = lambda p, n_, c, s, generator: fused_loss(p, n_, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        g = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=cfg.lr, iters=iters, batch_size=cfg.N,
                             generator=g, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=max(iters, 1), nan_check_every=10**9)

    steps(fused, 5)()
    ms = {"eager": [], "kernel": []}
    for which in order:
        loss_fn, iters = (bounds.kl_bound, 3) if which == "plain" else (fused, 50)
        ms["eager" if which == "plain" else "kernel"].append(_wall_ms(steps(loss_fn, iters))
                                                             / iters)
    ms["kernel_200"] = [_wall_ms(steps(fused, 200)) / 200]
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    ms["busy_ms"] = prof_dev / 10
    # The 50-step readings of this host-bound step can differ 2x within a
    # call; the share is taken against the 200-step window.
    ms["busy_share_of_200"] = prof_dev / 10 / ms["kernel_200"][0]
    print(f"[25 timing] funnel_k8 optimizer step N={cfg.N} K={cfg.nbridges} emb{cfg.emb_dim} ms "
          f"per step {json.dumps(ms)} (kernel: 50 steps, kernel_200: 200, eager: 3 per reading); "
          f"10 fused steps under the profiler: wall {prof_wall!r} ms, device busy {prof_dev!r} "
          f"ms, device records {json.dumps(top)}", flush=True)
    return times, bounds_, ms


def _funnel_kernel_entries(errors, paths, times, bounds_, err_is):
    """The kernels line's entries of the D = 10 forms (phases 23-25): each
    form's launches on its funnel path (phase 24), its worst error against
    the plain version on the funnel (and on the standard normal, phase 23)
    over every instance, and for a form with a groups parameter each
    instance's apart, its times and bound at funnel_k8's shape and at the
    stress shape."""
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    entries = []

    def entry(name, source, replaces, form, launches, err_key, t_key, kind, extra=None):
        t = {shape: times[f"{t_key} {shape}"] for shape in FUNNEL_SHAPES}
        b = {shape: bounds_[f"{t_key} {shape}"][kind] for shape in FUNNEL_SHAPES}
        # A form with a groups parameter: the error of each instance (NG=2
        # at the two shapes, NG=4 at N=8192 and, for the reroll, REROLL_N).
        by_groups = {f"max_abs_err{sfx}_by_groups": {
            g: errors.get(f"{err_key}/{tgt}/NG={g}") for g in (2, 4)}
            for tgt, sfx in (("funnel", ""), ("std_normal", "_std_normal"))
            if f"{err_key}/{tgt}/NG=4" in errors}
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "form": form,
            "launches": launches, "max_abs_err": errors[f"{err_key}/funnel"],
            "max_abs_err_std_normal": errors[f"{err_key}/std_normal"], **by_groups,
            **(extra or {}),
            "ms": min(t["funnel_k8"][kind]), "device_ms": t["funnel_k8"][f"{kind}_device"],
            "plain_ms": min(t["funnel_k8"][f"{kind}_plain"]), **keep(b["funnel_k8"]),
            "library_ms": None,
            "ms_at_stress": min(t["stress"][kind]),
            "device_ms_at_stress": t["stress"][f"{kind}_device"],
            "plain_ms_at_stress": min(t["stress"][f"{kind}_plain"]),
            "bound_ms_at_stress": b["stress"]["bound_ms"],
        })

    for form, (r_name, s_name) in {
            "CAIS": ("overdamped_rollout<FunnelTarget, true, 1>",
                     "kl_reverse_sweep<NG, FunnelTarget, true>"),
            "ULA_sn": ("overdamped_rollout<FunnelTarget, false, 0>",
                       "kl_reverse_sweep<NG, FunnelTarget, false>"),
            "ULA": ("ula_rollout<FunnelTarget>", "kl_ula_sweep<FunnelTarget>")}.items():
        key, table = f"{form}/funnel", paths[f"{form}/funnel"]
        entry(r_name, "cmcd_tpu_torch/csrc/overdamped.cu", "cmcd_tpu/ops/pallas_overdamped.py:102",
              key, table[rollout][1][key], f"rollout {form}", form + "/funnel", "rollout")
        entry(s_name, "cmcd_tpu_torch/csrc/kl.cu", "cmcd_tpu/ops/pallas_kl.py:49", key,
              table[sweep][1][key], f"sweep {form}", form + "/funnel", "sweep",
              {"max_abs_err_is": err_is})
    for kind, wrapper, replaces in (
            ("replay", "evolve_vargrad_bwd_replay", "cmcd_tpu/ops/pallas_vargrad.py:67"),
            ("reroll", "evolve_vargrad_bwd_reroll", "cmcd_tpu/ops/pallas_vargrad.py:385")):
        entry(f"vargrad_{kind}<{'NG, ' if kind == 'reroll' else ''}FunnelTarget>",
              "cmcd_tpu_torch/csrc/vargrad.cu", replaces, "funnel",
              paths[f"{kind}/funnel"][wrapper][1]["funnel"], kind, "VarGrad/funnel", kind,
              {"max_abs_err_is": err_is, **({"path_n": REROLL_N, "max_abs_err_at_path_n":
                                             errors["reroll/funnel/path_n"]}
                                            if kind == "reroll" else {})})
    return entries


# The underdamped family's new forms (phases 26-28): the exact refresh and
# exact_fwd on many_gmm at the LDVI flags' shape, LDVI on the 3-mode gmm at
# the gmm_cais recipe's, CAIS_UHA on the funnel at funnel_k8's flags with
# K=32 (FUNNEL_EPS_DICT[32]: init_eps 0.1, lr 0.005; the JAX package's
# record, RESULTS.md), UHA on the funnel at funnel_k8's.
UD_MODE_FLAGS = {mode: [f if f != "MCD_U_a-lp-sn" else mode for f in LDVI_FLAGS]
                 for mode in ("MCD_U_e-lp", "MCD_U_e-lp-sna", "MCD_U_ea-lp-sn")}
GMM_LDVI_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_U_a-lp-sn" for f in GMM_CAIS_FLAGS]
CAIS_UHA_FLAGS = ([f if f != "MCD_CAIS_sn" else "MCD_CAIS_UHA_sn" for f in FUNNEL_FLAGS]
                  + ["--config.nbridges", "32"])
FUNNEL_UHA_FLAGS = [f if f != "MCD_CAIS_sn" else "UHA" for f in FUNNEL_FLAGS]
# 1000 steps (2000 before the DNF phases), the ELBO still gated.
CAIS_UHA_PATH_ITERS, UD_SHORT_ITERS = 1000, 200
# Each new form's shapes: (mode, target, N, K, emb, init_sigma, init_eps, init_gamma), the
# path's own first.
UD_NEW_SHAPES = {
    "MCD_U_e-lp/many_gmm": [("MCD_U_e-lp", "many_gmm", 2000, 256, 130, 15.0, 0.05, 5.0)],
    "MCD_U_e-lp-sna/many_gmm": [("MCD_U_e-lp-sna", "many_gmm", 2000, 256, 130, 15.0, 0.05, 5.0)],
    "MCD_U_ea-lp-sn/many_gmm": [("MCD_U_ea-lp-sn", "many_gmm", 2000, 256, 130, 15.0, 0.05, 5.0)],
    "MCD_U_a-lp-sn/gmm": [("MCD_U_a-lp-sn", "gmm", 300, 8, 20, 1.0, 0.01, 10.0),
                          ("MCD_U_a-lp-sn", "gmm", 2000, 256, 20, 1.0, 0.01, 10.0)],
    "MCD_CAIS_UHA_sn/funnel": [("MCD_CAIS_UHA_sn", "funnel", 300, 32, 48, 1.0, 0.1, 10.0),
                               ("MCD_CAIS_UHA_sn", "funnel", 2000, 256, 48, 1.0, 0.01, 10.0)],
}
UHA_FUNNEL_SHAPES = [(300, 8, 0.1), (2000, 256, 0.01)]  # N, K, init_eps


def _ud_case(mode, target, n, k, emb, sigma, eps, gamma, seed):
    from cmcd_tpu_torch.integrators import UNDERDAMPED

    spec = UNDERDAMPED[mode]
    return spec, make_ud_problem(n, k, emb, spec, seed=seed, sigma=sigma, eps=eps, gamma=gamma,
                                 target=target)


def phase_ud_new_compare():
    """The underdamped family's new forms against their plain versions
    (phase 26): every spec of B6 and B7 on gmm and the funnel at the test
    size, the exact and exact_fwd forms on many_gmm and each path's shapes
    at full width, CAIS_UHA with its clip engaged and at four groups, B8 and
    B9 on the funnel, and one whole step of each new path's flags."""
    from cmcd_tpu_torch.integrators import UNDERDAMPED
    from cmcd_tpu_torch.ops.vargrad import sweep_grid

    ok, errors = True, {}

    def keep(key, value, n=None):
        keys = [key] + ([f"{key}/NG={sweep_grid(n, 'cuda')[0]}"] if n else [])
        for k in keys:
            errors[k] = max(errors.get(k, 0.0), value)

    for target in ("gmm", "funnel"):
        sigma = 1.0 if target == "funnel" else 3.0
        for i, (mode, spec) in enumerate(UNDERDAMPED.items()):
            case = make_ud_problem(256, 8, 16, spec, seed=90 + i, sigma=sigma, target=target)
            stats, good = compare_ud(case, spec, TOL_SMALL)
            ok &= good
            keep(f"rollout {mode}/{target}", max(stats["z_max_abs"], stats["w_max_abs"]))
            print(f"[26 compare] underdamped rollout small N=256 K=8 emb16 {mode} {target}: "
                  f"{json.dumps(stats)}", flush=True)
            case = make_ud_problem(128, 6, 16, spec, seed=100 + i, sigma=sigma, target=target)
            worst, line, good = compare_ud_sweep(case, spec, GRAD_TOL_SMALL, arbitrate=True)
            ok &= good
            keep(f"sweep {mode}/{target}", worst)
            print(f"[26 compare] underdamped KL sweep small N=128 K=6 emb16 {mode} {target}: "
                  f"{line}, ok {good}", flush=True)
    for key, shapes in UD_NEW_SHAPES.items():
        for j, (mode, target, n, k, emb, sigma, eps, gamma) in enumerate(shapes):
            spec, case = _ud_case(mode, target, n, k, emb, sigma, eps, gamma, seed=110 + j)
            tol = TOL_SMALL if k <= 32 else TOL_FULL
            stats, good = compare_ud(case, spec, tol)
            ok &= good
            keep(f"rollout {key}", max(stats["z_max_abs"], stats["w_max_abs"]))
            print(f"[26 compare] underdamped rollout N={n} K={k} emb{emb} {key}: "
                  f"{json.dumps(stats)} tol {json.dumps(tol)}", flush=True)
            worst, line, good = compare_ud_sweep(case, spec, GRAD_TOL_FULL, arbitrate=True)
            ok &= good
            keep(f"sweep {key}", worst, n)
            print(f"[26 compare] underdamped KL sweep N={n} K={k} emb{emb} {key}: {line}, ok "
                  f"{good}", flush=True)
    # CAIS_UHA's clip engaged (init_sigma 3: v below -4.6 on many chains)
    # and its noise stack; four groups of feature threads at N=8192.
    spec, case = _ud_case("MCD_CAIS_UHA_sn", "funnel", 300, 32, 48, 3.0, 0.1, 10.0, seed=120)
    stats, good = compare_ud(case, spec, TOL_SMALL)
    worst, line, good2 = compare_ud_sweep(case, spec, GRAD_TOL_FULL, arbitrate=True)
    clipped = stats["clipped_score_elements"]
    ok &= good and good2 and clipped > 0
    keep("rollout MCD_CAIS_UHA_sn/funnel", max(stats["z_max_abs"], stats["w_max_abs"]))
    keep("sweep MCD_CAIS_UHA_sn/funnel", worst, 300)
    errors["clipped_score_elements"] = clipped
    print(f"[26 compare] CAIS_UHA funnel with the clip engaged N=300 K=32 emb48 init_sigma 3: "
          f"rollout {json.dumps(stats)}; KL sweep {line}, ok {good and good2 and clipped > 0}",
          flush=True)
    stats, good = compare_ud_noise_stack(case, spec)
    ok &= good
    print(f"[26 compare] underdamped noise stack N=300 K=32 CAIS_UHA funnel: {json.dumps(stats)}",
          flush=True)
    groups, blocks = sweep_grid(8192, "cuda")
    if groups != 4 or blocks >= 8192 // 32:
        fail(f"N=8192 does not take four groups with more tiles than blocks ({groups}, {blocks})")
    for mode, target, emb in (("MCD_CAIS_UHA_sn", "funnel", 48), ("MCD_U_ea-lp-sn", "funnel", 48),
                              ("MCD_U_e-lp-sna", "gmm", 20)):
        spec, case = _ud_case(mode, target, 8192, 8, emb, 1.0, 0.1, 10.0, seed=121)
        worst, line, good = compare_ud_sweep(case, spec, GRAD_TOL_FULL, arbitrate=True)
        ok &= good
        keep(f"sweep {mode}/{target}", worst, 8192)
        print(f"[26 compare] underdamped KL sweep four groups N=8192 K=8 emb{emb} {mode} "
              f"{target}: {line}, ok {good}", flush=True)
    # B8 and B9 on the funnel.
    for lf in (1, 3):
        stats, good = compare_uha(make_uha_problem(256, 8, "funnel", seed=130, sigma=1.0,
                                                   eps=0.1, lfsteps=lf), TOL_SMALL)
        ok &= good
        keep("uha_rollout/funnel", max(stats["z_max_abs"], stats["w_max_abs"]))
        print(f"[26 compare] UHA rollout small N=256 K=8 funnel lfsteps {lf}: "
              f"{json.dumps(stats)}", flush=True)
        worst, line, good = compare_uha_sweep(make_uha_problem(256, 8, "funnel", seed=131,
                                                               sigma=1.0, eps=0.1, lfsteps=lf),
                                              GRAD_TOL_SMALL, arbitrate=True)
        ok &= good
        keep("uha_sweep/funnel", worst)
        print(f"[26 compare] UHA sweep small N=256 K=8 funnel lfsteps {lf}: {line}, ok {good}",
              flush=True)
    for n, k, eps in UHA_FUNNEL_SHAPES:
        tol = TOL_SMALL if k <= 32 else TOL_FULL
        stats, good = compare_uha(make_uha_problem(n, k, "funnel", seed=132, sigma=1.0, eps=eps),
                                  tol)
        ok &= good
        keep("uha_rollout/funnel", max(stats["z_max_abs"], stats["w_max_abs"]))
        print(f"[26 compare] UHA rollout N={n} K={k} funnel: {json.dumps(stats)} tol "
              f"{json.dumps(tol)}", flush=True)
        worst, line, good = compare_uha_sweep(make_uha_problem(n, k, "funnel", seed=133,
                                                               sigma=1.0, eps=eps),
                                              GRAD_TOL_FULL, arbitrate=True)
        ok &= good
        keep("uha_sweep/funnel", worst)
        print(f"[26 compare] UHA sweep N={n} K={k} funnel: {line}, ok {good}", flush=True)
    stats, good = compare_uha_noise_stack(make_uha_problem(2000, 256, "funnel", seed=134,
                                                           sigma=1.0, eps=0.01))
    ok &= good
    print(f"[26 compare] UHA noise stack N=2000 K=256 funnel: {json.dumps(stats)}", flush=True)
    for name, flags in (("MCD_U_e-lp many_gmm", UD_MODE_FLAGS["MCD_U_e-lp"]),
                        ("MCD_U_e-lp-sna many_gmm", UD_MODE_FLAGS["MCD_U_e-lp-sna"]),
                        ("MCD_U_ea-lp-sn many_gmm", UD_MODE_FLAGS["MCD_U_ea-lp-sn"]),
                        ("LDVI gmm (train_vi)", GMM_LDVI_FLAGS),
                        ("CAIS_UHA funnel K=32 (train_vi)", CAIS_UHA_FLAGS),
                        ("UHA funnel (train_vi)", FUNNEL_UHA_FLAGS)):
        ok &= compare_training_step(flags + ["--config.iters", "0"], name, arbitrate=True,
                                    tag="26 compare")
    if not ok:
        fail("a new underdamped or UHA kernel form and its plain version disagree beyond "
             "tolerance")
    return errors


def phase_ud_new_paths():
    """The new forms' paths through the CLI (phase 27), each form's launches
    counted from 0 just before its run: CAIS_UHA on the funnel at K=32 for
    CAIS_UHA_PATH_ITERS steps (ELBO above its value at init), the exact and
    exact_fwd modes on many_gmm, LDVI on gmm and UHA on the funnel for
    UD_SHORT_ITERS; then MCD_DNF with a PIS net (dds_grad), which no kernel
    takes (DNF runs with the geffner nets: phases 35-37), refused before any
    launch."""
    rollout, sweep = "evolve_underdamped_fused", "evolve_kl_bwd_underdamped"
    seeds = 30
    runs = {}
    for key, flags, iters in (
            ("MCD_CAIS_UHA_sn/funnel", CAIS_UHA_FLAGS, CAIS_UHA_PATH_ITERS),
            ("MCD_U_e-lp/many_gmm", UD_MODE_FLAGS["MCD_U_e-lp"], UD_SHORT_ITERS),
            ("MCD_U_e-lp-sna/many_gmm", UD_MODE_FLAGS["MCD_U_e-lp-sna"], UD_SHORT_ITERS),
            ("MCD_U_ea-lp-sn/many_gmm", UD_MODE_FLAGS["MCD_U_ea-lp-sn"], UD_SHORT_ITERS),
            ("MCD_U_a-lp-sn/gmm", GMM_LDVI_FLAGS, UD_SHORT_ITERS)):
        expect = {rollout: {key: iters + seeds}, sweep: {key: iters}}
        runs[key] = _od_path(flags, iters, "27 path", expect,
                             elbo_must_rise=iters == CAIS_UHA_PATH_ITERS)
    runs["UHA/funnel"] = _od_path(FUNNEL_UHA_FLAGS, UD_SHORT_ITERS, "27 path", {
        "evolve_uha_fused": {"funnel": UD_SHORT_ITERS + seeds},
        "evolve_kl_bwd_uha": {"funnel": UD_SHORT_ITERS}}, elbo_must_rise=False)
    from cmcd_tpu_torch.main import parse_flags, run_experiment

    _reset_launches()
    bad = [f if f != "MCD_CAIS_sn" else "MCD_DNF" for f in FUNNEL_FLAGS]
    try:
        run_experiment(parse_flags(bad + ["--config.iters", "0", "--config.nn_arch", "dds_grad"]))
    except NotImplementedError as err:
        print(f"[27 path] MCD_DNF with dds_grad on the funnel: refused ({err})", flush=True)
    else:
        fail("MCD_DNF with a PIS net ran on the card without a kernel")
    if _launch_table():
        fail("a refused configuration launched a kernel")
    return {key: table for key, (table, _, _) in runs.items()}


def phase_ud_new_timing():
    """CUDA-event and device times of the new forms at their paths' shapes
    beside their bounds, and the CAIS_UHA funnel optimizer step (phase 28)."""
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.ops.kl_uha import evolve_kl_bwd_uha, evolve_kl_bwd_uha_plain
    from cmcd_tpu_torch.ops.kl_underdamped import (
        evolve_kl_bwd_underdamped,
        evolve_kl_bwd_underdamped_plain,
    )
    from cmcd_tpu_torch.ops.uha import evolve_uha_fused, evolve_uha_fused_plain
    from cmcd_tpu_torch.ops.underdamped import (
        evolve_underdamped_fused,
        evolve_underdamped_fused_plain,
        net_input_width,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    order = ("plain", "kernel", "kernel", "plain")
    times, bounds_ = {}, {}

    def timed(label, fns, kernels, bound):
        t = times[label] = {key: [] for key in fns}
        for which in order:
            for kind in ("rollout", "sweep"):
                key = kind if which == "kernel" else f"{kind}_plain"
                fn, reps = fns[key]
                t[key].append(_event_ms(fn, reps))
        t["rollout_device"] = _device_ms(fns["rollout"][0], 10, kernels[0])
        t["sweep_device"] = _device_ms(fns["sweep"][0], 10, kernels[1])
        bounds_[label] = bound
        print(f"[28 timing] {label} ms {json.dumps(t)}; bounds rollout with stores "
              f"{json.dumps(bound[1])} sweep {json.dumps(bound[2])}", flush=True)

    for key, shapes in UD_NEW_SHAPES.items():
        for mode, target, n, k, emb, sigma, eps, gamma in shapes:
            spec, case = _ud_case(mode, target, n, k, emb, sigma, eps, gamma, seed=140)
            pos, kw, _ = _ud_split(case)
            dim = pos[0].shape[1]
            gen = torch.Generator(device="cuda").manual_seed(5)
            cot = torch.randn(n, generator=gen, device="cuda")
            g_zf = torch.randn(n, dim, generator=gen, device="cuda")
            _, _, zt, rt, dr = evolve_underdamped_fused(*pos, spec, **kw, seed=seed,
                                                        return_state=True)
            plain_reps = 2 if k <= 32 else 1
            fns = {
                "rollout": (lambda: evolve_underdamped_fused(*pos, spec, **kw, seed=seed,
                                                             return_state=True), 20),
                "rollout_plain": (lambda: evolve_underdamped_fused_plain(
                    *pos, spec, **kw, seed=7, return_state=True), plain_reps),
                "sweep": (lambda: evolve_kl_bwd_underdamped(zt, rt, dr, cot, g_zf, *pos[2:], spec,
                                                            **kw), 10),
                "sweep_plain": (lambda: evolve_kl_bwd_underdamped_plain(
                    zt, rt, dr, cot, g_zf, *pos[2:], spec, **kw), 1),
            }
            din = net_input_width(spec, dim)
            bound = _work_ud(n, k, din + emb if din else 0, target, dim, din, spec.fwd_sn)
            timed(f"{key} N={n} K={k}", fns, ("underdamped_rollout", "kl_ud_sweep"), bound)
    for n, k, eps in UHA_FUNNEL_SHAPES:
        pos, kw, _ = _uha_split(make_uha_problem(n, k, "funnel", seed=141, sigma=1.0, eps=eps))
        gen = torch.Generator(device="cuda").manual_seed(6)
        cot = torch.randn(n, generator=gen, device="cuda")
        g_zf = torch.randn(n, 10, generator=gen, device="cuda")
        _, _, zt, rt, dr = evolve_uha_fused(*pos, **kw, seed=seed, return_state=True)
        fns = {
            "rollout": (lambda: evolve_uha_fused(*pos, **kw, seed=seed, return_state=True), 20),
            "rollout_plain": (lambda: evolve_uha_fused_plain(*pos, **kw, seed=7,
                                                             return_state=True), 1),
            "sweep": (lambda: evolve_kl_bwd_uha(zt, rt, dr, cot, g_zf, *pos[1:], **kw), 20),
            "sweep_plain": (lambda: evolve_kl_bwd_uha_plain(zt, rt, dr, cot, g_zf, *pos[1:],
                                                            **kw), 1),
        }
        timed(f"UHA/funnel N={n} K={k}", fns, ("uha_rollout", "kl_uha_sweep"),
              _work_uha(n, k, 1, "funnel", 10))

    cfg, setup, target, params, ctx = flagship(CAIS_UHA_FLAGS + ["--config.iters", "0"])
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi, cfg.train_betas)
    fused_loss, _ = fused_training_path(setup, cfg.N)
    fused = lambda p, n_, c, s, generator: fused_loss(p, n_, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        g = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=cfg.lr, iters=iters, batch_size=cfg.N,
                             generator=g, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=max(iters, 1), nan_check_every=10**9)

    steps(fused, 5)()
    ms = {"eager": [], "kernel": []}
    for which in order:
        loss_fn, iters = (bounds.kl_bound, 2) if which == "plain" else (fused, 50)
        ms["eager" if which == "plain" else "kernel"].append(_wall_ms(steps(loss_fn, iters))
                                                             / iters)
    ms["kernel_200"] = [_wall_ms(steps(fused, 200)) / 200]
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    ms["busy_ms"] = prof_dev / 10
    ms["busy_share_of_200"] = prof_dev / 10 / ms["kernel_200"][0]
    print(f"[28 timing] CAIS_UHA funnel optimizer step N={cfg.N} K={cfg.nbridges} "
          f"emb{cfg.emb_dim} ms per step {json.dumps(ms)} (kernel: 50 steps, kernel_200: 200, "
          f"eager: 2 per reading); 10 fused steps under the profiler: wall {prof_wall!r} ms, "
          f"device busy {prof_dev!r} ms, device records {json.dumps(top)}", flush=True)
    return times, bounds_, ms


def _ud_new_kernel_entries(errors, paths, times, bounds_, err_is):
    """The kernels line's entries of the new instances (phases 26-28): each
    form's launches on its path (phase 27), its worst error against the plain
    version over every shape (phase 26; a sweep's NG instances apart), its
    times and bound at its path's shape and, where phase 28 has one, at a
    second shape."""
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    entries = []
    rollout, sweep = "evolve_underdamped_fused", "evolve_kl_bwd_underdamped"
    instance = {"MCD_U_e-lp/many_gmm": ("ManyGmmTarget", 0, False),
                "MCD_U_e-lp-sna/many_gmm": ("ManyGmmTarget", 2, False),
                "MCD_U_ea-lp-sn/many_gmm": ("ManyGmmTarget", 4, False),
                "MCD_U_a-lp-sn/gmm": ("Gmm3Target", 4, False),
                "MCD_CAIS_UHA_sn/funnel": ("FunnelTarget", 20, True)}
    labels = {key: [f"{key} N={n} K={k}" for _, _, n, k, *_ in shapes]
              for key, shapes in UD_NEW_SHAPES.items()}
    labels["UHA/funnel"] = [f"UHA/funnel N={n} K={k}" for n, k, _ in UHA_FUNNEL_SHAPES]

    def entry(name, source, replaces, form, launches, err, label_list, kind, extra):
        t0, b0 = times[label_list[0]], bounds_[label_list[0]][1 if kind == "rollout" else 2]
        e = {"name": name, "route": "cuda", "source": source, "replaces": replaces, "form": form,
             "launches": launches, "max_abs_err": err, **extra,
             "ms": min(t0[kind]), "device_ms": t0[f"{kind}_device"],
             "plain_ms": min(t0[f"{kind}_plain"]), **keep(b0), "library_ms": None,
             "shape": label_list[0]}
        if len(label_list) > 1:
            t1, b1 = times[label_list[1]], bounds_[label_list[1]][1 if kind == "rollout" else 2]
            e.update({"shape_2": label_list[1], "ms_2": min(t1[kind]),
                      "device_ms_2": t1[f"{kind}_device"], "plain_ms_2": min(t1[f"{kind}_plain"]),
                      "bound_ms_2": b1["bound_ms"]})
        entries.append(e)

    for key, (tname, din, cais) in instance.items():
        table = paths[key]
        by_groups = {"max_abs_err_by_groups": {g: errors.get(f"sweep {key}/NG={g}")
                                               for g in (2, 4)}}
        entry(f"underdamped_rollout<{tname}, {din}>", "cmcd_tpu_torch/csrc/underdamped.cu",
              "cmcd_tpu/ops/pallas_underdamped.py:67", key, table[rollout][1][key],
              errors[f"rollout {key}"], labels[key], "rollout", {})
        extra = {"max_abs_err_is": err_is, **by_groups}
        if cais:
            extra["clipped_score_elements"] = errors["clipped_score_elements"]
        entry(f"kl_ud_sweep<NG, {tname}, {din}, {str(cais).lower()}>",
              "cmcd_tpu_torch/csrc/kl_underdamped.cu", "cmcd_tpu/ops/pallas_kl.py:983", key,
              table[sweep][1][key], errors[f"sweep {key}"], labels[key], "sweep", extra)
    table = paths["UHA/funnel"]
    entry("uha_rollout<FunnelTarget>", "cmcd_tpu_torch/csrc/uha.cu",
          "cmcd_tpu/ops/pallas_uha.py:31", "UHA/funnel", table["evolve_uha_fused"][1]["funnel"], errors["uha_rollout/funnel"],
          labels["UHA/funnel"], "rollout", {})
    entry("kl_uha_sweep<FunnelTarget, LMAX>", "cmcd_tpu_torch/csrc/kl_uha.cu",
          "cmcd_tpu/ops/pallas_kl.py:1438", "UHA/funnel",
          table["evolve_kl_bwd_uha"][1]["funnel"], errors["uha_sweep/funnel"],
          labels["UHA/funnel"], "sweep", {"max_abs_err_is": err_is})
    return entries


# The PIS nets ("dds", "dds_grad"; phases 29-31). The recipes
# many_gmm_kl_dds and many_gmm_kl_dds_grad (experiments/recipes.py:108-181:
# MCD_CAIS_sn, N=2000, K=256, init_sigma 60, init_eps 1.0, cos_sq, grad
# clipping, lr 0.001, units [64, 64]); the same net in VarGrad (init_sigma
# 15: a VarGrad loss past many_gmm's floor would be NaN) and in ULA_sn; the
# gmm_cais and funnel_k8 flags with a PIS net for the D = 2 and D = 10
# targets' instances.
KL_DDS_FLAGS = (
    "--config.model many_gmm --config.boundmode MCD_CAIS_sn --config.N 2000 "
    "--config.nbridges 256 --noconfig.pretrain_mfvi --config.init_sigma 60 "
    "--config.grad_clipping True --config.init_eps 1.0 --config.eps_schedule cos_sq "
    "--config.lr 0.001 --config.train_eps False --config.train_vi False --config.nn_arch dds "
    "--config.n_samples 500 --config.n_input_dist_seeds 30 --config.log.every 1"
).split()
KL_DDS_GRAD_FLAGS = [f if f != "dds" else "dds_grad" for f in KL_DDS_FLAGS]
DDS_VAR_FLAGS = [{"MCD_CAIS_sn": "MCD_CAIS_var_sn", "60": "15"}.get(f, f) for f in KL_DDS_FLAGS]
DDS_ULA_SN_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_ULA_sn" for f in KL_DDS_FLAGS]
GMM_DDS_FLAGS = GMM_CAIS_FLAGS + ["--config.nn_arch", "dds"]
FUNNEL_DDS_GRAD_FLAGS = FUNNEL_FLAGS + ["--config.nn_arch", "dds_grad"]
# 700 steps (2000 before the DNF phases, 1000 before the logreg phases
# 38-40), the ELBO still gated.
PIS_PATH_ITERS, PIS_SHORT_ITERS = 700, 200
PIS_ARCHS = ("dds", "dds_grad")
# Each target's compare: (units at the test size, init_sigma).
PIS_TARGETS = {"many_gmm": ((64, 64), 8.0), "gmm": ((16, 16), 3.0), "funnel": ((16, 16), 1.0)}
# The recipes' full width on many_gmm: N, K, units, init_eps, init_sigma, schedule.
PIS_FULL = (2000, 256, (64, 64), 1.0, 60.0, "cos_sq")


def compare_arbitrated(case, spec, tol, wrappers=None, **kw):
    """compare() with the float64 arbiter of PERF.md §2 for the chains it
    finds beyond a limit (final z, w, or a stored path element past
    TRAJ_ATOL): at most TRAJ_SHARE of the chains (and at least one may), on
    which the kernel must be at most F64_SLACK times as far from the plain
    version in float64 as a float32 computation is (the median over those
    chains of the ratio of their largest distances). A float32 computation's
    distance is the farther of the float32 plain version's and the float32
    floor: the float64 rollout with its state rounded to float32 at every
    step (half an ulp of each element of the float64 path, a random sign,
    two draws). At the recipes' start (init_sigma 60) a rare chain falling
    between modes amplifies that rounding to ~1e-2 for a few steps (one
    chain of 500: floor 8e-3 to 1.5e-2, kernel 7.8e-3, the float32 plain
    1.3e-3 on the card's order); on the others the floor is ~1e-5."""
    from cmcd_tpu_torch.schedules import eps_at_step
    from cmcd_tpu_torch.train.trainer import double_tree

    evolve_overdamped_fused, evolve_overdamped_fused_plain = _rollouts(wrappers)
    stats, good = compare(case, spec, tol, wrappers, **kw)
    if good or not (stats["finite"] and stats["traj_ends_exact_and_outputs_unchanged"]):
        return stats, good
    pos, args, noise = _split(case)
    out_k = evolve_overdamped_fused(*pos, spec, **args, noise=noise, return_trajectory=True, **kw)
    out_p = evolve_overdamped_fused_plain(*pos, spec, **args, noise=noise,
                                          return_trajectory=True, **kw)
    f64 = lambda t: t.double() if torch.is_tensor(t) and t.is_floating_point() else t
    args64 = dict(args, **{net: double_tree(args[net]) for net in ("sn", "sn2")
                           if args.get(net) is not None})
    run64 = lambda xi: evolve_overdamped_fused_plain(*(f64(t) for t in pos), spec, **args64,
                                                     noise=xi, return_trajectory=True, **kw)
    out_d = run64(noise.double())
    (z_k, w_k, t_k), (z_p, w_p, t_p), (z_d, w_d, t_d) = out_k, out_p, out_d
    dz, dw, dt = (z_k - z_p).abs(), (w_k - w_p).abs(), (t_k - t_p).abs()
    bad = ((dz > tol["z_atol"] + tol["z_rtol"] * z_p.abs()).any(-1)
           | (dw > tol["w_atol"] + tol["w_rtol"] * w_p.abs())
           | (dt > TRAJ_ATOL).any(-1).any(0))
    if not bad.any():  # compare() failed on something the arbiter does not decide
        return stats, False
    # The float32 floor: z_{i+1} = fk_mean_i + sqrt(2 eps_i) xi_i, so half an
    # ulp of z_{i+1} enters through xi_i.
    k = args["nbridges"]
    scale = torch.tensor([math.sqrt(2.0 * float(eps_at_step(float(pos[3]), i, k,
                                                            kw.get("eps_schedule", ""))))
                          for i in range(k)], dtype=torch.float64, device=z_d.device)
    ulp = torch.from_numpy(np.spacing(t_d[1:].abs().float().cpu().numpy())).to(z_d.device)
    floors = []
    for draw in range(2):
        gen = torch.Generator(device=z_d.device).manual_seed(41 + draw)
        sign = torch.randint(0, 2, noise.shape, generator=gen, device=z_d.device) * 2.0 - 1.0
        floors.append(run64(noise.double() + 0.5 * ulp.double() * sign / scale[:, None, None]))
    # Per chain beyond a limit: each quantity's largest distance from float64.
    far = {"z": lambda z: (z.double() - z_d).abs().amax(-1),
           "w": lambda w: (w.double() - w_d).abs(),
           "path": lambda t: (t.double() - t_d).abs().amax(-1).amax(0)}
    ratios, floor_max = {}, {}
    for j, (q, (k_, p_)) in enumerate({"z": (z_k, z_p), "w": (w_k, w_p),
                                       "path": (t_k, t_p)}.items()):
        e_floor = torch.stack([far[q](out[j]) for out in floors]).amax(0)[bad]
        e_k, e_p = far[q](k_)[bad], torch.maximum(far[q](p_)[bad], e_floor)
        ratios[q] = float((e_k / e_p.clamp_min(1e-30)).median())
        floor_max[q] = float(e_floor.max())
    n_bad, n = int(bad.sum()), z_k.shape[0]
    stats["float64_arbiter"] = {"chains": n_bad, "median_ratio": ratios,
                                "float32_floor": floor_max}
    good = n_bad <= max(1, TRAJ_SHARE * n) and all(r <= F64_SLACK for r in ratios.values())
    return stats, good


def clipped_gate_elements(case, spec, **kw):
    """How many elements of the target score along the kernel's trajectory
    lie past dds_grad's feature clip (|gt| > 1e2): the clip is only held to
    its plain version where this is not 0."""
    from cmcd_tpu_torch.networks.pis import LGV_CLIP
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused

    pos, args, noise = _split(case)
    _, _, traj = evolve_overdamped_fused(*pos, spec, **args, noise=noise, return_trajectory=True,
                                         **kw)
    return int((case["grad_logp"](traj.reshape(-1, traj.shape[-1])).abs() > LGV_CLIP).sum())


def phase_pis_compare():
    """Every PIS instance against its plain version (phase 29)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR, ULA_SN
    from cmcd_tpu_torch.ops.vargrad import sweep_grid

    ok, errors, clipped = True, {}, {}

    def keep(key, value, n=None):
        keys = [key] + ([f"{key}/NG={sweep_grid(n, 'cuda')[0]}"] if n else [])
        for k in keys:
            errors[k] = max(errors.get(k, 0.0), value)

    specs = (("CAIS", CAIS), ("CAIS_VAR", CAIS_VAR), ("ULA_sn", ULA_SN))
    kw = dict(grad_clipping=True, eps_schedule="cos_sq")
    for target, (units, sigma) in PIS_TARGETS.items():
        for arch in PIS_ARCHS:
            tag = f"{target}/{arch}"
            for i, (name, spec) in enumerate(specs):
                case = make_problem(256, 8, 0, seed=80 + i, sigma=sigma, target=target, net=arch,
                                    units=units)
                stats, good = compare(case, spec, TOL_SMALL, **kw)
                ok &= good
                keep(f"rollout {name}/{tag}", max(stats["z_max_abs"], stats["w_max_abs"]))
                print(f"[29 compare] rollout small N=256 K=8 {units} {name} {tag}: "
                      f"{json.dumps(stats)}", flush=True)
                if name == "CAIS":
                    stats, good = compare_noise_stack(case, spec, **kw)
                    ok &= good
                    print(f"[29 compare] rollout noise stack N=256 K=8 {name} {tag}: "
                          f"{json.dumps(stats)}", flush=True)
            for i, (name, spec) in enumerate((("CAIS", CAIS), ("ULA_sn", ULA_SN))):
                case = make_problem(128, 6, 0, seed=85 + i, sigma=sigma, target=target, net=arch,
                                    units=units)
                worst, line, good = compare_sweep(case, GRAD_TOL_SMALL, arbitrate=True,
                                                  spec=spec, **kw)
                ok &= good
                keep(f"sweep {name}/{tag}", worst, 128)
                print(f"[29 compare] KL sweep small N=128 K=6 {units} {name} {tag}: {line}, "
                      f"ok {good}", flush=True)
            case = make_problem(250, 8, 0, seed=87, sigma=sigma, target=target, net=arch,
                                units=units)
            for kind, fn in (("replay", compare_backward), ("reroll", compare_reroll)):
                worst, leaf, good = fn(case, GRAD_TOL_SMALL, **kw)
                if not good:  # the plain version in float64 decides (PERF.md §2)
                    worst, line, good = _arbitrate_vargrad(case, kind, GRAD_TOL_SMALL, **kw)
                    leaf += line
                ok &= good
                keep(f"{kind}/{tag}", worst, 250 if kind == "reroll" else None)
                print(f"[29 compare] {kind} small N=250 K=8 {units} {tag}: worst relative error "
                      f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_SMALL}, ok {good}", flush=True)
            worst, leaf, good = compare_reroll_with_replay(case, **kw)
            ok &= good
            print(f"[29 compare] reroll small {tag} (seed, vs the replay kernel): worst relative "
                  f"error {worst:.3e} (leaf {leaf}), limit {REROLL_VS_REPLAY_TOL}, ok {good}",
                  flush=True)
    # The recipes' full width, and the evaluation's N=500 rollout.
    n, k, units, eps, sigma, sched = PIS_FULL
    kw = dict(grad_clipping=True, eps_schedule=sched)
    for arch in PIS_ARCHS:
        tag = f"many_gmm/{arch}"
        for i, (name, spec) in enumerate(specs):
            if name == "ULA_sn" and arch == "dds_grad":
                continue
            sig = 15.0 if spec == CAIS_VAR else sigma
            case = make_problem(n, k, 0, seed=90 + i, sigma=sig, eps=eps, net=arch, units=units)
            stats, good = compare_arbitrated(case, spec, TOL_FULL, **kw)
            ok &= good
            keep(f"rollout {name}/{tag}", max(stats["z_max_abs"], stats["w_max_abs"]))
            print(f"[29 compare] rollout full N={n} K={k} {units} {name} {tag} eps {eps} sigma "
                  f"{sig}: {json.dumps(stats)} tol {json.dumps(TOL_FULL)}, ok {good}", flush=True)
            if arch == "dds_grad":
                clipped[f"{name}/{tag}"] = clipped_gate_elements(case, spec, **kw)
            if spec == CAIS_VAR:
                for kind, fn in (("replay", compare_backward), ("reroll", compare_reroll)):
                    worst, leaf, good = fn(case, GRAD_TOL_FULL, **kw)
                    if not good:
                        worst, line, good = _arbitrate_vargrad(case, kind, GRAD_TOL_FULL, **kw)
                        leaf += line
                    ok &= good
                    keep(f"{kind}/{tag}", worst, n if kind == "reroll" else None)
                    print(f"[29 compare] {kind} full N={n} K={k} {tag}: worst relative error "
                          f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_FULL}, ok {good}",
                          flush=True)
                continue
            worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=spec, **kw)
            ok &= good
            keep(f"sweep {name}/{tag}", worst, n)
            print(f"[29 compare] KL sweep full N={n} K={k} {units} {name} {tag}: {line}, ok "
                  f"{good}", flush=True)
        case = make_problem(500, k, 0, seed=95, sigma=sigma, eps=eps, net=arch, units=units)
        stats, good = compare_arbitrated(case, CAIS, TOL_FULL, **kw)
        ok &= good
        keep(f"rollout CAIS/{tag}", max(stats["z_max_abs"], stats["w_max_abs"]))
        print(f"[29 compare] rollout N=500 K={k} CAIS {tag}: {json.dumps(stats)}, ok {good}", flush=True)
    # Four groups: N=8192 at K=8 (more tiles than blocks).
    big = 8192
    groups, blocks = sweep_grid(big, "cuda")
    if groups != 4 or blocks >= -(-big // 32):
        fail(f"N={big} does not take four groups with more tiles than blocks")
    for arch in PIS_ARCHS:
        tag = f"many_gmm/{arch}"
        for i, (name, spec) in enumerate((("CAIS", CAIS), ("ULA_sn", ULA_SN))):
            case = make_problem(big, 8, 0, seed=96 + i, sigma=8.0, eps=0.1, net=arch,
                                units=units)
            worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=spec,
                                              **kw)
            ok &= good
            keep(f"sweep {name}/{tag}", worst, big)
            print(f"[29 compare] KL sweep four groups N={big} K=8 {name} {tag}: {line}, ok {good}",
                  flush=True)
        case = make_problem(big, 8, 0, seed=98, sigma=8.0, eps=0.1, net=arch, units=units)
        worst, leaf, good = compare_reroll(case, GRAD_TOL_FULL, **kw)
        ok &= good
        keep(f"reroll/{tag}", worst, big)
        print(f"[29 compare] reroll four groups N={big} K=8 {tag}: worst relative error "
              f"{worst:.3e} (leaf {leaf}), limit {GRAD_TOL_FULL}, ok {good}", flush=True)
    # The re-rolling path's own shape: N=REROLL_N, K=256, from a seed against
    # the replay kernel, the replay's plain version in float64 the arbiter.
    big = make_problem(REROLL_N, k, 0, seed=99, sigma=15.0, eps=eps, net="dds", units=units)
    worst, leaf, good, more = compare_reroll_with_replay_f64(big, PLAIN_CHUNK, **kw)
    ok &= good
    errors["reroll/many_gmm/dds/path_n"] = worst
    print(f"[29 compare] reroll N={REROLL_N} K={k} dds (seed, vs the replay kernel on the "
          f"rollout's trajectory): worst relative error {worst:.3e} (leaf {leaf}), limit "
          f"{REROLL_VS_REPLAY_TOL}{more}, ok {good}", flush=True)
    del big
    print(f"[29 compare] target score elements past dds_grad's clip (|gt| > 1e2) along the "
          f"full-width trajectories: {json.dumps(clipped)}", flush=True)
    if not any(clipped.values()):
        fail("dds_grad's feature clip never engaged: its VJP went unchecked")
    for flags, name in ((KL_DDS_FLAGS, "many_gmm_kl_dds"), (KL_DDS_GRAD_FLAGS,
                                                          "many_gmm_kl_dds_grad"),
                        (DDS_VAR_FLAGS, "VarGrad dds")):
        ok &= compare_training_step(flags + ["--config.iters", "0"], name, arbitrate=True,
                                    tag="29 compare")
    if not ok:
        fail("a PIS kernel form and its plain version disagree beyond tolerance")
    return errors, clipped


def _arbitrate_vargrad(case, kind, tol, **kw):
    """A VarGrad backward kernel (kind "replay" or "reroll") against its
    plain version with the plain version in float64 the arbiter (the eps
    leaf's sum cancels: PERF.md §2). Returns (worst, words, ok)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS_VAR
    from cmcd_tpu_torch.ops.overdamped import evolve_overdamped_fused_plain
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_replay,
        evolve_vargrad_bwd_replay_plain,
        evolve_vargrad_bwd_reroll,
    )

    pos, args, noise = _split(case)
    _, _, traj = evolve_overdamped_fused_plain(*pos, CAIS_VAR, **args, noise=noise,
                                               return_trajectory=True, **kw)
    gen = torch.Generator(device="cuda").manual_seed(17)
    cot = torch.randn(pos[0].shape[0], generator=gen, device="cuda")
    if kind == "replay":
        got = _flat(evolve_vargrad_bwd_replay(traj, cot, *pos[2:], CAIS_VAR, **args, **kw))
    else:
        got = _flat(evolve_vargrad_bwd_reroll(pos[0], cot, *pos[2:], CAIS_VAR, **args,
                                              noise=noise, **kw))
    want = _flat(evolve_vargrad_bwd_replay_plain(traj, cot, *pos[2:], CAIS_VAR, **args, **kw))
    ref = _flat(evolve_vargrad_bwd_replay_plain(traj.double(), cot, *pos[2:], CAIS_VAR, **args,
                                                **kw))
    worst, _, _ = _grad_errors(got, want, tol)
    ok, line = _arbitrate(got, want, ref, tol)
    return worst, line, ok


def phase_pis_paths():
    """The PIS paths through the CLI (phase 30): each form's launches,
    counted from 0 just before its run, and no other kernel."""
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    replay, reroll = "evolve_vargrad_bwd_replay", "evolve_vargrad_bwd_reroll"
    seeds = 30
    runs = {}
    for key, flags, iters in (("CAIS/many_gmm/dds", KL_DDS_FLAGS, PIS_PATH_ITERS),
                              ("CAIS/many_gmm/dds_grad", KL_DDS_GRAD_FLAGS, PIS_PATH_ITERS),
                              ("ULA_sn/many_gmm/dds", DDS_ULA_SN_FLAGS, PIS_SHORT_ITERS),
                              ("CAIS/gmm/dds", GMM_DDS_FLAGS, PIS_SHORT_ITERS),
                              ("CAIS/funnel/dds_grad", FUNNEL_DDS_GRAD_FLAGS, PIS_SHORT_ITERS)):
        expect = {rollout: {key: iters + seeds}, sweep: {key: iters}}
        runs[key] = _od_path(flags, iters, "30 path", expect,
                             elbo_must_rise=iters == PIS_PATH_ITERS)
    runs["replay/many_gmm/dds"] = _od_path(DDS_VAR_FLAGS, PIS_SHORT_ITERS, "30 path", {
        rollout: {"CAIS/many_gmm/dds": PIS_SHORT_ITERS + seeds},
        replay: {"many_gmm/dds": PIS_SHORT_ITERS}}, elbo_must_rise=False)
    big = DDS_VAR_FLAGS + ["--config.N", str(REROLL_N)]
    runs["reroll/many_gmm/dds"] = _od_path(big, REROLL_ITERS, "30 path", {
        rollout: {"CAIS/many_gmm/dds": REROLL_ITERS + seeds},
        reroll: {"many_gmm/dds": REROLL_ITERS}}, elbo_must_rise=False)
    return {key: table for key, (table, _, _) in runs.items()}


def _work_pis(n, k, width, target="many_gmm", net_fwd=True, dim=2, gate=False):
    """_work_od for a PIS net of width F (two F x F layers on [z, h_t]): the
    same net FMAs a point (layer 2, layer 1's z part, the head), gelu and
    its derivative (an erf and an exp, ~20 operations each) a feature, the
    gate term's 3 operations a dimension; its tables c1 ((K + 1) x F) and
    gate ((K + 1) x D) in place of geffner's embedding."""
    b = _work_od(n, k, width, target, net_fwd=net_fwd, dim=dim)
    points = (k + 1) * n
    applies = points if net_fwd else k * n
    extra_flops = 2 * applies * (20 * width + (3 * dim if gate else 0))
    extra_bytes = 4 * ((k + 1) * width + ((k + 1) * dim if gate else 0)
                       - (k * width + k * max(width - dim, 0)))
    out = {}
    for kind, bound in b.items():
        flops = bound["gflop"] * 1e9 + extra_flops * (2 if kind != "rollout" else 1)
        out[kind] = _bound(flops, bound["mbytes"] * 1e6 + extra_bytes)
    return out


def _ptxas(source, match="PisNet"):
    """{demangled kernel name: (registers, spill store bytes)} of every
    instance whose mangled name holds `match` (default: the PIS instances)
    in the ptxas report of csrc/<source>.cu's build."""
    import re

    from cmcd_tpu_torch.ops import build

    with open(build.build(source)[:-3] + ".log") as f:
        lines = f.read().splitlines()
    report, current = {}, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and current:
            report.setdefault(current, [None, None])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and current:
            report.setdefault(current, [None, None])[0] = int(m.group(1))
    names = [n for n in report if match in n]
    try:
        demangled = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                                   text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        demangled = names
    if len(demangled) != len(names):
        demangled = names
    clean = lambda d: d.replace("(anonymous namespace)::", "").replace("cmcd::", "").replace(
        "void ", "").split("(")[0]
    return {clean(d): tuple(report[n]) for n, d in zip(names, demangled)}


def phase_pis_timing():
    """CUDA-event and device times of every PIS form on its path's shape,
    beside its plain version, its bound and its registers and spills, and
    the two recipes' optimizer steps (phase 31)."""
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import CAIS, CAIS_VAR, ULA_SN
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )
    from cmcd_tpu_torch.ops.vargrad import (
        evolve_vargrad_bwd_replay,
        evolve_vargrad_bwd_replay_plain,
        evolve_vargrad_bwd_reroll,
        evolve_vargrad_bwd_reroll_plain,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    order = ("plain", "kernel", "kernel", "plain")
    n, k, units, eps, sigma, sched = PIS_FULL
    width = units[0]
    shapes = {  # form: (spec, target, N, K, init_eps, init_sigma, schedule, dim)
        "CAIS/many_gmm/dds": (CAIS, "many_gmm", n, k, eps, sigma, sched, 2),
        "CAIS/many_gmm/dds_grad": (CAIS, "many_gmm", n, k, eps, sigma, sched, 2),
        "ULA_sn/many_gmm/dds": (ULA_SN, "many_gmm", n, k, eps, sigma, sched, 2),
        "CAIS/gmm/dds": (CAIS, "gmm", 300, 8, 0.01, 1.0, "", 2),
        "CAIS/funnel/dds_grad": (CAIS, "funnel", 300, 8, 0.1, 1.0, "cos_sq", 10),
    }
    times, bounds_ = {}, {}
    for form, (spec, target, n_, k_, eps_, sig, sch, dim) in shapes.items():
        arch = form.split("/")[2]
        pos, kw, _ = _split(make_problem(n_, k_, 0, seed=2, sigma=sig, eps=eps_, target=target,
                                         net=arch, units=units))
        kw = dict(kw, grad_clipping=True, eps_schedule=sch)
        gen = torch.Generator(device="cuda").manual_seed(5)
        cot = torch.randn(n_, generator=gen, device="cuda")
        g_zf = torch.randn(n_, dim, generator=gen, device="cuda")
        _, _, traj, noise = evolve_overdamped_fused(*pos, spec, **kw, seed=seed,
                                                    return_trajectory=True, return_noise=True)
        plain_reps = 2 if k_ <= 8 else 1
        fns = {
            "rollout": (lambda: evolve_overdamped_fused(
                *pos, spec, **kw, seed=seed, return_trajectory=True, return_noise=True), 20),
            "rollout_plain": (lambda: evolve_overdamped_fused_plain(
                *pos, spec, **kw, seed=7, return_trajectory=True, return_noise=True), plain_reps),
            "sweep": (lambda: evolve_kl_bwd(traj, noise, cot, g_zf, *pos[2:], spec, **kw), 10),
            "sweep_plain": (lambda: evolve_kl_bwd_plain(traj, noise, cot, g_zf, *pos[2:], spec,
                                                        **kw), plain_reps),
        }
        t = times[form] = {key: [] for key in fns}
        for which in order:
            for kind in ("rollout", "sweep"):
                key = kind if which == "kernel" else f"{kind}_plain"
                fn, reps = fns[key]
                t[key].append(_event_ms(fn, reps))
        t["rollout_device"] = _device_ms(fns["rollout"][0], 10, "overdamped_rollout")
        t["sweep_device"] = _device_ms(fns["sweep"][0], 10, "kl_reverse_sweep")
        b = bounds_[form] = _work_pis(n_, k_, width, target, net_fwd=spec.fwd_sn, dim=dim,
                                      gate=arch == "dds_grad")
        print(f"[31 timing] {form} N={n_} K={k_} {units} ms {json.dumps(t)}; bounds rollout "
              f"{json.dumps(b['rollout'])} sweep {json.dumps(b['sweep'])}", flush=True)
    # The VarGrad backwards at their paths' shapes (replay N=2000, reroll
    # N=2000 and N=REROLL_N), K=256, init_sigma 15.
    for n_ in (n, REROLL_N):
        pos, kw, _ = _split(make_problem(n_, k, 0, seed=4, sigma=15.0, eps=eps, net="dds",
                                         units=units))
        kw = dict(kw, grad_clipping=True, eps_schedule=sched)
        cot = torch.randn(n_, generator=torch.Generator(device="cuda").manual_seed(6),
                          device="cuda")
        fns = {"reroll": (lambda: evolve_vargrad_bwd_reroll(pos[0], cot, *pos[2:], CAIS_VAR,
                                                            **kw, seed=seed), 3 if n_ > n else 10)}
        if n_ == n:
            _, _, traj = evolve_overdamped_fused(*pos, CAIS_VAR, **kw, seed=seed,
                                                 return_trajectory=True)
            fns.update({
                "replay": (lambda: evolve_vargrad_bwd_replay(traj, cot, *pos[2:], CAIS_VAR, **kw),
                           10),
                "replay_plain": (lambda: evolve_vargrad_bwd_replay_plain(
                    traj, cot, *pos[2:], CAIS_VAR, **kw), 1),
                "reroll_plain": (lambda: evolve_vargrad_bwd_reroll_plain(
                    pos[0], cot, *pos[2:], CAIS_VAR, **kw, seed=7), 1),
            })
        form = "VarGrad/many_gmm/dds" + ("" if n_ == n else f" N={n_}")
        t = times[form] = {key: [] for key in fns}
        for which in order:
            for key in fns:
                if key.endswith("_plain") == (which == "plain"):
                    fn, reps = fns[key]
                    t[key].append(_event_ms(fn, reps))
        for kind in ("replay", "reroll"):
            if kind in fns:
                t[f"{kind}_device"] = _device_ms(fns[kind][0], 3, f"vargrad_{kind}")
        b = bounds_[form] = _work_pis(n_, k, width)
        print(f"[31 timing] {form} N={n_} K={k} {units} ms {json.dumps(t)}; bounds replay "
              f"{json.dumps(b['replay'])} reroll {json.dumps(b['reroll'])}", flush=True)
    regs = {src: _ptxas(src) for src in ("overdamped", "kl", "vargrad")}
    print(f"[31 timing] registers and spill store bytes of the PIS instances (ptxas): "
          f"{json.dumps(regs)}", flush=True)
    step_ms = {}
    for name, flags in (("many_gmm_kl_dds", KL_DDS_FLAGS),
                        ("many_gmm_kl_dds_grad", KL_DDS_GRAD_FLAGS)):
        cfg, setup, target, params, ctx = flagship(flags + ["--config.iters", "0"])
        trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi,
                                             cfg.train_betas)
        fused_loss, _ = fused_training_path(setup, cfg.N)
        fused = lambda p, n_, c, s, generator: fused_loss(p, n_, c, s, target,
                                                          generator=generator)

        def steps(loss_fn, iters):
            g = torch.Generator(device="cuda").manual_seed(1)
            return lambda: train(setup, params, ctx, lr=cfg.lr, iters=iters, batch_size=cfg.N,
                                 generator=g, trainable=trainable, loss_fn=loss_fn,
                                 steps_per_call=max(iters, 1), nan_check_every=10**9)

        steps(fused, 5)()
        ms = step_ms[name] = {"eager": [], "kernel": []}
        for which in order:
            loss_fn, iters = (bounds.kl_bound, 1) if which == "plain" else (fused, 50)
            ms["eager" if which == "plain" else "kernel"].append(_wall_ms(steps(loss_fn, iters))
                                                                 / iters)
        ms["kernel_200"] = [_wall_ms(steps(fused, 200)) / 200]
        prof_wall, prof_dev, top = _profile(steps(fused, 10))
        ms["busy_ms"] = prof_dev / 10
        ms["busy_share_of_200"] = prof_dev / 10 / ms["kernel_200"][0]
        print(f"[31 timing] {name} optimizer step N={cfg.N} K={cfg.nbridges} ms per step "
              f"{json.dumps(ms)} (kernel: 50 steps, kernel_200: 200, eager: 1 per reading); 10 "
              f"fused steps under the profiler: wall {prof_wall!r} ms, device busy {prof_dev!r} "
              f"ms, device records {json.dumps(top)}", flush=True)
    return times, bounds_, regs, step_ms


def _pis_kernel_entries(compared, paths, timing, err_is):
    """The kernels line's entries of the PIS forms (phases 29-31): each
    form's launches on its own path (phase 30), its worst error against the
    plain version (phase 29), its times and bound on the path's shape
    (phase 31), its instance's registers and spill stores."""
    errors, clipped = compared
    times, bounds_, regs, _ = timing
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    target_t = {"many_gmm": "ManyGmmTarget", "gmm": "Gmm3Target", "funnel": "FunnelTarget"}

    def ptxas(source, kernel, *parts):
        return {name: v for name, v in regs[source].items()
                if f"{kernel}<" in name and all(p in name for p in parts)}

    entries = []
    for form in ("CAIS/many_gmm/dds", "CAIS/many_gmm/dds_grad", "ULA_sn/many_gmm/dds",
                 "CAIS/gmm/dds", "CAIS/funnel/dds_grad"):
        spec, target, arch = form.split("/")
        cais = spec == "CAIS"
        t, b, table = times[form], bounds_[form], paths[form]
        tt = target_t[target]
        extra = {"clipped_gate_elements": clipped.get(f"CAIS/{target}/{arch}")} \
            if arch == "dds_grad" and target == "many_gmm" else {}
        entries.append({
            "name": f"overdamped_rollout<{tt}, PisNet, {'true, 1' if cais else 'false, 0'}>",
            "route": "cuda", "source": "cmcd_tpu_torch/csrc/overdamped.cu",
            "replaces": "cmcd_tpu/ops/pallas_overdamped.py:102", "form": form,
            "launches": table[rollout][1][form],
            "max_abs_err": errors[f"rollout {spec}/{target}/{arch}"],
            "ms": min(t["rollout"]), "device_ms": t["rollout_device"],
            "plain_ms": min(t["rollout_plain"]), **keep(b["rollout"]), "library_ms": None,
            "registers_spill": ptxas("overdamped", "overdamped_rollout", tt), **extra,
        })
        entries.append({
            "name": f"kl_reverse_sweep<NG, {tt}, {'true' if cais else 'false'}, PisNet>",
            "route": "cuda", "source": "cmcd_tpu_torch/csrc/kl.cu",
            "replaces": "cmcd_tpu/ops/pallas_kl.py:49", "form": form,
            "launches": table[sweep][1][form],
            "max_abs_err": errors[f"sweep {spec}/{target}/{arch}"], "max_abs_err_is": err_is,
            "max_abs_err_by_groups": {g: errors.get(f"sweep {spec}/{target}/{arch}/NG={g}")
                                      for g in (2, 4)},
            "ms": min(t["sweep"]), "device_ms": t["sweep_device"],
            "plain_ms": min(t["sweep_plain"]), **keep(b["sweep"]), "library_ms": None,
            "registers_spill": ptxas("kl", "kl_reverse_sweep", tt), **extra,
        })
    t, b = times["VarGrad/many_gmm/dds"], bounds_["VarGrad/many_gmm/dds"]
    big_t, big_b = times[f"VarGrad/many_gmm/dds N={REROLL_N}"], \
        bounds_[f"VarGrad/many_gmm/dds N={REROLL_N}"]
    for kind, wrapper, replaces in (
            ("replay", "evolve_vargrad_bwd_replay", "cmcd_tpu/ops/pallas_vargrad.py:67"),
            ("reroll", "evolve_vargrad_bwd_reroll", "cmcd_tpu/ops/pallas_vargrad.py:385")):
        entries.append({
            "name": f"vargrad_{kind}<{'NG, ' if kind == 'reroll' else ''}ManyGmmTarget, PisNet>",
            "route": "cuda", "source": "cmcd_tpu_torch/csrc/vargrad.cu", "replaces": replaces,
            "form": "many_gmm/dds",
            "launches": paths[f"{kind}/many_gmm/dds"][wrapper][1]["many_gmm/dds"],
            "max_abs_err": errors[f"{kind}/many_gmm/dds"], "max_abs_err_is": err_is,
            "ms": min(t[kind]), "device_ms": t[f"{kind}_device"],
            "plain_ms": min(t[f"{kind}_plain"]), **keep(b[kind]), "library_ms": None,
            "registers_spill": ptxas("vargrad", f"vargrad_{kind}", "ManyGmmTarget"),
            **({"path_n": REROLL_N, "ms_at_path_n": min(big_t["reroll"]),
                "device_ms_at_path_n": big_t["reroll_device"],
                "bound_ms_at_path_n": big_b["reroll"]["bound_ms"],
                "max_abs_err_vs_replay_at_path_n": errors["reroll/many_gmm/dds/path_n"]}
               if kind == "reroll" else {}),
        })
    return entries

# lgcp_k8 (experiments/recipes.py:78-106): the 1600-D LGCP, MCD_CAIS_sn,
# N=20, K=8, emb 20, lr 1e-4 (LR_DICT), eps from 1e-5 trained, MFVI first;
# cut for the path to LGCP_MFVI_ITERS MFVI and LGCP_PATH_ITERS training
# steps (the recipe: 20 000 and 37 500), then the 30 x 500 evaluation.
LGCP_FLAGS = (
    "--config.model lgcp --config.boundmode MCD_CAIS_sn --config.N 20 "
    "--config.nbridges 8 --config.emb_dim 20 --config.n_samples 500 "
    "--config.n_input_dist_seeds 30 --config.log.every 1"
).split()
LGCP_WHITENED_FLAGS = LGCP_FLAGS + ["--config.use_whitened", "True"]
LGCP_MFVI_ITERS, LGCP_PATH_ITERS, LGCP_WHITENED_ITERS = 300, 300, 100
LGCP_D, LGCP_EMB = 1600, 20
LGCP_MU = math.log(126.0) - 0.5 * 1.91
# The inlined score and Hessian product against float64: float32 sums of
# 1600 products, held to 1e-5 of the largest entry (as the funnel's).
LGCP_SCORE_TOL = 1e-5


def make_lgcp_problem(n, k, *, seed, whitened=False, moved=False, eps=1e-5):
    """An LGCP problem as make_problem's, from a numpy seed: the geffner net
    at in_dim 1620 (factor_sn 0.3, a random embedding), z0 around 0 (the
    variational start, sigma 1) or, moved, around the posterior's level (mu
    unwhitened; 0.5 whitened), non-uniform betas, injected noise."""
    from cmcd_tpu_torch.ops.target_grads import score_for_target
    from cmcd_tpu_torch.schedules import betas_from_grid, make_beta_grid_params
    from cmcd_tpu_torch.targets import load_target
    from cmcd_tpu_torch.utils.convert import geffner_from_jax

    rng = np.random.default_rng(seed)
    dim, in_dim = LGCP_D, LGCP_D + LGCP_EMB
    dense = lambda i, o: {"w": rng.normal(0, math.sqrt(2 / (i + o)), (i, o)),
                          "b": rng.normal(0, 1e-2, o)}
    tree = {"layers": [dense(in_dim, in_dim), dense(in_dim, in_dim)],
            "head": dense(in_dim, dim), "emb": rng.normal(0, 1.0, (k, LGCP_EMB)),
            "factor_sn": np.float32(0.3)}
    dev = torch.device("cuda")
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mg, gx, tx = make_beta_grid_params(k, device=dev)
    mg = f32(rng.uniform(0.5, 1.5, mg.shape[0]))
    tgt = load_target("lgcp", type("C", (), {"use_whitened": whitened})(), device=dev)
    center = (0.5 if whitened else LGCP_MU) if moved else 0.0
    return dict(
        z0=f32(center + rng.standard_normal((n, dim))),
        w0=f32(rng.standard_normal(n)),
        betas=betas_from_grid(mg, gx, tx).contiguous(),
        eps=f32(eps),
        vd_mean=f32(center + 0.1 * rng.standard_normal(dim)),
        vd_logdiag=f32(0.1 * rng.standard_normal(dim)),
        grad_logp=score_for_target(tgt, dev),
        sn=geffner_from_jax(tree, dev),
        noise=f32(rng.standard_normal((k, n, dim))),
        dim=dim,
        nbridges=k,
    )


def _wide_wrappers():
    from cmcd_tpu_torch.ops.overdamped_wide import (
        evolve_overdamped_wide,
        evolve_overdamped_wide_plain,
    )

    return evolve_overdamped_wide, evolve_overdamped_wide_plain


def compare_split_sweep(case, tol):
    """The split sweep's kernel against its plain version on the plain
    rollout's path and noise with random cotangents: eps, betas, vd mean
    and logdiag, every net leaf (the batched weight pass on each side's
    gsn), g_z0 and gsn itself; the plain version in float64 arbitrates a
    leaf beyond `tol` (F64_SLACK)."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS
    from cmcd_tpu_torch.ops.kl_split import evolve_kl_split, evolve_kl_split_plain
    from cmcd_tpu_torch.ops.overdamped_wide import evolve_overdamped_wide_plain

    pos, args, noise = _split(case)
    _, _, traj = evolve_overdamped_wide_plain(*pos, CAIS, **args, noise=noise,
                                              return_trajectory=True)
    gen = torch.Generator(device="cuda").manual_seed(19)
    n = pos[0].shape[0]
    cot = torch.randn(n, generator=gen, device="cuda")
    g_zf = torch.randn(n, pos[0].shape[1], generator=gen, device="cuda")
    tree = lambda out: {**_flat(out[0]), "g_z0": out[1], "gsn": out[2]}
    got = tree(evolve_kl_split(traj, noise, cot, g_zf, *pos[2:], CAIS, **args))
    want = tree(evolve_kl_split_plain(traj, noise, cot, g_zf, *pos[2:], CAIS, **args))
    torch.cuda.synchronize()
    worst, leaf, _ = _grad_errors(got, want, tol)
    ref = tree(evolve_kl_split_plain(traj.double(), noise.double(), cot, g_zf, *pos[2:], CAIS,
                                     **args))
    ok, more = _arbitrate(got, want, ref, tol)
    return worst, f"worst relative error {worst:.3e} (leaf {leaf}), limit {tol}{more}", ok


def phase_lgcp_compare():
    """The wide forms against their plain versions (phase 32): the inlined
    LGCP score and Hessian product against float64, the wide rollout, its
    noise stack, the split sweep and whole lgcp_k8 steps."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS
    from cmcd_tpu_torch.ops.overdamped_wide import score_and_hvp

    errors, ok = {}, True

    def keep(key, value, good):
        nonlocal ok
        errors[key] = value
        ok &= bool(good)

    for whitened in (False, True):
        form = "lgcp_whitened" if whitened else "lgcp"
        for n in (20, 500):
            for moved in (False, True):
                case = make_lgcp_problem(n, 1, seed=3 + n, whitened=whitened, moved=moved)
                score, x = case["grad_logp"], case["z0"]
                u = torch.randn(x.shape, generator=torch.Generator(device="cuda").manual_seed(5),
                                device="cuda")
                g_k, h_k = score_and_hvp(score, x, u)
                g_p, h_p = score(x), score.hvp(x, u)
                g_d, h_d = score(x.double()), score.hvp(x.double(), u.double())
                rel = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())
                errs = {"score": rel(g_k, g_d), "hvp": rel(h_k, h_d),
                        "plain_score": rel(g_p, g_d), "plain_hvp": rel(h_p, h_d)}
                where = "moved" if moved else "init"
                print(f"[32 compare] {form} score and Hessian product N={n} {where} against "
                      f"float64 (relative to the largest entry, limit {LGCP_SCORE_TOL}): "
                      f"{json.dumps(errs)}", flush=True)
                keep(f"score {form} N={n} {where}", max(errs["score"], errs["hvp"]),
                     max(errs["score"], errs["hvp"]) <= LGCP_SCORE_TOL)
        for n, k, moved in ((20, 8, False), (20, 8, True), (500, 8, False), (37, 8, True)):
            case = make_lgcp_problem(n, k, seed=7 + n, whitened=whitened, moved=moved)
            stats, good = compare_arbitrated(case, CAIS, TOL_FULL, _wide_wrappers())
            where = "moved" if moved else "init"
            print(f"[32 compare] wide rollout {form} N={n} K={k} {where} (injected noise, "
                  f"TOL_FULL): {json.dumps(stats)} ok {good}", flush=True)
            keep(f"rollout {form} N={n} {where}", stats["z_max_abs"], good)
        stats, good = compare_noise_stack(make_lgcp_problem(20, 8, seed=11, whitened=whitened),
                                          CAIS, _wide_wrappers())
        print(f"[32 compare] wide rollout {form} noise stack: {json.dumps(stats)}", flush=True)
        keep(f"noise stack {form}", 0.0, good)
        for n in (20, 37):
            case = make_lgcp_problem(n, 8, seed=13 + n, whitened=whitened, moved=True)
            worst, line, good = compare_split_sweep(case, GRAD_TOL_FULL)
            print(f"[32 compare] split sweep {form} N={n} K=8: {line} ok {good}", flush=True)
            keep(f"sweep {form} N={n}", worst, good)
        flags = LGCP_WHITENED_FLAGS if whitened else LGCP_FLAGS
        good = compare_training_step(flags + ["--config.iters", "0"], f"lgcp_k8 {form}",
                                     arbitrate=True, tag="32 compare")
        keep(f"step {form}", 0.0, good)
    if not ok:
        fail(f"the wide forms disagree with their plain versions: {errors}")
    return errors


def phase_lgcp_path():
    """lgcp_k8's path through the CLI (phase 33): MFVI, then the wide
    rollout and the split sweep every step and the wide rollout once per
    evaluation group, no other kernel; unwhitened, then whitened."""
    rollout, sweep = "evolve_overdamped_wide", "evolve_kl_split"
    seeds = 30
    mfvi = ["--config.mfvi_iters", str(LGCP_MFVI_ITERS)]
    runs = {}
    for form, flags, iters, rise in (("CAIS/lgcp", LGCP_FLAGS, LGCP_PATH_ITERS, True),
                                     ("CAIS/lgcp_whitened", LGCP_WHITENED_FLAGS,
                                      LGCP_WHITENED_ITERS, False)):
        expect = {rollout: {form: iters + seeds}, sweep: {form: iters}}
        runs[form] = _od_path(flags + mfvi, iters, "33 path", expect, elbo_must_rise=rise)
    return {form: table for form, (table, _, _) in runs.items()}


def _work_wide(n, k, whitened, dim=LGCP_D, in_dim=LGCP_D + LGCP_EMB):
    """Least time the card could take for the wide forms at these shapes
    (the rule of _work): {"rollout" (with trajectory and noise stores),
    "rollout_nostore" (the evaluation's), "sweep"}. A point costs the net
    (layer 1's z part D x F, layer 2 F x F, the head D x F), the score (one
    D x D product, two whitened) and ~30 operations a dimension besides;
    the sweep the same again for the VJP in z and the Hessian product. The
    bytes: the weights and the target's matrix once, the states in and out."""
    points = (k + 1) * n
    net = 2 * (2 * dim * in_dim + in_dim * in_dim)
    score = 2 * dim * dim * (2 if whitened else 1)
    elem = 30 * dim
    weights = 4 * (2 * dim * in_dim + in_dim * in_dim + 2 * in_dim + dim + k * (in_dim + 20))
    consts = 4 * (dim * dim + dim + 2)
    io = 4 * (dim * n + 2 * n + 2 * dim + k)
    stores = 4 * dim * (points + k * n)
    fwd_flops = points * (net + score + elem)
    bwd_flops = points * (2 * (net + score) + 2 * elem)
    bwd_bytes = weights + consts + 4 * dim * (points + k * n) + 4 * (n + dim * n) \
        + 4 * (dim * points + dim * n) + 4 * (1 + k + 2 * dim)
    return {"rollout": _bound(fwd_flops, weights + consts + io + stores),
            "rollout_nostore": _bound(fwd_flops, weights + consts + io),
            "sweep": _bound(bwd_flops, bwd_bytes)}


def phase_lgcp_timing():
    """CUDA-event and device times of the wide forms at lgcp_k8's shapes
    beside their plain versions, bounds, registers and spills, and the
    lgcp_k8 optimizer step with its device busy share (phase 34)."""
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import CAIS
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.ops.kl_split import evolve_kl_split, evolve_kl_split_plain
    from cmcd_tpu_torch.ops.overdamped_wide import (
        evolve_overdamped_wide,
        evolve_overdamped_wide_plain,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    order = ("plain", "kernel", "kernel", "plain")
    times, bounds_ = {}, {}
    for whitened in (False, True):
        form = "CAIS/lgcp" + ("_whitened" if whitened else "")
        pos, kw, _ = _split(make_lgcp_problem(20, 8, seed=2, whitened=whitened, moved=True))
        big, big_kw, _ = _split(make_lgcp_problem(500, 8, seed=3, whitened=whitened, moved=True))
        gen = torch.Generator(device="cuda").manual_seed(5)
        cot = torch.randn(20, generator=gen, device="cuda")
        g_zf = torch.randn(20, LGCP_D, generator=gen, device="cuda")
        _, _, traj, noise = evolve_overdamped_wide(*pos, CAIS, **kw, seed=seed,
                                                   return_trajectory=True, return_noise=True)
        fns = {
            "rollout": (lambda: evolve_overdamped_wide(
                *pos, CAIS, **kw, seed=seed, return_trajectory=True, return_noise=True), 20),
            "rollout_plain": (lambda: evolve_overdamped_wide_plain(
                *pos, CAIS, **kw, seed=7, return_trajectory=True, return_noise=True), 5),
            "rollout_n500": (lambda: evolve_overdamped_wide(*big, CAIS, **big_kw, seed=seed), 5),
            "rollout_n500_plain": (lambda: evolve_overdamped_wide_plain(
                *big, CAIS, **big_kw, seed=7), 2),
            "sweep": (lambda: evolve_kl_split(traj, noise, cot, g_zf, *pos[2:], CAIS, **kw), 10),
            "sweep_plain": (lambda: evolve_kl_split_plain(traj, noise, cot, g_zf, *pos[2:], CAIS,
                                                          **kw), 2),
        }
        t = times[form] = {key: [] for key in fns}
        for which in order:
            for key, (fn, reps) in fns.items():
                if key.endswith("_plain") == (which == "plain"):
                    t[key].append(_event_ms(fn, reps))
        t["rollout_device"] = _device_ms(fns["rollout"][0], 5, "wide_rollout")
        t["rollout_n500_device"] = _device_ms(fns["rollout_n500"][0], 3, "wide_rollout")
        t["sweep_device"] = _device_ms(fns["sweep"][0], 5, "kl_split_sweep")
        b = bounds_[form] = {"rollout": _work_wide(20, 8, whitened)["rollout"],
                             "rollout_n500": _work_wide(500, 8, whitened)["rollout_nostore"],
                             "sweep": _work_wide(20, 8, whitened)["sweep"]}
        print(f"[34 timing] {form} ms {json.dumps(t)}; bounds {json.dumps(b)}", flush=True)
    regs = {src: _ptxas(src, match) for src, match in (("overdamped_wide", "wide_rollout"),
                                                       ("kl_split", "kl_split_sweep"))}
    print(f"[34 timing] registers and spill store bytes of the wide instances (ptxas): "
          f"{json.dumps(regs)}", flush=True)
    step_ms = {}
    for name, flags in (("lgcp_k8", LGCP_FLAGS), ("lgcp_k8 whitened", LGCP_WHITENED_FLAGS)):
        cfg, setup, target, params, ctx = flagship(flags + ["--config.iters", "0"])
        trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi,
                                             cfg.train_betas)
        fused_loss, _ = fused_training_path(setup, cfg.N)
        fused = lambda p, n_, c, s, generator: fused_loss(p, n_, c, s, target,
                                                          generator=generator)

        def steps(loss_fn, iters):
            g = torch.Generator(device="cuda").manual_seed(1)
            return lambda: train(setup, params, ctx, lr=cfg.lr, iters=iters, batch_size=cfg.N,
                                 generator=g, trainable=trainable, loss_fn=loss_fn,
                                 steps_per_call=max(iters, 1), nan_check_every=10**9)

        steps(fused, 5)()
        ms = step_ms[name] = {"eager": [], "kernel": []}
        for which in order:
            loss_fn, iters = (bounds.kl_bound, 2) if which == "plain" else (fused, 50)
            ms["eager" if which == "plain" else "kernel"].append(_wall_ms(steps(loss_fn, iters))
                                                                 / iters)
        ms["kernel_200"] = [_wall_ms(steps(fused, 200)) / 200]
        prof_wall, prof_dev, top = _profile(steps(fused, 10))
        ms["busy_ms"] = prof_dev / 10
        ms["busy_share_of_200"] = prof_dev / 10 / ms["kernel_200"][0]
        print(f"[34 timing] {name} optimizer step N={cfg.N} K={cfg.nbridges} ms per step "
              f"{json.dumps(ms)} (kernel: 50 steps, kernel_200: 200, eager: 2 per reading); 10 "
              f"fused steps under the profiler: wall {prof_wall!r} ms, device busy {prof_dev!r} "
              f"ms, device records {json.dumps(top)}", flush=True)
    return times, bounds_, regs, step_ms


def _lgcp_kernel_entries(errors, paths, timing):
    """The kernels line's entries of the wide forms (phases 32-34): each
    instance's launches on its own path (phase 33), its worst error against
    the plain version (phase 32), its times and bound at lgcp_k8's shapes
    (phase 34), its registers and spill stores."""
    times, bounds_, regs, _ = timing
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    entries = []
    for whitened in (False, True):
        name = "lgcp_whitened" if whitened else "lgcp"
        form, flag = f"CAIS/{name}", "true" if whitened else "false"
        t, b, table = times[form], bounds_[form], paths[form]
        entries.append({
            "name": f"wide_rollout<{flag}>", "route": "cuda",
            "source": "cmcd_tpu_torch/csrc/overdamped_wide.cu",
            "replaces": "cmcd_tpu/ops/pallas_overdamped.py:102", "form": form,
            "launches": table["evolve_overdamped_wide"][1][form],
            "max_abs_err": max(v for k, v in errors.items() if k.startswith(f"rollout {name} ")),
            "max_abs_err_is": "worst |z_kernel - z_plain| of the compares (TOL_FULL)",
            "ms": min(t["rollout"]), "device_ms": t["rollout_device"],
            "plain_ms": min(t["rollout_plain"]), **keep(b["rollout"]), "library_ms": None,
            "ms_at_n500": min(t["rollout_n500"]), "device_ms_at_n500": t["rollout_n500_device"],
            "plain_ms_at_n500": min(t["rollout_n500_plain"]),
            "bound_ms_at_n500": b["rollout_n500"]["bound_ms"],
            "score_err_vs_float64": max(v for k, v in errors.items()
                                        if k.startswith(f"score {name} ")),
            "registers_spill": {k: v for k, v in regs["overdamped_wide"].items()
                                if f"wide_rollout<{flag}>" in k},
        })
        entries.append({
            "name": f"kl_split_sweep<{flag}>", "route": "cuda",
            "source": "cmcd_tpu_torch/csrc/kl_split.cu",
            "replaces": "cmcd_tpu/ops/pallas_kl.py:49", "form": form,
            "launches": table["evolve_kl_split"][1][form],
            "max_abs_err": max(v for k, v in errors.items() if k.startswith(f"sweep {name} ")),
            "max_abs_err_is": "worst per-leaf |g_kernel - g_plain| / |g_plain| (gsn and g_z0 "
                              "included)",
            "ms": min(t["sweep"]), "device_ms": t["sweep_device"],
            "plain_ms": min(t["sweep_plain"]), **keep(b["sweep"]), "library_ms": None,
            "registers_spill": {k: v for k, v in regs["kl_split"].items()
                                if f"kl_split_sweep<{flag}>" in k},
        })
    return entries


# MCD_DNF (phases 35-37): zero drift and two geffner nets, the second in the
# backward mean, through B1's and B3's two-net forms (dnf_rollout<D>,
# kl_dnf_sweep<NG, D>, instantiated by the state's D). Paths: the KL cell's
# flags on many_gmm at full width, the gmm_cais flags and funnel_k8's, each
# with the mode swapped (the setup gives DNF no eps schedule, as JAX's).
DNF_KL_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_DNF" for f in KL_FLAGS]
GMM_DNF_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_DNF" for f in GMM_CAIS_FLAGS]
FUNNEL_DNF_FLAGS = [f if f != "MCD_CAIS_sn" else "MCD_DNF" for f in FUNNEL_FLAGS]
DNF_PATH_ITERS, DNF_SHORT_ITERS = 500, 200
# Each DNF form's shape (timing) and its path: N, K, emb, init_eps, init_sigma, flags.
DNF_FORMS = {
    "DNF/many_gmm": (2000, 256, 130, 0.1, 15.0, DNF_KL_FLAGS, DNF_PATH_ITERS),
    "DNF/gmm": (300, 8, 20, 0.01, 1.0, GMM_DNF_FLAGS, DNF_SHORT_ITERS),
    "DNF/funnel": (300, 8, 48, 0.1, 1.0, FUNNEL_DNF_FLAGS, DNF_SHORT_ITERS),
}


def phase_dnf_compare():
    """B1's and B3's DNF forms against their plain versions (phase 35), under
    injected noise: at the test size on many_gmm, gmm and the funnel (three
    schedules for the sweep; the noise stacks); at full width (many_gmm,
    N=2000 and 500, K=256, emb 130); at four groups (N=8192, K=8); on the
    funnel at funnel_k8's shape and at N=2000, K=256; the whole DNF steps of
    the three paths' flags. Rollouts TOL_SMALL / TOL_FULL, sweeps
    GRAD_TOL_SMALL / GRAD_TOL_FULL per leaf (sn2's included), the float64
    arbiter of PERF.md §2 where a chain or leaf misses."""
    from cmcd_tpu_torch.integrators.overdamped import DNF
    from cmcd_tpu_torch.ops.vargrad import sweep_grid

    ok, errors = True, {}

    def keep(key, value, n=None):
        keys = [key] + ([f"{key}/NG={sweep_grid(n, 'cuda')[0]}"] if n else [])
        for k in keys:
            errors[k] = max(errors.get(k, 0.0), value)

    for i, (target, sigma) in enumerate((("many_gmm", 8.0), ("gmm", 3.0), ("funnel", 1.0))):
        case = make_problem(256, 8, 16, seed=100 + i, sigma=sigma, target=target, sn2=True)
        stats, good = compare(case, DNF, TOL_SMALL)
        ok &= good
        keep(f"rollout DNF/{target}", max(stats["z_max_abs"], stats["w_max_abs"]))
        print(f"[35 compare] rollout small N=256 K=8 emb 16 DNF/{target}: {json.dumps(stats)}, "
              f"ok {good}", flush=True)
        stats, good = compare_noise_stack(case, DNF)
        ok &= good
        print(f"[35 compare] rollout noise stack N=256 K=8 DNF/{target}: {json.dumps(stats)}, "
              f"ok {good}", flush=True)
        case = make_problem(128, 6, 16, seed=104 + i, sigma=sigma, target=target, sn2=True)
        for sched in ("", "cos_sq", "linear"):
            worst, line, good = compare_sweep(case, GRAD_TOL_SMALL, arbitrate=True, spec=DNF,
                                              eps_schedule=sched)
            ok &= good
            keep(f"sweep DNF/{target}", worst, 128)
            print(f"[35 compare] KL sweep small N=128 K=6 DNF/{target} schedule {sched!r}: "
                  f"{line}, ok {good}", flush=True)
    # Full width: many_gmm at the KL cell's shape, and the evaluation's N=500.
    for n in (2000, 500):
        case = make_problem(n, 256, 130, seed=110, sigma=15.0, eps=0.1, sn2=True)
        stats, good = compare_arbitrated(case, DNF, TOL_FULL)
        ok &= good
        keep("rollout DNF/many_gmm", max(stats["z_max_abs"], stats["w_max_abs"]))
        print(f"[35 compare] rollout full N={n} K=256 emb 130 DNF/many_gmm: {json.dumps(stats)} "
              f"tol {json.dumps(TOL_FULL)}, ok {good}", flush=True)
        if n == 2000:
            worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=DNF)
            ok &= good
            keep("sweep DNF/many_gmm", worst, n)
            print(f"[35 compare] KL sweep full N={n} K=256 emb 130 DNF/many_gmm: {line}, ok "
                  f"{good}", flush=True)
    # Four groups: N=8192 at K=8 (more tiles than blocks), both D.
    big = 8192
    groups, blocks = sweep_grid(big, "cuda")
    if groups != 4 or blocks >= -(-big // 32):
        fail(f"N={big} does not take four groups with more tiles than blocks")
    for target, emb, sigma in (("many_gmm", 130, 8.0), ("funnel", 48, 1.0)):
        case = make_problem(big, 8, emb, seed=112, sigma=sigma, eps=0.1, target=target, sn2=True)
        worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=DNF)
        ok &= good
        keep(f"sweep DNF/{target}", worst, big)
        print(f"[35 compare] KL sweep four groups N={big} K=8 emb {emb} DNF/{target}: {line}, "
              f"ok {good}", flush=True)
    # The funnel at D = 10: funnel_k8's shape and the stress shape.
    for name, (n, k, emb, eps) in FUNNEL_SHAPES.items():
        case = make_problem(n, k, emb, seed=114, sigma=1.0, eps=eps, target="funnel", sn2=True)
        tol = TOL_SMALL if k <= 8 else TOL_FULL
        stats, good = compare_arbitrated(case, DNF, tol)
        ok &= good
        keep("rollout DNF/funnel", max(stats["z_max_abs"], stats["w_max_abs"]))
        print(f"[35 compare] rollout {name} N={n} K={k} emb {emb} DNF/funnel: "
              f"{json.dumps(stats)}, ok {good}", flush=True)
        worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, spec=DNF)
        ok &= good
        keep("sweep DNF/funnel", worst, n)
        print(f"[35 compare] KL sweep {name} N={n} K={k} emb {emb} DNF/funnel: {line}, ok "
              f"{good}", flush=True)
    for form, (_, _, _, _, _, flags, _) in DNF_FORMS.items():
        ok &= compare_training_step(flags + ["--config.iters", "0"], form, arbitrate=True,
                                    tag="35 compare")
    if not ok:
        fail("a DNF kernel form and its plain version disagree beyond tolerance")
    return errors


def phase_dnf_paths():
    """The DNF paths through the CLI (phase 36), each form's launches counted
    from 0 just before its run and no other kernel; the ELBO above its value
    at init on each."""
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    runs = {}
    for form, (_, _, _, _, _, flags, iters) in DNF_FORMS.items():
        expect = {rollout: {form: iters + 30}, sweep: {form: iters}}
        runs[form] = _od_path(flags, iters, "36 path", expect)
    return {key: table for key, (table, _, _) in runs.items()}


def _work_dnf(n, k, in_dim, dim=2):
    """Least time the card could take for one call of DNF's forms (the rule
    of _work): {"rollout" (with trajectory and noise stores), "sweep"}. Each
    step applies two nets and no score; the sweep transposes each net at the
    K points it served (3 in_dim^2 FMAs and the head's a point)."""
    points, applies = (k + 1) * n, 2 * k * n
    net_apply = in_dim * in_dim + 2 * dim * in_dim
    weights = 4 * (dim * in_dim + 2 * k * in_dim + in_dim * in_dim + in_dim + dim * in_dim + dim)
    fwd_flops = 2 * (applies * net_apply + k * n * 8 * dim)
    stores = 4 * dim * points + 4 * dim * k * n              # trajectory, noise
    fwd_bytes = 4 * ((dim + 1) * n + k) + 2 * weights + 4 * (dim + 1) * n + stores
    bwd_flops = 2 * (applies * (3 * in_dim * in_dim + (4 + 2 * dim) * in_dim) + points * 10 * dim)
    sums = 2 * 4 * (in_dim * in_dim + (1 + 2 * dim) * in_dim + 3 * dim + 2
                    + (k + 1) * (2 * in_dim + 2))
    bwd_bytes = stores + 4 * (n + k) + 2 * weights + 8 * dim * n + sums
    return {"rollout": _bound(fwd_flops, fwd_bytes), "sweep": _bound(bwd_flops, bwd_bytes)}


def phase_dnf_timing():
    """CUDA-event and device times of each DNF form at its path's shape (the
    rollout also at the evaluation's N=500 on many_gmm) beside its plain
    version, its bound and its instance's registers and spills, and the
    many_gmm DNF optimizer step (phase 37)."""
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import DNF
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    order = ("plain", "kernel", "kernel", "plain")
    times, bounds_ = {}, {}
    for form, (n, k, emb, eps, sigma, _, _) in DNF_FORMS.items():
        target = form.split("/")[1]
        pos, kw, _ = _split(make_problem(n, k, emb, seed=2, sigma=sigma, eps=eps, target=target,
                                         sn2=True))
        dim = pos[0].shape[1]
        gen = torch.Generator(device="cuda").manual_seed(5)
        cot = torch.randn(n, generator=gen, device="cuda")
        g_zf = torch.randn(n, dim, generator=gen, device="cuda")
        _, _, traj, noise = evolve_overdamped_fused(*pos, DNF, **kw, seed=seed,
                                                    return_trajectory=True, return_noise=True)
        plain_reps = 2 if k <= 8 else 1
        fns = {
            "rollout": (lambda: evolve_overdamped_fused(
                *pos, DNF, **kw, seed=seed, return_trajectory=True, return_noise=True), 20),
            "rollout_plain": (lambda: evolve_overdamped_fused_plain(
                *pos, DNF, **kw, seed=7, return_trajectory=True, return_noise=True), plain_reps),
            "sweep": (lambda: evolve_kl_bwd(traj, noise, cot, g_zf, *pos[2:], DNF, **kw), 10),
            "sweep_plain": (lambda: evolve_kl_bwd_plain(traj, noise, cot, g_zf, *pos[2:], DNF,
                                                        **kw), plain_reps),
        }
        t = times[form] = {key: [] for key in fns}
        for which in order:
            for kind in ("rollout", "sweep"):
                key = kind if which == "kernel" else f"{kind}_plain"
                fn, reps = fns[key]
                t[key].append(_event_ms(fn, reps))
        t["rollout_device"] = _device_ms(fns["rollout"][0], 10, "dnf_rollout")
        t["sweep_device"] = _device_ms(fns["sweep"][0], 10, "kl_dnf_sweep")
        b = bounds_[form] = _work_dnf(n, k, dim + emb, dim)
        if form == "DNF/many_gmm":  # the evaluation's rollout: N=500, no stores
            pos5, kw5, _ = _split(make_problem(500, k, emb, seed=3, sigma=sigma, eps=eps,
                                               sn2=True))
            ev = lambda: evolve_overdamped_fused(*pos5, DNF, **kw5, seed=seed)
            t["rollout_n500"] = [_event_ms(ev, 20)]
            t["rollout_n500_device"] = _device_ms(ev, 10, "dnf_rollout")
            b["rollout_n500"] = _work_dnf(500, k, dim + emb, dim)["rollout"]
        print(f"[37 timing] {form} N={n} K={k} emb {emb} ms {json.dumps(t)}; bounds "
              f"{json.dumps(b)}", flush=True)
    regs = {src: _ptxas(src, match) for src, match in (("overdamped", "dnf_rollout"),
                                                        ("kl", "kl_dnf_sweep"))}
    print(f"[37 timing] registers and spill store bytes of the DNF instances (ptxas): "
          f"{json.dumps(regs)}", flush=True)
    cfg, setup, target, params, ctx = flagship(DNF_KL_FLAGS + ["--config.iters", "0"])
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi,
                                         cfg.train_betas)
    fused_loss, _ = fused_training_path(setup, cfg.N)
    fused = lambda p, n_, c, s, generator: fused_loss(p, n_, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        g = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=cfg.lr, iters=iters, batch_size=cfg.N,
                             generator=g, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=max(iters, 1), nan_check_every=10**9)

    steps(fused, 5)()
    ms = {"eager": [], "kernel": []}
    for which in order:
        loss_fn, iters = (bounds.kl_bound, 1) if which == "plain" else (fused, 50)
        ms["eager" if which == "plain" else "kernel"].append(_wall_ms(steps(loss_fn, iters))
                                                             / iters)
    ms["kernel_200"] = [_wall_ms(steps(fused, 200)) / 200]
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    ms["busy_ms"] = prof_dev / 10
    ms["busy_share_of_200"] = prof_dev / 10 / ms["kernel_200"][0]
    print(f"[37 timing] DNF many_gmm optimizer step N={cfg.N} K={cfg.nbridges} ms per step "
          f"{json.dumps(ms)} (kernel: 50 steps, kernel_200: 200, eager: 1 per reading); 10 fused "
          f"steps under the profiler: wall {prof_wall!r} ms, device busy {prof_dev!r} ms, device "
          f"records {json.dumps(top)}", flush=True)
    return times, bounds_, regs, ms


def _dnf_kernel_entries(errors, paths, timing, err_is):
    """The kernels line's entries of the DNF forms (phases 35-37): each
    form's launches on its own path (phase 36), its worst error against the
    plain version (phase 35), its times and bound at the path's shape (phase
    37), its instance's registers and spill stores."""
    times, bounds_, regs, _ = timing
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    entries = []
    for form in DNF_FORMS:
        target = form.split("/")[1]
        d = 10 if target == "funnel" else 2
        t, b, table = times[form], bounds_[form], paths[form]
        rollout_extra = ({"ms_at_n500": min(t["rollout_n500"]),
                          "device_ms_at_n500": t["rollout_n500_device"],
                          "bound_ms_at_n500": b["rollout_n500"]["bound_ms"]}
                         if "rollout_n500" in t else {})
        entries.append({
            "name": f"dnf_rollout<{d}>", "route": "cuda",
            "source": "cmcd_tpu_torch/csrc/overdamped.cu",
            "replaces": "cmcd_tpu/ops/pallas_overdamped.py:102", "form": form,
            "launches": table["evolve_overdamped_fused"][1][form],
            "max_abs_err": errors[f"rollout {form}"],
            "ms": min(t["rollout"]), "device_ms": t["rollout_device"],
            "plain_ms": min(t["rollout_plain"]), **keep(b["rollout"]), "library_ms": None,
            "registers_spill": {n: v for n, v in regs["overdamped"].items() if f"<{d}>" in n},
            **rollout_extra,
        })
        entries.append({
            "name": f"kl_dnf_sweep<NG, {d}>", "route": "cuda",
            "source": "cmcd_tpu_torch/csrc/kl.cu",
            "replaces": "cmcd_tpu/ops/pallas_kl.py:49", "form": form,
            "launches": table["evolve_kl_bwd"][1][form],
            "max_abs_err": errors[f"sweep {form}"], "max_abs_err_is": err_is,
            "max_abs_err_by_groups": {g: errors.get(f"sweep {form}/NG={g}") for g in (2, 4)},
            "ms": min(t["sweep"]), "device_ms": t["sweep_device"],
            "plain_ms": min(t["sweep_plain"]), **keep(b["sweep"]), "library_ms": None,
            "registers_spill": {n: v for n, v in regs["kl"].items() if f", {d}>" in n},
        })
    return entries


# The Bayesian logistic regressions (phases 38-40): the posterior protocol
# of experiments/baseline_grid.py:55-58 (MCD_CAIS_sn, N=300, K=8, emb 20,
# init_eps 0.01, MFVI first, train_vi, train_eps, grad_clipping; the lr of
# config.LR_DICT, australian the default) through the CAIS rollout's and the
# CAIS sweep's logreg instances (csrc/overdamped_logreg.cu,
# csrc/kl_logreg.cu). The paths cut MFVI to LOGREG_MFVI_ITERS and training
# to LOGREG_PATH_ITERS steps, and evaluate 10 x 500 as the protocol does.
LOGREG_SETS = {"log_australian": 15, "log_ionosphere": 35, "log_sonar": 61}
LOGREG_MFVI_ITERS, LOGREG_PATH_ITERS = 500, 300
LOGREG_SEEDS = 10
LOGREG_SCORE_TOL = 1e-5


def logreg_flags(model):
    return (f"--config.model {model} --config.boundmode MCD_CAIS_sn --config.N 300 "
            "--config.nbridges 8 --config.emb_dim 20 --config.init_eps 0.01 "
            "--config.train_vi True --config.train_eps True --config.grad_clipping True "
            f"--config.mfvi_iters {LOGREG_MFVI_ITERS} --config.n_samples 500 "
            f"--config.n_input_dist_seeds {LOGREG_SEEDS} --config.log.every 1").split()


def _logreg_probe(model):
    """The logreg score and Hessian product through the probe kernel (the
    device functions the two kernels inline) against float64 at 512 points
    w = s z, z standard normal, s log-spaced from 1e-2 to 10 (logits past 88
    at the large end), u standard normal: per point |got - want64| over
    |w| + |want64| (score) or |u| + |want64| (product). Returns (errors,
    ok)."""
    from cmcd_tpu_torch.ops.overdamped import logreg_score_probe
    from cmcd_tpu_torch.ops.target_grads import score_for_target
    from cmcd_tpu_torch.targets import load_target

    target = load_target(model, device="cuda")
    score, dim = score_for_target(target, "cuda"), target.dim
    gen = torch.Generator(device="cuda").manual_seed(43)
    n = 512
    scale = torch.logspace(-2.0, 1.0, n, device="cuda")[:, None]
    w = scale * torch.randn(n, dim, generator=gen, device="cuda")
    u = torch.randn(n, dim, generator=gen, device="cuda")
    g_k, h_k = logreg_score_probe(score, w, u)
    torch.cuda.synchronize()
    got = {"score": g_k.double(), "hvp": h_k.double()}
    want32 = {"score": score(w).double(), "hvp": score.hvp(w, u).double()}
    want64 = {"score": score(w.double()), "hvp": score.hvp(w.double(), u.double())}
    base = {"score": w.double().norm(dim=1), "hvp": u.double().norm(dim=1)}
    logits = (w.double() @ score.x.double().T).abs().max()
    errs, ok = {"max_abs_logit": float(logits)}, True
    for what in ("score", "hvp"):
        row = base[what] + want64[what].norm(dim=1)
        e_k = float(((got[what] - want64[what]).norm(dim=1) / row).max())
        e_p = float(((want32[what] - want64[what]).norm(dim=1) / row).max())
        errs[what] = {"kernel_vs_float64": e_k, "float32_plain_vs_float64": e_p}
        ok &= bool(torch.isfinite(got[what]).all()) and e_k <= LOGREG_SCORE_TOL
    return errs, ok


def phase_logreg_compare():
    """The logistic regressions' instances against their plain versions and
    float64 (phase 38): the probe; at the test size (N=64, K=6, emb 16) and
    at the protocol's (N=300, K=8, emb 20, grad clipping) the CAIS rollout
    under injected noise with and without its stores, its noise stack, the
    CAIS sweep (the float64 arbiter of PERF.md §2); the sweep at four groups
    (N=8192, K=4); the whole MCD_CAIS_sn step of each set's flags."""
    from cmcd_tpu_torch.integrators.overdamped import CAIS
    from cmcd_tpu_torch.ops.vargrad import sweep_grid

    ok, errors = True, {}

    def keep(key, value, good, n=None):
        nonlocal ok
        ok &= bool(good)
        keys = [key] + ([f"{key}/NG={sweep_grid(n, 'cuda')[0]}"] if n else [])
        for k in keys:
            errors[k] = max(errors.get(k, 0.0), value)

    for i, model in enumerate(LOGREG_SETS):
        errs, good = _logreg_probe(model)
        keep(f"score {model}", max(errs["score"]["kernel_vs_float64"],
                                   errs["hvp"]["kernel_vs_float64"]), good)
        print(f"[38 compare] {model} score and Hessian product through the probe kernel against "
              f"float64 (relative to the point's scale, limit {LOGREG_SCORE_TOL}): "
              f"{json.dumps(errs)}, ok {good}", flush=True)
        for (n, k, emb, tol, gtol, clip) in ((64, 6, 16, TOL_SMALL, GRAD_TOL_SMALL, False),
                                             (300, 8, 20, TOL_FULL, GRAD_TOL_FULL, True)):
            case = make_problem(n, k, emb, seed=120 + i, sigma=0.3, eps=0.01, target=model)
            stats, good = compare_arbitrated(case, CAIS, tol, grad_clipping=clip)
            keep(f"rollout {model}", max(stats["z_max_abs"], stats["w_max_abs"]), good)
            print(f"[38 compare] rollout N={n} K={k} emb {emb} clip {clip} CAIS/{model}: "
                  f"{json.dumps(stats)}, ok {good}", flush=True)
            worst, line, good = compare_sweep(case, gtol, arbitrate=True, grad_clipping=clip)
            keep(f"sweep {model}", worst, good, n)
            print(f"[38 compare] KL sweep N={n} K={k} emb {emb} clip {clip} CAIS/{model}: "
                  f"{line}, ok {good}", flush=True)
        stats, good = compare_noise_stack(case)
        keep(f"noise stack {model}", 0.0, good)
        print(f"[38 compare] rollout noise stack N=300 K=8 CAIS/{model}: {json.dumps(stats)}, "
              f"ok {good}", flush=True)
        big = 8192
        groups, blocks = sweep_grid(big, "cuda")
        if groups != 4 or blocks >= -(-big // 32):
            fail(f"N={big} does not take four groups with more tiles than blocks")
        case = make_problem(big, 4, 20, seed=125 + i, sigma=0.3, eps=0.01, target=model)
        worst, line, good = compare_sweep(case, GRAD_TOL_FULL, arbitrate=True, grad_clipping=True)
        keep(f"sweep {model}", worst, good, big)
        print(f"[38 compare] KL sweep four groups N={big} K=4 emb 20 CAIS/{model}: {line}, ok "
              f"{good}", flush=True)
        good = compare_training_step(logreg_flags(model) + ["--config.iters", "0"],
                                     f"MCD_CAIS_sn {model}", arbitrate=True, tag="38 compare")
        keep(f"step {model}", 0.0, good)
    if not ok:
        fail(f"a logreg instance and its plain version disagree beyond tolerance: {errors}")
    return errors


def phase_logreg_paths():
    """Each set's protocol flags through the CLI (phase 39), cut to
    LOGREG_MFVI_ITERS MFVI and LOGREG_PATH_ITERS steps: the rollout and the
    sweep of the set's form launched iters + 10 and iters times, no other
    kernel, the ELBO above its value at init after the same MFVI."""
    rollout, sweep = "evolve_overdamped_fused", "evolve_kl_bwd"
    runs = {}
    for model in LOGREG_SETS:
        form = f"CAIS/{model}"
        expect = {rollout: {form: LOGREG_PATH_ITERS + LOGREG_SEEDS},
                  sweep: {form: LOGREG_PATH_ITERS}}
        runs[form] = _od_path(logreg_flags(model), LOGREG_PATH_ITERS, "39 path", expect)
    return {form: table for form, (table, _, _) in runs.items()}


def _work_logreg(n, k, dim, n_data, in_dim):
    """Least time the card could take for the logreg instances (the rule of
    _work): {"rollout" (with trajectory and noise stores), "sweep"}. A point
    costs the net (layer 1's z part D x F, layer 2 F x F, the head D x F) and
    the score's 2 n_data D FMAs; the sweep the net's apply and VJP (3 F^2 +
    4 D F) and the score and its Hessian product (4 n_data D). Bytes: the
    weights and the dataset once, the states, stores and sums."""
    points = (k + 1) * n
    weights = 4 * (2 * dim * in_dim + in_dim * in_dim + 2 * in_dim + dim + k * in_dim)
    data = 4 * (dim + 1) * n_data
    stores = 4 * dim * (points + k * n)
    fwd_flops = 2 * points * (in_dim * in_dim + 2 * dim * in_dim + 2 * n_data * dim)
    fwd_bytes = weights + data + 4 * (2 * (dim + 1) * n + k) + stores
    bwd_flops = 2 * points * (3 * in_dim * in_dim + 4 * dim * in_dim + 4 * n_data * dim)
    sums = 4 * (in_dim * in_dim + (1 + 2 * dim) * in_dim + 3 * dim + 3
                + (k + 1) * (2 * in_dim + 2))
    bwd_bytes = weights + data + stores + 4 * (n + 2 * dim * n + k) + sums
    return {"rollout": _bound(fwd_flops, fwd_bytes), "sweep": _bound(bwd_flops, bwd_bytes)}


def phase_logreg_timing():
    """CUDA-event and device times of both instances of each set at the
    protocol's N=300 for K=8 and K=256 beside their plain versions and
    bounds, the instances' registers and spills, and the log_sonar optimizer
    step with its device busy share (phase 40)."""
    from cmcd_tpu_torch import bounds
    from cmcd_tpu_torch.integrators.overdamped import CAIS
    from cmcd_tpu_torch.ops.fused_train import fused_training_path
    from cmcd_tpu_torch.ops.kl import evolve_kl_bwd, evolve_kl_bwd_plain
    from cmcd_tpu_torch.ops.overdamped import (
        evolve_overdamped_fused,
        evolve_overdamped_fused_plain,
    )
    from cmcd_tpu_torch.train import train

    seed = torch.tensor([7], device="cuda")
    order = ("plain", "kernel", "kernel", "plain")
    times, bounds_ = {}, {}
    for model, dim in LOGREG_SETS.items():
        for k in (8, 256):
            key = f"CAIS/{model} K={k}"
            case = make_problem(300, k, 20, seed=2, sigma=0.3, eps=0.01, target=model)
            pos, kw, _ = _split(case)
            kw = dict(kw, grad_clipping=True)
            gen = torch.Generator(device="cuda").manual_seed(5)
            cot = torch.randn(300, generator=gen, device="cuda")
            g_zf = torch.randn(300, dim, generator=gen, device="cuda")
            _, _, traj, noise = evolve_overdamped_fused(*pos, CAIS, **kw, seed=seed,
                                                        return_trajectory=True, return_noise=True)
            plain_reps = 2 if k <= 8 else 1
            fns = {
                "rollout": (lambda: evolve_overdamped_fused(
                    *pos, CAIS, **kw, seed=seed, return_trajectory=True, return_noise=True), 20),
                "rollout_plain": (lambda: evolve_overdamped_fused_plain(
                    *pos, CAIS, **kw, seed=7, return_trajectory=True, return_noise=True),
                    plain_reps),
                "sweep": (lambda: evolve_kl_bwd(traj, noise, cot, g_zf, *pos[2:], CAIS, **kw),
                          10),
                "sweep_plain": (lambda: evolve_kl_bwd_plain(traj, noise, cot, g_zf, *pos[2:],
                                                            CAIS, **kw), plain_reps),
            }
            t = times[key] = {name: [] for name in fns}
            # At K=256 a plain sweep takes ~1 s: read once, before the kernels.
            for which in order if k <= 8 else order[:3]:
                for kind in ("rollout", "sweep"):
                    name = kind if which == "kernel" else f"{kind}_plain"
                    fn, reps = fns[name]
                    t[name].append(_event_ms(fn, reps))
            t["rollout_device"] = _device_ms(fns["rollout"][0], 10, "overdamped_rollout")
            t["sweep_device"] = _device_ms(fns["sweep"][0], 10, "kl_reverse_sweep")
            n_data = case["grad_logp"].n_data
            b = bounds_[key] = _work_logreg(300, k, dim, n_data, dim + 20)
            print(f"[40 timing] {key} N=300 emb 20 ms {json.dumps(t)}; bounds {json.dumps(b)}",
                  flush=True)
    regs = {src: _ptxas(src, "LogregTarget") for src in ("overdamped_logreg", "kl_logreg")}
    print(f"[40 timing] registers and spill store bytes of the logreg instances (ptxas): "
          f"{json.dumps(regs)}", flush=True)
    cfg, setup, target, params, ctx = flagship(logreg_flags("log_sonar") + ["--config.iters", "0"])
    trainable = bounds.default_trainable(setup.mode, cfg.train_eps, cfg.train_vi,
                                         cfg.train_betas)
    fused_loss, _ = fused_training_path(setup, cfg.N)
    fused = lambda p, n_, c, s, generator: fused_loss(p, n_, c, s, target, generator=generator)

    def steps(loss_fn, iters):
        g = torch.Generator(device="cuda").manual_seed(1)
        return lambda: train(setup, params, ctx, lr=1e-3, iters=iters, batch_size=cfg.N,
                             generator=g, trainable=trainable, loss_fn=loss_fn,
                             steps_per_call=max(iters, 1), nan_check_every=10**9)

    steps(fused, 5)()
    ms = {"eager": [], "kernel": []}
    for which in order:
        loss_fn, iters = (bounds.kl_bound, 3) if which == "plain" else (fused, 50)
        ms["eager" if which == "plain" else "kernel"].append(_wall_ms(steps(loss_fn, iters))
                                                             / iters)
    ms["kernel_200"] = [_wall_ms(steps(fused, 200)) / 200]
    prof_wall, prof_dev, top = _profile(steps(fused, 10))
    ms["busy_ms"] = prof_dev / 10
    ms["busy_share_of_200"] = prof_dev / 10 / ms["kernel_200"][0]
    print(f"[40 timing] log_sonar optimizer step N={cfg.N} K={cfg.nbridges} ms per step "
          f"{json.dumps(ms)} (kernel: 50 steps, kernel_200: 200, eager: 3 per reading); 10 fused "
          f"steps under the profiler: wall {prof_wall!r} ms, device busy {prof_dev!r} ms, device "
          f"records {json.dumps(top)}", flush=True)
    return times, bounds_, regs, ms


def _logreg_kernel_entries(errors, paths, timing, err_is):
    """The kernels line's entries of the logreg instances (phases 38-40):
    each set's launches on its own path (phase 39), its worst error against
    the plain version (phase 38), its times and bound at N=300, K=8 (and
    K=256 beside them; phase 40), its registers and spill stores."""
    times, bounds_, regs, _ = timing
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    entries = []
    for model, dim in LOGREG_SETS.items():
        form = f"CAIS/{model}"
        t, t256 = times[f"{form} K=8"], times[f"{form} K=256"]
        b, b256 = bounds_[f"{form} K=8"], bounds_[f"{form} K=256"]
        table = paths[form]
        inst = f"LogregTarget<{dim}"
        for kind, name, source, replaces, wrapper in (
                ("rollout", f"overdamped_rollout<LogregTarget<{dim}>, GeffnerNet, true, 1>",
                 "cmcd_tpu_torch/csrc/overdamped_logreg.cu",
                 "cmcd_tpu/ops/pallas_overdamped.py:102", "evolve_overdamped_fused"),
                ("sweep", f"kl_reverse_sweep<NG, LogregTarget<{dim}>, true, GeffnerNet>",
                 "cmcd_tpu_torch/csrc/kl_logreg.cu", "cmcd_tpu/ops/pallas_kl.py:49",
                 "evolve_kl_bwd")):
            src = source.split("/")[-1][:-3]
            entries.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "form": form, "launches": table[wrapper][1][form],
                "max_abs_err": errors[f"{kind} {model}"],
                **({"max_abs_err_is": err_is,
                    "max_abs_err_by_groups": {g: errors.get(f"sweep {model}/NG={g}")
                                              for g in (2, 4)}} if kind == "sweep" else {}),
                "score_err_vs_float64": errors[f"score {model}"],
                "ms": min(t[kind]), "device_ms": t[f"{kind}_device"],
                "plain_ms": min(t[f"{kind}_plain"]), **keep(b[kind]), "library_ms": None,
                "ms_at_k256": min(t256[kind]), "device_ms_at_k256": t256[f"{kind}_device"],
                "plain_ms_at_k256": min(t256[f"{kind}_plain"]),
                "bound_ms_at_k256": b256[kind]["bound_ms"],
                "registers_spill": {n: v for n, v in regs[src].items() if inst in n},
            })
    return entries


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    everything = ",".join(str(p) for p in range(1, 41))
    ap.add_argument("--phases", default=everything,
                    help="comma-separated phases to run (default: all)")
    phases = {int(p) for p in ap.parse_args(argv).phases.split(",")}
    seconds = {}

    def run(p, fn, *args, default=None):
        """fn(*args) if phase p is asked for (else default), its seconds kept."""
        if p not in phases:
            return default
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[p] = round(seconds.get(p, 0.0) + time.perf_counter() - t0, 2)
        return out

    phases |= {1, 2}
    smi = run(1, phase_device)
    run(2, phase_build)
    errors = run(3, phase_compare)
    eval_launches = run(4, phase_main_path)
    run(5, phase_statistics)
    timing = run(6, phase_timing)
    train_launches = run(7, phase_training_path)
    train_timing = run(8, phase_training_timing)
    kl_launches = run(9, phase_kl_training_path)
    reroll = run(10, phase_reroll_path)
    kl_timing = run(11, phase_kl_timing)
    ud_errors = run(12, phase_ud_compare)
    ud_eval_launches, ud_init = run(13, phase_ud_eval_path, default=(None, None))
    if 14 in phases and ud_init is None:  # the ELBO at init that phase 14 must beat
        ud_init = run(14, phase_ud_eval_path)[1]
    ud_launches = run(14, phase_ud_training_path, ud_init)
    ud_timing = run(15, phase_ud_timing)
    uha_errors = run(16, phase_uha_compare)
    uha_eval_launches, uha_init = run(17, phase_uha_eval_path, default=(None, None))
    if 18 in phases and uha_init is None:  # the ELBO at init that phase 18 must beat
        uha_init = run(18, phase_uha_eval_path)[1]
    uha_launches = run(18, phase_uha_training_path, uha_init)
    uha_timing = run(19, phase_uha_timing)
    od_errors = run(20, phase_od_compare)
    od_paths = run(21, phase_od_paths)
    od_timing = run(22, phase_od_timing)
    funnel_errors = run(23, phase_funnel_compare)
    funnel_paths = run(24, phase_funnel_paths)
    funnel_timing = run(25, phase_funnel_timing)
    ud_new_errors = run(26, phase_ud_new_compare)
    ud_new_paths = run(27, phase_ud_new_paths)
    ud_new_timing = run(28, phase_ud_new_timing)
    pis_errors = run(29, phase_pis_compare)
    pis_paths = run(30, phase_pis_paths)
    pis_timing = run(31, phase_pis_timing)
    lgcp_errors = run(32, phase_lgcp_compare)
    lgcp_paths = run(33, phase_lgcp_path)
    lgcp_timing = run(34, phase_lgcp_timing)
    dnf_errors = run(35, phase_dnf_compare)
    dnf_paths = run(36, phase_dnf_paths)
    dnf_timing = run(37, phase_dnf_timing)
    logreg_errors = run(38, phase_logreg_compare)
    logreg_paths = run(39, phase_logreg_paths)
    logreg_timing = run(40, phase_logreg_timing)
    print(f"[seconds] by phase {json.dumps(seconds)}; total "
          f"{time.perf_counter() - t_start:.2f} s", flush=True)
    if phases != {int(p) for p in everything.split(",")}:
        print(smi)
        print(f"partial run (phases {sorted(phases)}): no result line")
        return 1
    times, step_ms = train_timing
    kl_times, kl_step_ms = kl_timing
    fwd_bound, bwd_bound, kl_bound, reroll_bound = _work(2000, 256, 132)
    keep = lambda b: {k: b[k] for k in ("bound_ms", "bound_by")}
    print(f"[bounds] N=2000 K=256 in_dim 132: rollout {json.dumps(fwd_bound)} backward "
          f"{json.dumps(bwd_bound)} KL sweep {json.dumps(kl_bound)} reroll "
          f"{json.dumps(reroll_bound)}; peaks {PEAK_FLOPS / 1e12} TFLOP/s FP32, "
          f"{PEAK_BYTES / 1e12} TB/s; evaluation N=500 rollout {timing[0]!r} ms (plain "
          f"{timing[1]!r}); optimizer step ms VarGrad {json.dumps(step_ms)} KL "
          f"{json.dumps(kl_step_ms)}")
    big_bound = _work(REROLL_N, 256, 132)[3]
    print(f"[bounds] N={REROLL_N} K=256 in_dim 132: reroll {json.dumps(big_bound)}")
    ud_times, ud_step_ms = ud_timing
    ud_bound, ud_stores_bound, ud_sweep_bound = _work_ud(2000, 256, 134)
    ud_bound_500 = _work_ud(500, 256, 134)[0]
    print(f"[bounds] N=2000 K=256 in_dim 134 (LDVI): underdamped rollout {json.dumps(ud_bound)} "
          f"with stores {json.dumps(ud_stores_bound)} (N=500: {json.dumps(ud_bound_500)}) "
          f"sweep {json.dumps(ud_sweep_bound)}; LDVI optimizer step ms {json.dumps(ud_step_ms)}")
    uha_times, uha_step_ms = uha_timing
    uha_bound, uha_stores_bound, uha_sweep_bound = _work_uha(2000, 256)
    uha_bound_500 = _work_uha(500, 256)[0]
    print(f"[bounds] N=2000 K=256 lfsteps 1 many_gmm (UHA): UHA rollout {json.dumps(uha_bound)} "
          f"with stores {json.dumps(uha_stores_bound)} (N=500: {json.dumps(uha_bound_500)}) "
          f"sweep {json.dumps(uha_sweep_bound)}; UHA optimizer step ms {json.dumps(uha_step_ms)}")
    od_times, od_bounds, od_step_ms = od_timing
    print(f"[bounds] overdamped forms (phase 22 shapes): "
          f"{json.dumps({f: {k: keep(b) for k, b in v.items()} for f, v in od_bounds.items()})}; "
          f"optimizer step ms {json.dumps(od_step_ms)}")
    funnel_times, funnel_bounds, funnel_step_ms = funnel_timing
    print(f"[bounds] D = 10 forms on the funnel (phase 25 shapes): "
          f"{json.dumps({f: {k: keep(b) for k, b in v.items()} for f, v in funnel_bounds.items()})}"
          f"; funnel_k8 optimizer step ms {json.dumps(funnel_step_ms)}")
    ud_new_times, ud_new_bounds, cais_uha_step_ms = ud_new_timing
    print(f"[bounds] the new underdamped and UHA forms (phase 28 shapes; rollout with stores, "
          f"sweep): {json.dumps({f: [keep(b[1]), keep(b[2])] for f, b in ud_new_bounds.items()})}"
          f"; CAIS_UHA funnel K=32 optimizer step ms {json.dumps(cais_uha_step_ms)}")
    print(f"[bounds] the PIS forms (phase 31 shapes): "
          f"{json.dumps({f: {k: keep(b) for k, b in v.items()} for f, v in pis_timing[1].items()})}"
          f"; recipe optimizer step ms {json.dumps(pis_timing[3])}")
    print(f"[bounds] the wide forms (phase 34 shapes): "
          f"{json.dumps({f: {k: keep(b) for k, b in v.items()} for f, v in lgcp_timing[1].items()})}"
          f"; lgcp_k8 optimizer step ms {json.dumps(lgcp_timing[3])}")
    print(f"[bounds] the DNF forms (phase 37 shapes): "
          f"{json.dumps({f: {k: keep(b) for k, b in v.items()} for f, v in dnf_timing[1].items()})}"
          f"; DNF many_gmm optimizer step ms {json.dumps(dnf_timing[3])}")
    print(f"[bounds] the logreg instances (phase 40 shapes): "
          f"{json.dumps({f: {k: keep(b) for k, b in v.items()} for f, v in logreg_timing[1].items()})}"
          f"; log_sonar optimizer step ms {json.dumps(logreg_timing[3])}")
    print(smi)
    # launches: of each kernel's own main path, counted from 0 just before it
    # (phase 7: VarGrad training and the 30 x 500 evaluation; phase 9: the KL
    # twin; phase 10: the re-rolling steps; phase 14: LDVI training and its
    # evaluation; phase 18: UHA training and its evaluation; phases 21 and
    # 24: each overdamped form's path); times, plain times and bounds at
    # N=2000, K=256 (the gmm forms at their recipes' shapes, the funnel's at
    # funnel_k8's and at the stress shape). No single PyTorch call computes
    # any of these functions.
    err_is = "worst per-leaf |g_kernel - g_plain| / |g_plain| at full width"
    print(json.dumps({"kernels": [{
        "name": "overdamped_rollout",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/overdamped.cu",
        "replaces": "cmcd_tpu/ops/pallas_overdamped.py:102",
        "launches": train_launches[0],
        "launches_evaluation_path": eval_launches,
        "launches_kl_path": kl_launches[0],
        "max_abs_err": errors[0],
        "ms": min(times["rollout_traj"]),
        "ms_with_noise_stack": min(kl_times["rollout_traj_noise"]),
        "plain_ms": min(times["rollout_traj_plain"]),
        **keep(fwd_bound),
        "library_ms": None,
    }, {
        "name": "vargrad_replay",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/vargrad.cu",
        "replaces": "cmcd_tpu/ops/pallas_vargrad.py:67",
        "launches": train_launches[1],
        "max_abs_err": errors[1],
        "max_abs_err_is": err_is,
        "ms": min(times["backward"]),
        "plain_ms": min(times["backward_plain"]),
        **keep(bwd_bound),
        "library_ms": None,
    }, {
        "name": "kl_reverse_sweep",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/kl.cu",
        "replaces": "cmcd_tpu/ops/pallas_kl.py:49",
        "launches": kl_launches[1],
        "max_abs_err": errors[2],
        "max_abs_err_is": err_is,
        "ms": min(kl_times["kl_sweep"]),
        "plain_ms": min(kl_times["kl_sweep_plain"]),
        **keep(kl_bound),
        "library_ms": None,
    }, {
        "name": "vargrad_reroll",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/vargrad.cu",
        "replaces": "cmcd_tpu/ops/pallas_vargrad.py:385",
        "launches": reroll[0],
        "max_abs_err": errors[3],
        "max_abs_err_is": err_is,
        "ms": min(kl_times["reroll"]),
        "plain_ms": min(kl_times["reroll_plain"]),
        **keep(reroll_bound),
        "library_ms": None,
        # At the re-rolling path's own N: the plain version in slices of
        # PLAIN_CHUNK chains (one wall-clock pass, phase 3).
        "path_n": REROLL_N,
        "max_abs_err_at_path_n": errors[4][0],
        "ms_at_path_n": min(kl_times["reroll_big"]),
        "plain_ms_at_path_n": errors[4][1],
        "bound_ms_at_path_n": big_bound["bound_ms"],
    }, {
        "name": "underdamped_rollout",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/underdamped.cu",
        "replaces": "cmcd_tpu/ops/pallas_underdamped.py:67",
        "launches": ud_launches[0],
        "launches_evaluation_path": ud_eval_launches,
        "max_abs_err": ud_errors[0],
        "ms": min(ud_times["rollout_stores"]),
        "ms_without_stores": min(ud_times["rollout"]),
        "ms_at_n500": min(ud_times["rollout_n500"]),
        "plain_ms": min(ud_times["rollout_stores_plain"]),
        **keep(ud_stores_bound),
        "bound_ms_without_stores": ud_bound["bound_ms"],
        "bound_ms_at_n500": ud_bound_500["bound_ms"],
        "library_ms": None,
    }, {
        "name": "kl_underdamped_sweep",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/kl_underdamped.cu",
        "replaces": "cmcd_tpu/ops/pallas_kl.py:983",
        "launches": ud_launches[1],
        "max_abs_err": ud_errors[1],
        "max_abs_err_is": err_is,
        "ms": min(ud_times["sweep"]),
        "plain_ms": min(ud_times["sweep_plain"]),
        **keep(ud_sweep_bound),
        "library_ms": None,
    }, {
        "name": "uha_rollout",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/uha.cu",
        "replaces": "cmcd_tpu/ops/pallas_uha.py:31",
        "launches": uha_launches[0],
        "launches_evaluation_path": uha_eval_launches,
        "max_abs_err": uha_errors[0],
        "ms": min(uha_times["rollout_stores"]),
        "ms_without_stores": min(uha_times["rollout"]),
        "ms_at_n500": min(uha_times["rollout_n500"]),
        "plain_ms": min(uha_times["rollout_stores_plain"]),
        **keep(uha_stores_bound),
        "bound_ms_without_stores": uha_bound["bound_ms"],
        "bound_ms_at_n500": uha_bound_500["bound_ms"],
        "library_ms": None,
    }, {
        "name": "kl_uha_sweep",
        "route": "cuda",
        "source": "cmcd_tpu_torch/csrc/kl_uha.cu",
        "replaces": "cmcd_tpu/ops/pallas_kl.py:1438",
        "launches": uha_launches[1],
        "max_abs_err": uha_errors[1],
        "max_abs_err_is": err_is,
        "ms": min(uha_times["sweep"]),
        "plain_ms": min(uha_times["sweep_plain"]),
        **keep(uha_sweep_bound),
        "library_ms": None,
    }] + _od_kernel_entries(od_errors, od_paths, od_times, od_bounds, err_is)
        + _funnel_kernel_entries(funnel_errors, funnel_paths, funnel_times, funnel_bounds,
                                 err_is)
        + _ud_new_kernel_entries(ud_new_errors, ud_new_paths, ud_new_times, ud_new_bounds,
                                 err_is)
        + _pis_kernel_entries(pis_errors, pis_paths, pis_timing, err_is)
        + _lgcp_kernel_entries(lgcp_errors, lgcp_paths, lgcp_timing)
        + _dnf_kernel_entries(dnf_errors, dnf_paths, dnf_timing, err_is)
        + _logreg_kernel_entries(logreg_errors, logreg_paths, logreg_timing, err_is)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
