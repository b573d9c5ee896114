"""Config: the same field names and defaults as cmcd_tpu/config.py, as a
dataclass (no ml_collections), with the same LR / eps lookup tables."""

from __future__ import annotations

import dataclasses

LR_DICT = {
    "log_sonar": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_CAIS_var_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "log_ionosphere": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-4,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "lorenz": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-5,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-3,
        "MCD_ULA_sn": 1e-5,
        "MCD_ULA": 1e-5,
    },
    "brownian": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-4,
        "MCD_ULA": 1e-5,
    },
    "seeds": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-3,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "banana": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-3,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-3,
        "MCD_ULA_sn": 1e-3,
        "MCD_ULA": 1e-4,
    },
    "lgcp": {
        "MCD_CAIS_UHA_sn": 1e-3,
        "MCD_CAIS_sn": 1e-4,
        "MCD_U_a-lp-sn": 1e-3,
        "UHA": 1e-4,
        "MCD_ULA_sn": 1e-4,
        "MCD_ULA": 1e-4,
    },
}

FUNNEL_EPS_DICT = {
    8: {"init_eps": 0.1, "lr": 0.01},
    16: {"init_eps": 0.1, "lr": 0.01},
    32: {"init_eps": 0.1, "lr": 0.005},
    64: {"init_eps": 0.1, "lr": 0.001},
    128: {"init_eps": 0.01, "lr": 0.01},
    256: {"init_eps": 0.01, "lr": 0.005},
}

TRACTABLE_DISTS = ["nice", "funnel", "gmm", "many_gmm", "banana"]


@dataclasses.dataclass
class LogConfig:
    every: int = 0  # 0 = auto (0.1% of iters)
    jsonl: str = ""  # path for JSONL metrics; "" = stdout summary only


@dataclasses.dataclass
class Config:
    """Defaults of cmcd_tpu/config.py::get_config (field for field)."""

    boundmode: str = "UHA"
    model: str = "lorenz"
    N: int = 5
    nbridges: int = 8
    lfsteps: int = 1
    emb_dim: int = 20
    nlayers: int = 2
    init_eta: float = 0.0
    init_eps: float = 1e-5
    init_sigma: float = 1.0
    init_gamma: float = 10.0
    pretrain_mfvi: bool = True
    train_vi: bool = True
    train_eps: bool = True
    train_betas: bool = True
    nn_arch: str = "geffner"
    fully_connected_units: list = dataclasses.field(default_factory=lambda: [64, 64])
    eps_schedule: str = ""
    grad_clipping: bool = False
    remat_steps: bool = False
    mfvi_iters: int = 150000
    mfvi_lr: float = 0.01
    iters: int = 150000
    lr: float = 0.0001
    seed: int = 1
    n_samples: int = 500
    n_sinkhorn: int = 300
    n_input_dist_seeds: int = 30
    use_ema: bool = False
    # The fused evaluation path (the JAX package's Pallas switch, same name).
    # On a CUDA device it must stay on: evaluation runs the hand-written
    # rollout kernel. On the CPU it picks the kernel's plain twin over the
    # eager integrator.
    use_pallas_eval: bool = True
    # Training kernels only (cmcd_tpu/main.py:128-189); not ported yet.
    use_pallas_train: bool = True
    bf16_fused_net: bool = True
    bf16_residuals: bool = False
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    steps_per_call: int = 0
    resume: bool = False
    plot_dir: str = ""
    profile_dir: str = ""
    im_size: int = 14
    alpha: float = 0.05
    n_bits: int = 3
    hidden_dim: int = 1000
    nice_checkpoint: str = ""
    funnel_d: int = 10
    funnel_sig: int = 3
    funnel_clipy: int = 11
    use_whitened: bool = False
    file_path: str = ""
    gmm_easy_mode: bool = False
    n_mixes: int = 40
    loc_scaling: int = 40
    log: LogConfig = dataclasses.field(default_factory=LogConfig)


def get_config() -> Config:
    return Config()


def apply_lookup_tables(config) -> dict:
    """LR/eps overrides: funnel uses FUNNEL_EPS_DICT, gmm/many_gmm/banana/nice
    bypass, others use LR_DICT."""
    try:
        if config.model == "nice":
            return {}
        if config.model == "funnel":
            values = FUNNEL_EPS_DICT[config.nbridges]
            return {"init_eps": values["init_eps"], "lr": values["lr"]}
        if config.model in ("many_gmm", "gmm", "banana"):
            return {}
        return {"lr": LR_DICT[config.model][config.boundmode]}
    except KeyError:
        print(
            "LR not found for model %s and boundmode %s"
            % (config.model, config.boundmode)
        )
        return {}
