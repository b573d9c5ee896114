"""Integrator mode registry (cmcd_tpu/integrators/__init__.py).

Serves all 13 boundmodes: the five overdamped ones (MCD_DNF with its second
net working, as in the JAX package), the seven underdamped ones and UHA; any
other name raises NotImplementedError.
"""

from __future__ import annotations

from cmcd_tpu_torch.integrators import overdamped as od
from cmcd_tpu_torch.integrators import underdamped as ud
from cmcd_tpu_torch.integrators import uha
from cmcd_tpu_torch.integrators.base import IntegratorContext

OVERDAMPED = {
    "MCD_ULA": od.ULA,
    "MCD_ULA_sn": od.ULA_SN,
    "MCD_CAIS_sn": od.CAIS,
    "MCD_CAIS_var_sn": od.CAIS_VAR,
    "MCD_DNF": od.DNF,
}

UNDERDAMPED = {
    "MCD_U_a-lp": ud.U_A_LP,
    "MCD_U_a-lp-sna": ud.U_A_LP_SNA,
    "MCD_U_a-lp-sn": ud.U_A_LP_SN,
    "MCD_U_e-lp": ud.U_E_LP,
    "MCD_U_e-lp-sna": ud.U_E_LP_SNA,
    "MCD_U_ea-lp-sn": ud.U_EA_LP_SN,
    "MCD_CAIS_UHA_sn": ud.CAIS_UHA,
}

ALL_MODES = ["UHA"] + list(OVERDAMPED) + list(UNDERDAMPED)

# Modes whose score net sees the state only, and those whose net sees
# [z, rho] (rho_dim = dim).
MODES_WITH_STATE_SN = ["MCD_ULA_sn", "MCD_U_e-lp-sna", "MCD_U_a-lp-sna", "MCD_CAIS_sn",
                       "MCD_CAIS_var_sn", "MCD_DNF"]
MODES_WITH_FULL_SN = ["MCD_U_a-lp-sn", "MCD_U_ea-lp-sn", "MCD_CAIS_UHA_sn"]


def mode_uses_score_network(mode: str) -> bool:
    return mode in MODES_WITH_STATE_SN or mode in MODES_WITH_FULL_SN


def mode_sn_rho_dim(mode: str, dim: int) -> int:
    return dim if mode in MODES_WITH_FULL_SN else 0


def check_mode(mode: str) -> None:
    """Raise NotImplementedError unless `mode` is served here."""
    if mode not in ALL_MODES:
        raise NotImplementedError(
            f"mode {mode!r} is not a boundmode: one of {ALL_MODES}"
        )


def evolve(z, betas, params, ctx: IntegratorContext, mode: str, *,
           noise=None, generator=None):
    """Dispatch to the stepper family of `mode`. noise: (K, N, dim) for an
    overdamped mode, (K + 1, N, dim) for an underdamped one or UHA (row 0 the
    initial momentum)."""
    check_mode(mode)
    if mode == "UHA":
        return uha.evolve_uha(z, betas, params, ctx, noise=noise, generator=generator)
    if mode in UNDERDAMPED:
        return ud.evolve_underdamped(
            z, betas, params, ctx, UNDERDAMPED[mode], noise=noise, generator=generator
        )
    return od.evolve_overdamped(
        z, betas, params, ctx, OVERDAMPED[mode], noise=noise, generator=generator
    )
