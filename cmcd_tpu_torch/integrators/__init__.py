"""Integrator mode registry (cmcd_tpu/integrators/__init__.py).

Serves the overdamped modes ported so far; every other mode (DNF, the
underdamped family, UHA) raises NotImplementedError naming ROADMAP.
"""

from __future__ import annotations

from cmcd_tpu_torch.integrators import overdamped as od
from cmcd_tpu_torch.integrators.base import IntegratorContext

OVERDAMPED = {
    "MCD_ULA": od.ULA,
    "MCD_ULA_sn": od.ULA_SN,
    "MCD_CAIS_sn": od.CAIS,
    "MCD_CAIS_var_sn": od.CAIS_VAR,
}

MODES_WITH_STATE_SN = ["MCD_ULA_sn", "MCD_CAIS_sn", "MCD_CAIS_var_sn"]


def mode_uses_score_network(mode: str) -> bool:
    return mode in MODES_WITH_STATE_SN


def check_mode(mode: str) -> None:
    """Raise NotImplementedError unless `mode` is served here."""
    if mode not in OVERDAMPED:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet: see ROADMAP queue A"
        )


def evolve(z, betas, params, ctx: IntegratorContext, mode: str, *,
           noise=None, generator=None):
    """Dispatch to the stepper family of `mode`."""
    check_mode(mode)
    return od.evolve_overdamped(
        z, betas, params, ctx, OVERDAMPED[mode], noise=noise, generator=generator
    )
