"""Target registry: name -> Target (cmcd_tpu/targets/__init__.py).

many_gmm and the 3-mode gmm are ported; every other name raises
NotImplementedError and names the ROADMAP queue that holds it. Names are
matched as the JAX package matches them: "many_gmm" is tested before "gmm".
"""

from __future__ import annotations

from cmcd_tpu_torch.targets.base import Target
from cmcd_tpu_torch.utils.device import resolve_device


def load_target(name: str, config=None, device=None) -> Target:
    """Load a target density by name; config attributes as in cmcd_tpu.
    device=None is the card (utils/device.resolve_device)."""
    device = resolve_device(device)
    if "many_gmm" in name:
        from cmcd_tpu_torch.targets.gmm import make_many_gmm

        get = lambda attr, default: getattr(config, attr, default)
        return make_many_gmm(
            n_mixes=get("n_mixes", 40),
            loc_scaling=get("loc_scaling", 40.0),
            device=device,
        )
    if "gmm" in name:
        from cmcd_tpu_torch.targets.gmm import make_gmm

        return make_gmm(device=device)
    raise NotImplementedError(
        f"target {name!r} is not ported yet: see ROADMAP queue A "
        "(remaining overdamped targets)"
    )


__all__ = ["Target", "load_target"]
