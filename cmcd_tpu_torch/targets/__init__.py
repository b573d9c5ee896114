"""Target registry: name -> Target (cmcd_tpu/targets/__init__.py).

Only many_gmm is ported; every other name raises NotImplementedError and
names the ROADMAP queue that holds it.
"""

from __future__ import annotations

from cmcd_tpu_torch.targets.base import Target
from cmcd_tpu_torch.utils.device import resolve_device


def load_target(name: str, config=None, device=None) -> Target:
    """Load a target density by name; config attributes as in cmcd_tpu.
    device=None is the card (utils/device.resolve_device)."""
    device = resolve_device(device)
    if name == "many_gmm":
        from cmcd_tpu_torch.targets.gmm import make_many_gmm

        get = lambda attr, default: getattr(config, attr, default)
        return make_many_gmm(
            n_mixes=get("n_mixes", 40),
            loc_scaling=get("loc_scaling", 40.0),
            device=device,
        )
    raise NotImplementedError(
        f"target {name!r} is not ported yet: see ROADMAP queue A "
        "(remaining overdamped targets)"
    )


__all__ = ["Target", "load_target"]
