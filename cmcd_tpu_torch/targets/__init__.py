"""Target registry: name -> Target (cmcd_tpu/targets/__init__.py).

many_gmm, the 3-mode gmm, Neal's funnel, the 1600-D LGCP and the Bayesian
logistic regressions on australian, ionosphere and sonar are ported; every
other name (log_a1a and log_madelon among them) raises NotImplementedError
and names the ROADMAP queue that holds it. Names are matched as the JAX
package matches them: "funnel" first, then "lgcp", then "many_gmm" before
"gmm", then the logistic regressions by their whole name.
"""

from __future__ import annotations

from cmcd_tpu_torch.targets.base import Target
from cmcd_tpu_torch.utils.device import resolve_device


def load_target(name: str, config=None, device=None) -> Target:
    """Load a target density by name; config attributes as in cmcd_tpu.
    device=None is the card (utils/device.resolve_device)."""
    device = resolve_device(device)
    get = lambda attr, default: getattr(config, attr, default)
    if "funnel" in name:
        from cmcd_tpu_torch.targets.funnel import make_funnel

        return make_funnel(d=get("funnel_d", 10), sig=get("funnel_sig", 3.0),
                           clip_y=get("funnel_clipy", 11.0))
    if "lgcp" in name:
        from cmcd_tpu_torch.targets.lgcp import make_lgcp

        return make_lgcp(use_whitened=get("use_whitened", False),
                         file_path=get("file_path", None) or None,  # "" -> bundled pines.csv
                         device=device)
    if "many_gmm" in name:
        from cmcd_tpu_torch.targets.gmm import make_many_gmm

        return make_many_gmm(
            n_mixes=get("n_mixes", 40),
            loc_scaling=get("loc_scaling", 40.0),
            device=device,
        )
    if "gmm" in name:
        from cmcd_tpu_torch.targets.gmm import make_gmm

        return make_gmm(device=device)
    if name in ("log_australian", "log_ionosphere", "log_sonar"):
        from cmcd_tpu_torch.targets.logreg import make_logreg

        return make_logreg(name[len("log_"):], device=device)
    if name in ("log_a1a", "log_madelon"):
        raise NotImplementedError(
            f"target {name!r} is not ported yet: see ROADMAP queue A "
            f"({'A5c2' if name == 'log_a1a' else 'A5c3'}, the logistic regressions on the "
            "larger datasets)"
        )
    raise NotImplementedError(
        f"target {name!r} is not ported yet: see ROADMAP queue A "
        "(A5c, the rest of the target zoo)"
    )


__all__ = ["Target", "load_target"]
