"""Where the port creates its state.

Entry points and constructors run on the card unless the caller asks for
the CPU: `device=None` means "cuda" and raises when there is no card, so a
run never slides onto the CPU unnoticed. Functions that only receive
tensors follow their inputs and do not come through here.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when it is None; raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: cmcd_tpu_torch runs on the card by default; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    return torch.device("cuda")
