"""Faults planted in the program under test, each a function of the built
Program (harness.run_cell's `breaks`): the faults a cell's comparison has to
catch. The tests drive a whole run with each and see `correct` come out
false; on the chip, calibrate.py reads what each does to the compared
numbers.

  unchanged    a step that returns its state unchanged: training with a
               learning rate of 0; an evaluation whose rollout hands back
               its start.
  half_batch   half of the batch left out, the mean taken over the rest:
               the loss over the first half of the chains; each seed
               group's second half replaced by its first.
  altered      an answer altered where it is produced: chain 0's negative
               ELBO replaced by chain 1's, in the loss or in every seed
               group of a request.
"""

from __future__ import annotations

import torch


def _wrap(prog, loss_edit, elbo_edit, rollout=None):
    """The program's loss and ELBO functions with their negative ELBOs
    edited after the program made them."""
    from cmcd_tpu_torch.ops import compute_elbos_fused

    loss_fn, setup, target = prog.loss_fn, prog.setup, prog.target
    var = "var" in setup.mode

    def loss(p, n, c, s, generator):
        _, (neg, z) = loss_fn(p, n, c, s, generator=generator)
        used = loss_edit(neg)
        value = torch.clamp(torch.var(used, correction=0), -1e7, 1e7) if var else used.mean()
        return value, (neg, z)

    def elbos(p, n, g):
        neg, z = compute_elbos_fused(p, n, setup, target, generator=g, rollout=rollout)
        return elbo_edit(neg), z

    prog.loss_fn, prog.elbo_fn = loss, elbos


def unchanged(prog):
    prog.cfg.lr = 0.0
    _wrap(prog, lambda neg: neg, lambda neg: neg,
          rollout=lambda z0, w0, *args, **kwargs: (z0, w0))


def half_batch(prog):
    def repeat_first_half(neg):
        h = neg.shape[0] // 2
        return torch.cat([neg[:h], neg[:h], neg[2 * h:]])

    _wrap(prog, lambda neg: neg[:neg.shape[0] // 2], repeat_first_half)


def altered(prog):
    def swap(neg):
        out = neg.clone()
        out[0] = neg[1]
        return out

    _wrap(prog, swap, swap)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered}
