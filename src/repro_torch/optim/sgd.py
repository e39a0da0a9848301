"""SGD with heavy-ball momentum on dicts of tensors (port of
``repro/optim/sgd.py:sgd_init``, ``sgd_update``).  ``sgd_update`` returns
new tensors (the FedSim's vmapped steps); ``sgd_update_`` does the same
arithmetic in place (the round step: at mamba2-1.3B's width the momentum
alone is 6 GB a device).  The round uses only these; AdamW is not
ported."""
from __future__ import annotations

import torch


def sgd_init(params, momentum: float, state_dtype=torch.float32):
    if not momentum:
        return None
    return {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
            for k, p in params.items()}


def _in_type(momentum: float, dtype: torch.dtype) -> float:
    """The momentum factor as the reference multiplies by it: a Python
    float times a jax array takes the array's type, so a bf16 momentum
    buffer decays by bf16(0.9) = 0.8984375."""
    return float(torch.tensor(momentum, dtype=dtype))


def sgd_update(params, grads, mom_state, *, lr, momentum: float):
    """Returns (new_params, new_mom): m <- momentum * m + g and
    p <- p - lr * m in f32, as the reference does.  A zeroed gradient
    still decays m and moves p."""
    if not momentum or mom_state is None:
        return ({k: (p.float() - lr * grads[k].float()).to(p.dtype)
                 for k, p in params.items()}, mom_state)
    new_mom = {k: _in_type(momentum, m.dtype) * m + grads[k].to(m.dtype)
               for k, m in mom_state.items()}
    new_params = {k: (p.float() - lr * new_mom[k].float()).to(p.dtype)
                  for k, p in params.items()}
    return new_params, new_mom


@torch.no_grad()
def sgd_update_(params, grads, moms, *, lr, momentum: float):
    """``sgd_update`` in place, over parallel lists of tensors: m <-
    momentum * m + g (g cast to m's type first, each op rounded to m's
    type, as the reference), then p <- p - lr * m computed in f32 and
    cast to p's type (``moms`` may be None)."""
    if not momentum or moms is None:
        for p, g in zip(params, grads):
            p.sub_(g, alpha=lr)
        return
    for p, g, m in zip(params, grads, moms):
        m.mul_(_in_type(momentum, m.dtype)).add_(g.to(m.dtype))
        p.sub_(m, alpha=lr)
