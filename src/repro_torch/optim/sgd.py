"""SGD with heavy-ball momentum on dicts of tensors (port of
``repro/optim/sgd.py:sgd_init``, ``sgd_update``).  AdamW waits for the LM
round (ROADMAP.md)."""
from __future__ import annotations

import torch


def sgd_init(params, momentum: float, state_dtype=torch.float32):
    if not momentum:
        return None
    return {k: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
            for k, p in params.items()}


def sgd_update(params, grads, mom_state, *, lr, momentum: float):
    """Returns (new_params, new_mom): m <- momentum * m + g and
    p <- p - lr * m in f32, as the reference does.  A zeroed gradient
    still decays m and moves p."""
    if not momentum or mom_state is None:
        return ({k: (p.float() - lr * grads[k].float()).to(p.dtype)
                 for k, p in params.items()}, mom_state)
    new_mom = {k: momentum * m + grads[k].to(m.dtype)
               for k, m in mom_state.items()}
    new_params = {k: (p.float() - lr * new_mom[k].float()).to(p.dtype)
                  for k, p in params.items()}
    return new_params, new_mom
