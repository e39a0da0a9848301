"""Round controllers, HCEF and the paper's benchmark schemes (Sec. 6.1),
and the pluggable local objective (port of ``repro/fl/baselines.py``).

The controllers are numpy, copied; the local objective works on dicts of
tensors."""
from __future__ import annotations

import numpy as np

from repro_torch.core.controller import solve_p2


class Controller:
    name = "base"

    def __init__(self, tau: int, theta_min=0.05, rho_min=0.1):
        self.tau = tau
        self.theta_min = theta_min
        self.rho_min = rho_min
        # solver flags of the last controls() call (p21_time_infeasible)
        self.diag: dict = {}

    def controls(self, reports, budget):
        raise NotImplementedError


class HCEF(Controller):
    """Joint adaptive rho and theta (Algorithm 3)."""
    name = "hcef"

    def controls(self, reports, budget):
        self.diag = {}
        return solve_p2(reports, budget, self.tau, self.theta_min,
                        self.rho_min, diagnostics=self.diag)


class CEF(Controller):
    """CE-FedAvg: heterogeneity-oblivious (rho = theta = 1)."""
    name = "cef"

    def controls(self, reports, budget):
        N = len(reports.mu)
        return np.ones(N), np.ones(N)


class CEF_F(Controller):
    """Adaptive local update frequency only (theta = 1)."""
    name = "cef_f"

    def controls(self, reports, budget):
        self.diag = {}
        return solve_p2(reports, budget, self.tau, self.theta_min,
                        self.rho_min, fix_theta=1.0, diagnostics=self.diag)


class CEF_C(Controller):
    """Adaptive compression only (rho = 1)."""
    name = "cef_c"

    def controls(self, reports, budget):
        self.diag = {}
        return solve_p2(reports, budget, self.tau, self.theta_min,
                        self.rho_min, fix_rho=1.0, diagnostics=self.diag)


class MLL_SGD(Controller):
    """rho_n proportional to device speed relative to the fastest device
    (Castiglia et al.); theta = 1."""
    name = "mll_sgd"

    def controls(self, reports, budget):
        inv = 1.0 / np.maximum(reports.mu, 1e-12)
        rho = inv / inv.max()
        return np.clip(rho, self.rho_min, 1.0), np.ones(len(rho))


CONTROLLERS = {c.name: c for c in (HCEF, CEF, CEF_F, CEF_C, MLL_SGD)}


def make_controller(name: str, tau: int, **kw) -> Controller:
    return CONTROLLERS[name](tau, **kw)


LOCAL_OBJECTIVES = ("sgd", "fedprox")


def make_local_objective(name: str, loss_fn, *, prox_mu: float = 0.01):
    """``objective(params, batch, anchor)`` for the tau local steps.

    ``sgd``: the loss, anchor ignored.  ``fedprox``: loss +
    (prox_mu / 2) ||params - anchor||^2 with the anchor at the round-start
    model (Li et al., MLSys 2020); the anchor is a constant of the step."""
    if name == "sgd":
        return lambda params, batch, anchor: loss_fn(params, batch)
    if name == "fedprox":
        mu = float(prox_mu)

        def objective(params, batch, anchor):
            loss = loss_fn(params, batch)
            prox = sum(((w - anchor[k].to(w.dtype)) ** 2).sum()
                       for k, w in params.items())
            return loss + (mu / 2.0) * prox.to(loss.dtype)

        return objective
    raise ValueError(f"unknown local objective {name!r} "
                     f"(expected 'sgd' or 'fedprox')")
