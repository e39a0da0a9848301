"""HCEF online controller, paper Algorithms 2 and 3 (own copy of
``repro/core/controller.py``, numpy).

The coordinator receives per-device reports (sigma_n^2, G_n^2, mu_n,
alpha_n, nu_n), derives the per-round time/energy allowances from the
remaining budgets (constraints 15b/15c), and alternates P2.1 (theta | rho,
an LP solved by a greedy fractional knapsack) and P2.2 (rho | theta, a QP
solved by Lagrangian bisection).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class DeviceReports:
    """Algorithm 2 uploads, as (N,) arrays."""
    sigma2: np.ndarray
    G2: np.ndarray
    mu: np.ndarray     # seconds per local iteration
    alpha: np.ndarray  # joules per local iteration
    nu: np.ndarray     # seconds to upload one FULL model
    p: np.ndarray      # transmit power (W)


@dataclass
class BudgetState:
    time_budget: float
    energy_budget: float
    phi: int            # total global rounds
    q: int              # edge rounds per global round
    l: int = 0          # current global round
    r: int = 0          # current edge round
    time_spent_prev: float = 0.0     # Sum_{c<l} T^c
    energy_spent_prev: float = 0.0
    time_spent_this: float = 0.0     # Sum_{e<r} T^{l,e}
    energy_spent_this: float = 0.0
    backhaul_time: float = 0.0       # max_{i'} T_{i,i'}
    # The reference's population-mode sizes.  Nothing in the port reads
    # them; they are kept so that ``BudgetState(**meta["budget"])`` takes
    # the budget of a reference checkpoint, which carries both keys.
    population: int = 0
    cohort: int = 0

    def allowances(self):
        """Per-edge-round (time, energy) room implied by (15b)/(15c)."""
        rem_g = max(self.phi - self.l, 1)
        rem_e = max(self.q - self.r, 1)
        d_time = ((self.time_budget - self.time_spent_prev) / rem_g
                  - self.time_spent_this - self.backhaul_time) / rem_e
        d_energy = ((self.energy_budget - self.energy_spent_prev) / rem_g
                    - self.energy_spent_this) / rem_e
        return max(d_time, 0.0), max(d_energy, 0.0)


def solve_p21_theta(rho, reports: DeviceReports, d_time, d_energy, tau,
                    theta_min=0.05, *, return_infeasible: bool = False):
    """Exact LP: maximize sum rho_n theta_n subject to per-device time caps and
    the coupled energy budget.  Greedy fractional knapsack on rho/(p*nu).

    A device whose raw time cap ``(d_time - rho*tau*mu) / nu`` falls below
    ``theta_min`` cannot meet the per-round allowance even at minimum
    communication: the paper's box constraint still forces theta_min (the
    honest floor — a smaller theta does not exist in P2.1's domain), but
    silently CLIPPING the cap up would hide that the returned controls
    violate (15b).  With ``return_infeasible=True`` the per-device
    violation mask is returned alongside theta so the caller's
    ``BudgetState`` accounting (and its logs) stay truthful."""
    nu = np.maximum(reports.nu, 1e-12)
    raw_cap = (d_time - rho * tau * reports.mu) / nu
    infeasible = raw_cap < theta_min - 1e-12
    cap = np.clip(raw_cap, theta_min, 1.0)
    e_comm_room = d_energy - float(np.sum(rho * tau * reports.alpha))
    cost = reports.p * nu  # joules per unit theta
    base_cost = float(np.sum(cost * theta_min))
    room = e_comm_room - base_cost
    theta = np.full_like(rho, theta_min)
    if room <= 0:
        # budget exhausted: minimum communication
        return (theta, infeasible) if return_infeasible else theta
    eff = rho / np.maximum(cost, 1e-12)
    order = np.argsort(-eff)
    for n in order:
        add_full = (cap[n] - theta_min) * cost[n]
        if add_full <= room:
            theta[n] = cap[n]
            room -= add_full
        else:
            theta[n] = theta_min + room / max(cost[n], 1e-12)
            room = 0.0
            break
    theta = np.clip(theta, theta_min, 1.0)
    return (theta, infeasible) if return_infeasible else theta


def solve_p22_rho(theta, reports: DeviceReports, d_time, d_energy, tau,
                  rho_min=0.1, iters=50):
    """Exact separable QP via Lagrangian bisection on the energy multiplier.

    Per-device optimum: rho*(lam) = 1 - [(2-theta)(s2+G2) + lam*tau*alpha]
    / (6 G2), clipped to [rho_min, time_cap]."""
    s2 = float(np.mean(reports.sigma2))
    G2 = max(float(np.mean(reports.G2)), 1e-12)
    mu = np.maximum(reports.mu, 1e-12)
    cap = np.clip((d_time - theta * reports.nu) / (tau * mu), rho_min, 1.0)
    e_comp_room = d_energy - float(np.sum(reports.p * theta * reports.nu))

    def rho_of(lam):
        r = 1.0 - ((2.0 - theta) * (s2 + G2) + lam * tau * reports.alpha) \
            / (6.0 * G2)
        return np.clip(r, rho_min, cap)

    def energy(lam):
        return float(np.sum(rho_of(lam) * tau * reports.alpha))

    if energy(0.0) <= e_comp_room or e_comp_room <= 0:
        # lam=0 feasible, or budget below the rho_min floor (then the floor
        # is the best we can do).
        return rho_of(0.0)
    lo, hi = 0.0, 1.0
    while energy(hi) > e_comp_room and hi < 1e12:
        hi *= 4.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if energy(mid) > e_comp_room:
            lo = mid
        else:
            hi = mid
    return rho_of(hi)


def solve_p2(reports: DeviceReports, budget: BudgetState, tau,
             theta_min=0.05, rho_min=0.1, max_iters=8, eps=1e-4,
             fix_rho: Optional[float] = None,
             fix_theta: Optional[float] = None,
             diagnostics: Optional[dict] = None):
    """Alternating minimization (Algorithm 3). Returns (rho, theta).

    ``diagnostics``: optional dict filled in place with solver honesty
    flags — currently ``p21_time_infeasible``, the (N,) mask of devices
    whose theta_min floor already violates the per-round time allowance
    (the returned controls then exceed (15b); see ``solve_p21_theta``)."""
    N = len(reports.mu)
    d_time, d_energy = budget.allowances()
    s2 = float(np.mean(reports.sigma2))
    G2 = float(np.mean(reports.G2))
    rho = np.full(N, fix_rho if fix_rho is not None else 1.0)
    theta = np.full(N, fix_theta if fix_theta is not None else 1.0)
    infeasible = np.zeros(N, bool)
    prev = None
    for _ in range(max_iters):
        if fix_theta is None:
            theta, infeasible = solve_p21_theta(
                rho, reports, d_time, d_energy, tau, theta_min,
                return_infeasible=True)
        if fix_rho is None:
            rho = solve_p22_rho(theta, reports, d_time, d_energy, tau,
                                rho_min)
        z = np.concatenate([rho, theta])
        if prev is not None and np.max(np.abs(z - prev)) < eps:
            break
        prev = z
    if fix_theta is not None:
        # the fixed theta never went through P2.1: flag devices whose
        # fixed communication already breaks the time allowance.
        nu = np.maximum(reports.nu, 1e-12)
        infeasible = (rho * tau * reports.mu + theta * nu
                      > d_time + 1e-9)
    if diagnostics is not None:
        diagnostics["p21_time_infeasible"] = infeasible
    return rho, theta
