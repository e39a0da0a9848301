"""FedSim: the paper's CFEL training round, Algorithm 1 end to end (port of
``repro/runtime/driver.py``, its fault-free branch).

Generic over the model (``loss_fn`` / ``acc_fn`` on a dict of tensors).
Each round runs:
  * tau Bernoulli-masked local SGD steps per device (Eq. 4/6), batched over
    the devices with ``torch.func.vmap``;
  * Algorithm 2: per-device (sigma^2, G^2) from two independent minibatch
    gradients at the round-start model;
  * the controller (HCEF / CEF / CEF-F / CEF-C / MLL-SGD);
  * block top-k compression Q with error feedback (Eq. 7), through the
    top-k kernel on the card;
  * the intra-cluster mean, and gossip with H every q-th round (Eq. 5);
  * the time and energy of the round (Eq. 8/9) against the budgets.

Two draws of the reference come from ``jax.random`` and cannot be
reproduced here, so they are inputs: the initial parameters (``params0``)
and the masked-step bits (``bits_fn(key, rho) -> (N, tau)``, called with
the integer the reference turns into its PRNG key).  The numpy stream is
consumed in the reference's order: each device's batch indices, then the
key integer.

Fault injection (``chaos``) and population mode wait for the degraded-mode
and cohort slice (ROADMAP.md, modules to port, item 2); asking for either
raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import validate_theta_levels
from repro_torch.core.compression import (cluster_levels_from_theta,
                                          compress_delta, quantize_theta)
from repro_torch.core.controller import BudgetState
from repro_torch.core.mixing import check_mixing, make_mixing
from repro_torch.core.round import bernoulli_bits
from repro_torch.device import from_numpy, resolve
from repro_torch.fl.baselines import Controller, make_local_objective
from repro_torch.fl.cost_model import round_energy, round_time
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.optim.sgd import sgd_update
from repro_torch.runtime.checkpoint import load_pytree, save_pytree

_NOT_PORTED = ("ROADMAP.md, modules to port, item 2 (degraded mode and "
               "cohorts)")


@dataclass
class FedSimConfig:
    n_devices: int = 16
    n_clusters: int = 4
    tau: int = 5
    q: int = 5
    eta: float = 0.05
    momentum: float = 0.9
    batch_size: int = 20
    block_size: int = 256
    theta_min: float = 0.05
    rho_min: float = 0.1
    backhaul: str = "ring"
    p_edge: float = 0.4  # for erdos_renyi
    seed: int = 0
    # sparse gossip: theta rounded up to theta_levels, and time/energy
    # charged at the wire format's exact byte ratio
    sparse_gossip: bool = False
    theta_levels: tuple = (0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
    wire_dtype: str = "f32"  # f32 | bf16 | int8 | int4 | fp8
    wire_block: int = 1024
    population: int = 0  # > 0: not ported yet (raises in FedSim)
    local_objective: str = "sgd"  # 'sgd' | 'fedprox'
    prox_mu: float = 0.01

    def __post_init__(self):
        if self.wire_dtype not in ("f32", "bf16", "int8", "int4", "fp8"):
            raise ValueError(f"wire_dtype {self.wire_dtype!r}")
        if self.sparse_gossip:
            validate_theta_levels(self.theta_levels)
        if self.local_objective not in ("sgd", "fedprox"):
            raise ValueError(f"local_objective {self.local_objective!r}")


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return from_numpy(np.asarray(x), device)


class FedSim:
    def __init__(self, cfg: FedSimConfig, *, params0, loss_fn, acc_fn,
                 device_data: List, test_data, controller: Controller,
                 het: HeterogeneityModel, time_budget: float = np.inf,
                 energy_budget: float = np.inf, phi: int = 10_000,
                 bits_fn: Optional[Callable] = None, device=None,
                 chaos=None):
        if chaos is not None:
            raise NotImplementedError(f"FedSim fault injection is not "
                                      f"ported yet: {_NOT_PORTED}")
        if cfg.population:
            raise NotImplementedError(f"FedSim population mode is not "
                                      f"ported yet: {_NOT_PORTED}")
        self.cfg = cfg
        self.device = resolve(device)
        self.loss_fn = loss_fn
        self.acc_fn = acc_fn
        self.controller = controller
        self.het = het
        N, C = cfg.n_devices, cfg.n_clusters
        assert N % C == 0
        self.dev_per_cluster = N // C
        self.cluster_of = np.repeat(np.arange(C), self.dev_per_cluster)
        H = make_mixing(cfg.backhaul, C, cfg.p_edge, cfg.seed)
        check_mixing(H)
        self.H = torch.as_tensor(H, dtype=torch.float32, device=self.device)

        stack = lambda t: t[None].repeat((N,) + (1,) * t.ndim)
        self.params = {k: stack(_as_tensor(p, self.device))
                       for k, p in params0.items()}
        self.mom = ({k: torch.zeros_like(p) for k, p in self.params.items()}
                    if cfg.momentum else None)
        self.ef = {k: torch.zeros_like(p) for k, p in self.params.items()}
        # every device's shard is uploaded once; batches are gathered on
        # the device from host-drawn indices
        self._sizes = [len(xs) for xs, _ in device_data]
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)[:-1]])
        self._X = _as_tensor(np.concatenate([xs for xs, _ in device_data]),
                             self.device)
        self._Y = _as_tensor(np.concatenate([ys for _, ys in device_data]),
                             self.device)
        self.test_data = tuple(_as_tensor(a, self.device) for a in test_data)
        self.budget = BudgetState(
            time_budget=time_budget, energy_budget=energy_budget,
            phi=phi, q=cfg.q, backhaul_time=het.backhaul_time())
        self.round = 0
        self.rng = np.random.default_rng(cfg.seed + 1)
        self.history: List[Dict] = []
        self.cluster_staleness = np.zeros(C, np.int64)  # fault-free: zeros
        self.bits_fn = bits_fn or functools.partial(bernoulli_bits,
                                                    tau=cfg.tau)
        # host-clock ms per phase of each round (synchronised), when a dict
        self.timings: Optional[Dict[str, List[float]]] = None
        # host-clock ms of each round that run() ran (synchronised)
        self.round_ms: List[float] = []

        local_obj = make_local_objective(cfg.local_objective, loss_fn,
                                         prox_mu=cfg.prox_mu)
        self._step_grad = torch.func.vmap(
            torch.func.grad_and_value(local_obj))
        self._stats = torch.func.vmap(self._stats_one)

    # ------------------------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _phase(self, name):
        if self.timings is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.timings.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)

    def _sample_batches(self, tau_plus: int):
        """(N, tau_plus, bs, ...) batches: indices drawn per device from the
        numpy stream, in the reference's order, gathered on the device."""
        idx = np.stack([
            off + self.rng.integers(0, n, (tau_plus, self.cfg.batch_size))
            for off, n in zip(self._offsets, self._sizes)])
        gi = torch.from_numpy(idx).to(self.device)
        return {"images": self._X[gi], "labels": self._Y[gi]}

    def device_round(self, batches, bits):
        """tau masked local steps per device (driver.py:181-199).
        batches: dict of (N, tau, bs, ...); bits: (N, tau).  A masked step
        zeroes the gradient but still applies the momentum update.
        Returns (delta, new_mom, per-device mean loss)."""
        cfg = self.cfg
        x0 = self.params
        p, m = x0, self.mom
        losses = []
        for t in range(cfg.tau):
            batch = {k: v[:, t] for k, v in batches.items()}
            g, loss = self._step_grad(p, batch, x0)
            bit = bits[:, t]
            g = {k: a * bit.view((-1,) + (1,) * (a.ndim - 1)).to(a.dtype)
                 for k, a in g.items()}
            p, m = sgd_update(p, g, m, lr=cfg.eta, momentum=cfg.momentum)
            losses.append(loss)
        delta = {k: p[k] - x0[k] for k in x0}
        return delta, m, torch.stack(losses, 1).mean(1)

    def _stats_one(self, params, b1, b2):
        grad = torch.func.grad(self.loss_fn)
        g1, g2 = grad(params, b1), grad(params, b2)
        diff2 = sum(((g1[k] - g2[k]) ** 2).sum() for k in g1)
        mean2 = sum(((0.5 * (g1[k] + g2[k])) ** 2).sum() for k in g1)
        sigma2 = 0.5 * diff2
        return sigma2, torch.clamp_min(mean2 - 0.5 * sigma2, 1e-8)

    def stats(self, b1, b2):
        """Algorithm 2 (driver.py:201-212): per-device sigma^2 =
        ||g1 - g2||^2 / 2 and G^2 = max(||(g1 + g2) / 2||^2 - sigma^2 / 2,
        1e-8) at the round-start model.  Returns two (N,) tensors."""
        return self._stats(self.params, b1, b2)

    def aggregate(self, comp, gossip: bool):
        """Eq. 5 (driver.py:216-229): each cluster's model plus the mean of
        its devices' compressed deltas, mixed with H on gossip rounds, and
        broadcast back to the cluster's devices."""
        C, Dev = self.cfg.n_clusters, self.dev_per_cluster
        out = {}
        for k, x0 in self.params.items():
            tail = x0.shape[1:]
            y = x0.reshape(C, Dev, *tail)[:, 0]
            y = y + comp[k].reshape(C, Dev, *tail).mean(dim=1)
            if gossip:
                y = torch.einsum("ij,j...->i...", self.H, y)
            out[k] = y[:, None].expand(C, Dev, *tail).reshape(C * Dev, *tail)
        return out

    # ------------------------------------------------------------------
    def run_round(self) -> Dict:
        cfg = self.cfg
        r = self.budget.r
        reports = self.het.sample_round(self.round)
        batches = self._sample_batches(cfg.tau + 2)
        main_b = {k: v[:, :cfg.tau] for k, v in batches.items()}
        with self._phase("stats"):
            s2, G2 = self.stats(
                {k: v[:, cfg.tau] for k, v in batches.items()},
                {k: v[:, cfg.tau + 1] for k, v in batches.items()})
            reports = dataclasses.replace(
                reports, sigma2=s2.cpu().numpy(), G2=G2.cpu().numpy())
        gossip = (r + 1) % cfg.q == 0

        rho, theta = self.controller.controls(reports, self.budget)
        cluster_levels = None
        if cfg.sparse_gossip:
            theta = quantize_theta(theta, cfg.theta_levels)
            cluster_levels = cluster_levels_from_theta(
                theta, cfg.theta_levels, self.cluster_of)

        key = int(self.rng.integers(2**31))
        bits = torch.as_tensor(self.bits_fn(key, rho), dtype=torch.float32,
                               device=self.device)
        with self._phase("device_round"):
            delta, self.mom, losses = self.device_round(main_b, bits)
        # theta in float32 before Q, as the reference casts it (:380): k is
        # computed from the f32 value
        theta32 = torch.as_tensor(np.asarray(theta, np.float32),
                                  device=self.device)
        with self._phase("compress"):
            comp, self.ef = compress_delta(delta, self.ef, theta32,
                                           block=cfg.block_size)
        with self._phase("aggregate"):
            self.params = self.aggregate(comp, gossip)

        wire_kw = (dict(wire_dtype=cfg.wire_dtype, wire_block=cfg.wire_block,
                        dense_bits=32)
                   if cfg.sparse_gossip else {})
        t_round, _ = round_time(rho, theta, reports.mu, reports.nu, cfg.tau,
                                self.cluster_of, gossip=gossip,
                                backhaul=self.het.backhaul_time(), **wire_kw)
        e_round = round_energy(rho, theta, reports.mu, reports.nu,
                               reports.alpha, reports.p, cfg.tau, **wire_kw)
        b = self.budget
        b.charge(t_round, e_round, gossip)
        self.round += 1
        rec = {
            "round": self.round, "loss": float(losses.mean()),
            "time": b.time_spent_prev + b.time_spent_this,
            "energy": b.energy_spent_prev + b.energy_spent_this,
            "rho_mean": float(np.mean(rho)),
            "theta_mean": float(np.mean(theta)),
            "sigma2": float(np.mean(reports.sigma2)),
            "G2": float(np.mean(reports.G2)),
        }
        if cluster_levels is not None:
            rec["cluster_levels"] = [float(t) for t in cluster_levels]
        infeas = getattr(self.controller, "diag",
                         {}).get("p21_time_infeasible")
        if infeas is not None:
            rec["time_cap_infeasible"] = bool(np.any(infeas))
        return rec

    # ------------------------------------------------------------------
    def eval_acc(self, max_batches: int = 8, batch: int = 256) -> float:
        """Accuracy of the averaged model (Eq. 10) on held-out data."""
        xs, ys = self.test_data
        avg = {k: p.mean(dim=0) for k, p in self.params.items()}
        accs = [float(self.acc_fn(avg, {"images": xs[i:i + batch],
                                        "labels": ys[i:i + batch]}))
                for i in range(0, min(len(xs), max_batches * batch), batch)]
        return float(np.mean(accs))

    def run(self, rounds: int, eval_every: int = 5,
            target_acc: Optional[float] = None,
            ckpt_dir: Optional[Path] = None, ckpt_every: int = 0,
            on_round: Optional[Callable[[Dict], None]] = None) -> List:
        """Up to ``rounds`` rounds, evaluating every ``eval_every`` and at
        the last; stops early at ``target_acc`` or when the budget is spent
        (5 % grace).  ``on_round`` sees each round's record once it is in
        the history."""
        for i in range(rounds):
            t0 = time.perf_counter()
            rec = self.run_round()
            self._sync()
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
            if (i + 1) % eval_every == 0 or i == rounds - 1:
                rec["acc"] = self.eval_acc()
            self.history.append(rec)
            if on_round is not None:
                on_round(rec)
            if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
                self.save(Path(ckpt_dir) / f"ckpt_{self.round:06d}.npz")
            if target_acc and rec.get("acc", 0) >= target_acc:
                break
            if rec["time"] > self.budget.time_budget * 1.05 or \
               rec["energy"] > self.budget.energy_budget * 1.05:
                break  # budget exhausted (5% grace)
        return self.history

    # ------------------------------------------------------------------
    def _state(self):
        state = {"params": self.params, "ef": self.ef}
        if self.mom is not None:
            state["mom"] = self.mom
        return state

    def save(self, path: Path):
        """Params, EF, momentum, round, budget, history and the numpy
        stream, in the reference's checkpoint layout: a restore followed
        by run() continues bit for bit."""
        meta = {"round": self.round,
                "budget": dataclasses.asdict(self.budget),
                "history": self.history,
                "rng": self.rng.bit_generator.state,
                "cluster_staleness": self.cluster_staleness.tolist()}
        save_pytree(path, self._state(), meta)

    def restore(self, path: Path):
        """Load a checkpoint written by ``save`` here or by the reference's
        ``FedSim.save`` (same keys and meta)."""
        state, meta = load_pytree(path, self._state())
        self.params, self.ef = state["params"], state["ef"]
        if self.mom is not None:
            self.mom = state["mom"]
        self.round = meta["round"]
        self.budget = BudgetState(**meta["budget"])
        self.history = meta["history"]
        if "rng" in meta:
            self.rng.bit_generator.state = meta["rng"]
        if "cluster_staleness" in meta:
            self.cluster_staleness = np.asarray(meta["cluster_staleness"],
                                                np.int64)
