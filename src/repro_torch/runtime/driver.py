"""FedSim: the paper's CFEL training round, Algorithm 1 end to end (port of
``repro/runtime/driver.py``).

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

Fault injection (``chaos``, ``runtime/chaos``): the controller solves P2
over the live devices, the fault plan drops the devices that miss the
deadline and partitions clusters, dropped devices' updates fold into
their EF, and a degraded round aggregates with the live-device mean and
``participation_mixing(H, conn)``.  A round with every device alive and
every link up runs the fault-free code, so zero fault probabilities are
bit for bit no chaos.  Population mode (``cfg.population``): the N slots
take a cohort of ``population`` logical clients each round, whose EF and
momentum page through ``runtime/population.PopulationStore``;
population == n_devices is bit for bit the fixed roster.

Two draws of the reference come from ``jax.random`` and cannot be
reproduced here, so they are inputs: the initial parameters (``params0``)
and the masked-step bits (``bits_fn(key, rho) -> (N, tau)``, called with
the integer the reference turns into its PRNG key).  The numpy streams
are consumed in the reference's order: each slot's batch indices, then
the key integer; the fault plan, cohorts and reports are the reference's
draws.
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
from repro_torch.core.controller import BudgetState, population_energy_caps
from repro_torch.core.mixing import (check_mixing, make_mixing,
                                     participation_mixing)
from repro_torch.core.round import bernoulli_bits
from repro_torch.device import from_numpy, resolve
from repro_torch.dist.collectives import participation_weights
from repro_torch.fl.baselines import Controller, make_local_objective
from repro_torch.fl.cost_model import (per_device_energy, per_device_time,
                                       round_energy, round_time)
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.optim.sgd import sgd_update
from repro_torch.runtime.chaos import (ChaosConfig, FaultPlan,
                                       controls_on_live,
                                       fold_dropped_updates)
from repro_torch.runtime.checkpoint import load_pytree, save_pytree
from repro_torch.runtime.elastic import cohort_swap, verified_swap
from repro_torch.runtime.population import PopulationStore


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
    # population mode: n_devices is the cohort size R drawn each round
    # from ``population`` logical clients (0: the fixed roster)
    population: int = 0
    cohort_seed: int = 0
    resident_max: int = 256  # the store's LRU working set, in clients
    local_objective: str = "sgd"  # 'sgd' | 'fedprox'
    prox_mu: float = 0.01

    def __post_init__(self):
        if self.wire_dtype not in ("f32", "bf16", "int8", "int4", "fp8"):
            raise ValueError(f"wire_dtype {self.wire_dtype!r}")
        if self.sparse_gossip:
            validate_theta_levels(self.theta_levels)
        if self.population and self.population < self.n_devices:
            raise ValueError(f"population {self.population} smaller than "
                             f"the cohort size n_devices={self.n_devices}")
        if self.local_objective not in ("sgd", "fedprox"):
            raise ValueError(f"local_objective {self.local_objective!r}")


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return from_numpy(np.asarray(x), device)


class FedSim:
    def __init__(self, cfg: FedSimConfig, *, params0, loss_fn, acc_fn,
                 device_data: Optional[List], test_data,
                 controller: Controller, het: HeterogeneityModel,
                 time_budget: float = np.inf, energy_budget: float = np.inf,
                 phi: int = 10_000, bits_fn: Optional[Callable] = None,
                 device=None, chaos: Optional[ChaosConfig] = None,
                 data_fn: Optional[Callable] = None,
                 store_root: Optional[Path] = None,
                 verify_conservation: bool = False):
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
        self.H_np = np.asarray(H, np.float32)
        self.H = torch.as_tensor(self.H_np, device=self.device)

        stack = lambda t: t[None].repeat((N,) + (1,) * t.ndim)
        self.params = {k: stack(_as_tensor(p, self.device))
                       for k, p in params0.items()}
        self.mom = ({k: torch.zeros_like(p) for k, p in self.params.items()}
                    if cfg.momentum else None)
        self.ef = {k: torch.zeros_like(p) for k, p in self.params.items()}
        # every client of device_data is uploaded once; batches are
        # gathered on the device from host-drawn indices.  With data_fn
        # the cohort's shards are made and uploaded each round.
        self.data_fn = data_fn
        if device_data is not None:
            self._data_on_device(device_data)
        self.test_data = tuple(_as_tensor(a, self.device) for a in test_data)
        self.budget = BudgetState(
            time_budget=time_budget, energy_budget=energy_budget,
            phi=phi, q=cfg.q, backhaul_time=het.backhaul_time())
        self.round = 0
        self.rng = np.random.default_rng(cfg.seed + 1)
        self.history: List[Dict] = []
        # fault injection: None is fault-free
        self.fault_plan = (FaultPlan(chaos, N, C)
                           if chaos is not None else None)
        self.cluster_staleness = np.zeros(C, np.int64)
        # population mode: the store of every client's EF and momentum
        self.pop_store: Optional[PopulationStore] = None
        self.cohort_ids: Optional[np.ndarray] = None
        # check every cohort swap (elastic.verified_swap) into the
        # round's record
        self.verify_conservation = verify_conservation
        if cfg.population:
            if het.population_size != cfg.population:
                raise ValueError(
                    f"HeterogeneityModel population "
                    f"{het.population_size} != FedSimConfig.population "
                    f"{cfg.population} (construct the het model with "
                    f"population=)")
            if data_fn is None and (device_data is None
                                    or len(device_data) < cfg.population):
                raise ValueError("population mode needs data_fn(client_id) "
                                 "or device_data covering every client")
            meta = lambda t: {k: torch.empty(tuple(v.shape[1:]),
                                             dtype=v.dtype, device="meta")
                              for k, v in t.items()}
            self.pop_store = PopulationStore(
                cfg.population, {"ef": meta(self.ef), "mom": (
                    None if self.mom is None else meta(self.mom))},
                root=store_root, resident_max=cfg.resident_max)
            self.budget.population = cfg.population
            self.budget.cohort = N
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

    def _data_on_device(self, data):
        """Upload clients' (xs, ys) shards as one array; client i's rows
        start at ``_offsets[i]``."""
        self._sizes = np.array([len(xs) for xs, _ in data])
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)[:-1]])
        self._X = _as_tensor(np.concatenate([xs for xs, _ in data]),
                             self.device)
        self._Y = _as_tensor(np.concatenate([ys for _, ys in data]),
                             self.device)

    def _sample_batches(self, tau_plus: int, client_ids=None):
        """(N, tau_plus, bs, ...) batches, slot r from client
        ``client_ids[r]`` (default: the fixed roster): indices drawn per
        slot from the numpy stream, in the reference's order, gathered on
        the device.  With ``data_fn`` the cohort's shards are made on the
        host and uploaded first."""
        N = self.cfg.n_devices
        ids = np.arange(N) if client_ids is None else np.asarray(client_ids)
        if self.data_fn is not None:
            self._data_on_device([self.data_fn(int(c)) for c in ids])
            ids = np.arange(N)
        idx = np.stack([
            self._offsets[c] + self.rng.integers(
                0, self._sizes[c], (tau_plus, self.cfg.batch_size))
            for c in ids])
        gi = torch.from_numpy(idx).to(self.device)
        return {"images": self._X[gi], "labels": self._Y[gi]}

    def _swap_cohort(self) -> Optional[Dict]:
        """Rotate this round's cohort into the slots (population mode):
        the previous cohort's EF and momentum go back to the store, the
        new cohort's come into the same tensors (``elastic.cohort_swap``,
        copies only).  With population == n_devices the cohort is the
        roster every round and the swap an exact round trip.  Returns the
        swap's ``elastic.verified_swap`` record where it was checked."""
        cfg, N = self.cfg, self.cfg.n_devices
        new_ids = (self.het.sample_cohort(self.round, N,
                                          seed=cfg.cohort_seed)
                   if cfg.population > N
                   else np.arange(N, dtype=np.int64))
        client = {"ef": self.ef, "mom": self.mom}
        old_ids = self.cohort_ids

        def swap():
            with self._phase("cohort_swap"):
                if old_ids is None:
                    # the slots hold zeros, every client's state before it
                    # takes part: nothing to scatter yet
                    self.pop_store.gather(new_ids, out=client)
                else:
                    cohort_swap(client, old_ids, new_ids, self.pop_store)

        check = None
        if self.verify_conservation and old_ids is not None:
            check = verified_swap(swap, self.pop_store, client, old_ids,
                                  new_ids)
        else:
            swap()
        self.cohort_ids = new_ids
        return check

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

    def aggregate(self, comp, gossip: bool, alive_w=None, Hm=None):
        """Eq. 5 (driver.py:216-251): each cluster's model plus the mean of
        its devices' compressed deltas, mixed with H on gossip rounds, and
        broadcast back to the cluster's devices.  A degraded round passes
        ``comp`` already folded (dropped devices add exact zeros),
        ``alive_w``, the host's participation weights (the live-device
        mean), and ``Hm``, ``participation_mixing(H, conn)`` in place of H:
        a partitioned cluster keeps its own model."""
        C, Dev = self.cfg.n_clusters, self.dev_per_cluster
        if alive_w is not None:
            aw = torch.as_tensor(np.asarray(alive_w, np.float32),
                                 device=self.device)
        H = (self.H if Hm is None else
             torch.as_tensor(np.asarray(Hm, np.float32), device=self.device))
        out = {}
        for k, x0 in self.params.items():
            tail = x0.shape[1:]
            y = x0.reshape(C, Dev, *tail)[:, 0]
            upd = comp[k]
            if alive_w is not None:
                upd = upd * aw.view((C * Dev,) + (1,) * len(tail))
            y = y + upd.reshape(C, Dev, *tail).mean(dim=1)
            if gossip:
                y = torch.einsum("ij,j...->i...", H, y)
            out[k] = y[:, None].expand(C, Dev, *tail).reshape(C * Dev, *tail)
        return out

    # ------------------------------------------------------------------
    def run_round(self) -> Dict:
        cfg = self.cfg
        N = cfg.n_devices
        r = self.budget.r
        swap_check = None
        if self.pop_store is not None:  # this round's cohort into the slots
            swap_check = self._swap_cohort()
        reports = self.het.sample_round(self.round, ids=self.cohort_ids)
        batches = self._sample_batches(cfg.tau + 2, self.cohort_ids)
        main_b = {k: v[:, :cfg.tau] for k, v in batches.items()}
        with self._phase("stats"):
            s2, G2 = self.stats(
                {k: v[:, cfg.tau] for k, v in batches.items()},
                {k: v[:, cfg.tau + 1] for k, v in batches.items()})
            reports = dataclasses.replace(
                reports, sigma2=s2.cpu().numpy(), G2=G2.cpu().numpy())
        if self.pop_store is not None and cfg.population > N:
            # each member's cap: its fair lifetime share less its spend;
            # off at population == N (the round budget is the share)
            reports = dataclasses.replace(
                reports, energy_cap=population_energy_caps(
                    self.budget,
                    self.pop_store.rounds_participated[self.cohort_ids],
                    self.pop_store.energy_spent[self.cohort_ids]))
        gossip = (r + 1) % cfg.q == 0
        # the exogenous availability comes before the controller, which
        # solves P2 over the live devices only
        alive0 = (self.fault_plan.sample_available(self.round)
                  if self.fault_plan is not None else None)
        if alive0 is not None:
            rho, theta = controls_on_live(self.controller, reports,
                                          self.budget, alive0)
        else:
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
            comp, _ = compress_delta(delta, self.ef, theta32,
                                     block=cfg.block_size)

        # dense_bits=32: the simulator's parameters are f32
        wire_kw = (dict(wire_dtype=cfg.wire_dtype, wire_block=cfg.wire_block,
                        dense_bits=32)
                   if cfg.sparse_gossip else {})
        faults = alive = conn = None
        if self.fault_plan is not None:
            t_dev = per_device_time(rho, theta, reports.mu, reports.nu,
                                    cfg.tau, **wire_kw)
            faults = self.fault_plan.step(self.round, gossip_round=gossip,
                                          per_device_time=t_dev,
                                          alive=alive0)
            alive, conn = faults.alive, faults.cluster_conn
            if gossip:
                self.cluster_staleness = np.where(
                    conn, 0, self.cluster_staleness + 1)
        degraded = faults is not None and (not alive.all()
                                           or not conn.all())
        with self._phase("aggregate"):
            if degraded:
                # dropped devices add exact zeros, their split folded into
                # their EF
                comp, self.ef = fold_dropped_updates(comp, self.ef, alive)
                aw = participation_weights(alive, clusters=cfg.n_clusters,
                                           dev=self.dev_per_cluster)
                Hm = participation_mixing(self.H_np, conn)
                self.params = self.aggregate(comp, gossip, aw, Hm)
            else:
                self.params = self.aggregate(comp, gossip)

        # only live devices are charged; a partitioned cluster skips its
        # backhaul transfer
        t_round, _ = round_time(rho, theta, reports.mu, reports.nu, cfg.tau,
                                self.cluster_of, gossip=gossip,
                                backhaul=self.het.backhaul_time(),
                                alive=alive, conn=conn, **wire_kw)
        e_round = round_energy(rho, theta, reports.mu, reports.nu,
                               reports.alpha, reports.p, cfg.tau,
                               alive=alive, **wire_kw)
        if self.pop_store is not None:
            e_dev = per_device_energy(rho, theta, reports.mu, reports.nu,
                                      reports.alpha, reports.p, cfg.tau,
                                      alive=alive, **wire_kw)
            t_dev_all = per_device_time(rho, theta, reports.mu, reports.nu,
                                        cfg.tau, **wire_kw)
            if alive is not None:
                t_dev_all = t_dev_all * np.asarray(alive, np.float64)
            self.pop_store.record_round(self.cohort_ids, self.round,
                                        energy=e_dev, time=t_dev_all)
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
        if self.pop_store is not None:
            parts = self.pop_store.rounds_participated[self.cohort_ids]
            rec["cohort_new"] = int(np.sum(parts == 1))  # first-timers
            rec["resident_clients"] = self.pop_store.resident_count
        if swap_check is not None:
            rec["swap_check"] = swap_check
        if reports.energy_cap is not None:
            rec["energy_cap_mean"] = float(np.mean(reports.energy_cap))
        if faults is not None:
            rec["participation"] = faults.participation
            rec["n_deadline_missed"] = faults.n_deadline_missed
            rec["coordinator"] = faults.coordinator
            rec["n_partitioned"] = int((~faults.cluster_conn).sum())
            rec["staleness_max"] = int(self.cluster_staleness.max())
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
        the history.  ``round_ms`` leaves out the swap check's host time
        (``verify_conservation``)."""
        for i in range(rounds):
            t0 = time.perf_counter()
            rec = self.run_round()
            self._sync()
            self.round_ms.append((time.perf_counter() - t0) * 1e3
                                 - rec.get("swap_check", {}).get("host_ms",
                                                                 0.0))
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
        """Params, EF, momentum, round, budget, history, the numpy stream,
        the staleness counters and the fault plan's Markov state, in the
        reference's checkpoint layout: a restore followed by run()
        continues bit for bit.  In population mode a sibling manifest
        (``.pop.npz``) pins every client's page."""
        meta = {"round": self.round,
                "budget": dataclasses.asdict(self.budget),
                "history": self.history,
                "rng": self.rng.bit_generator.state,
                "cluster_staleness": self.cluster_staleness.tolist()}
        if self.fault_plan is not None:
            meta["fault_plan"] = self.fault_plan.state_dict()
        if self.pop_store is not None:
            meta["cohort_ids"] = (None if self.cohort_ids is None
                                  else [int(c) for c in self.cohort_ids])
            self.pop_store.save(self._pop_manifest(path))
        save_pytree(path, self._state(), meta)

    @staticmethod
    def _pop_manifest(path: Path) -> Path:
        return Path(path).with_suffix(".pop.npz")

    def restore(self, path: Path):
        """Load a checkpoint written by ``save`` here or by the reference's
        ``FedSim.save`` (same keys and meta; the population manifest is
        the port's own)."""
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
        if self.fault_plan is not None and meta.get("fault_plan"):
            self.fault_plan.load_state_dict(meta["fault_plan"])
        if self.pop_store is not None:
            self.pop_store.restore(self._pop_manifest(path))
            ids = meta.get("cohort_ids")
            self.cohort_ids = (None if ids is None
                               else np.asarray(ids, np.int64))
