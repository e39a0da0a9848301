"""Shared harness of the paper-reproduction experiments (port of
``benchmarks/common.py``).

Reduced-scale setup: synthetic CIFAR / FEMNIST stand-ins of the exact
shapes, a Dirichlet(beta) partition, the paper's heterogeneity model (mu
in [75, 150] s, alpha in [1.5, 6] J, bw in [1, 5] Mbps, 50 Mbps backhaul)
and the simulated time and energy of Eq. 8/9.  The sweep model is the MLP
on 16 devices in 8 clusters.  Budgets follow the paper: 60 % of the CEF
baseline's cost to the target accuracy.

Every argument and default is the reference's; the FedSim and controller
defaults are ``FedSimConfig``'s and ``make_controller``'s, not a
configuration's.  The reference draws its weights
(``init_fn(PRNGKey(cfg.seed))``, its driver.py:118) and masked-step bits
with ``jax.random``, which cannot be reproduced: ``params0`` defaults to
the port's MLP init from a ``torch.Generator`` seeded ``seed``, and
``bits_fn`` to ``core.round.bernoulli_bits``; the tests pass the
reference's.  FedSim runs on the card unless ``device`` says otherwise.
Results go to ``RESULTS``, the repo's ``experiments_out/``.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.vision import VisionConfig
from repro_torch.data.synthetic import dirichlet_partition, synthetic_images
from repro_torch.fl.baselines import make_controller
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.models.vision import make_vision_model
from repro_torch.runtime.driver import FedSim, FedSimConfig

RESULTS = Path(__file__).resolve().parents[3] / "experiments_out"
# make_sim's device where its caller names none (None: the card); the
# figure scripts take no device, so run.py's --device sets this
DEVICE = None
SCHEMES = ["hcef", "cef", "cef_f", "cef_c", "mll_sgd"]

_DATASETS = {
    "cifar": dict(kind="cifar", image_size=32, channels=3, num_classes=10,
                  n_train=16384, n_test=1024, target_acc=0.70, noise=4.0),
    "femnist": dict(kind="femnist", image_size=28, channels=1,
                    num_classes=62, n_train=16384, n_test=1024,
                    target_acc=0.50, noise=1.25),
}


def mlp_config(dataset: str) -> VisionConfig:
    ds = _DATASETS[dataset]
    return VisionConfig(name=f"mlp-{dataset}", kind="mlp",
                        image_size=ds["image_size"], channels=ds["channels"],
                        num_classes=ds["num_classes"])


@functools.lru_cache(maxsize=4)
def _images(kind: str, n: int, seed: int, noise: float):
    """``synthetic_images``, made once a process for each argument set:
    every FedSim of a sweep takes the same seeded images, and the host
    needs about 2 s for CIFAR's 16,384.  Callers index, never write."""
    return synthetic_images(kind, n, seed=seed, noise=noise)


def make_sim(scheme: str, *, dataset="cifar", beta=1.0, backhaul="ring",
             p_edge=0.4, tau=5, q=5, n_devices=16, n_clusters=8,
             time_budget=np.inf, energy_budget=np.inf, seed=0,
             eta=0.02, chaos=None, params0=None, bits_fn=None,
             device=None) -> FedSim:
    ds = _DATASETS[dataset]
    init_fn, loss_fn, acc_fn, _ = make_vision_model(mlp_config(dataset))
    X, Y = _images(ds["kind"], ds["n_train"], seed, ds["noise"])
    Xt, Yt = _images(ds["kind"], ds["n_test"], seed + 1, ds["noise"])
    parts = dirichlet_partition(Y, n_devices, beta=beta, seed=seed)
    data = [(X[p], Y[p]) for p in parts]
    cfg = FedSimConfig(n_devices=n_devices, n_clusters=n_clusters, tau=tau,
                       q=q, eta=eta, batch_size=50, backhaul=backhaul,
                       p_edge=p_edge, seed=seed)
    if params0 is None:
        params0 = init_fn(torch.Generator().manual_seed(seed))
    bits = float(sum(int(np.prod(np.shape(p)))
                     for p in params0.values())) * 32
    het = HeterogeneityModel(num_devices=n_devices, model_bits=bits,
                             seed=seed)
    return FedSim(cfg, params0=params0, loss_fn=loss_fn, acc_fn=acc_fn,
                  device_data=data, test_data=(Xt, Yt),
                  controller=make_controller(scheme, tau),
                  het=het, time_budget=time_budget,
                  energy_budget=energy_budget, phi=200, chaos=chaos,
                  bits_fn=bits_fn,
                  device=DEVICE if device is None else device)


def run_scheme(scheme: str, *, rounds=60, eval_every=4, target_acc=None,
               **kw) -> list:
    sim = make_sim(scheme, **kw)
    return sim.run(rounds=rounds, eval_every=eval_every,
                   target_acc=target_acc)


def cost_to_target(history: list, target: float):
    """(time, energy) at the first eval reaching the target accuracy."""
    for h in history:
        if h.get("acc", 0.0) >= target:
            return h["time"], h["energy"]
    return None, None


def calibrate_budgets(dataset="cifar", rounds=60, seed=0, **kw):
    """Paper Sec. 6.1: the budgets are 60 % of the CEF baseline's cost to
    the target (its cost at the end of the run where it never gets
    there)."""
    ds = _DATASETS[dataset]
    hist = run_scheme("cef", dataset=dataset, rounds=rounds, seed=seed,
                      target_acc=ds["target_acc"], **kw)
    t, e = cost_to_target(hist, ds["target_acc"])
    if t is None:  # CEF did not reach the target: its end-of-run cost
        t, e = hist[-1]["time"], hist[-1]["energy"]
    return 0.6 * t, 0.6 * e, hist


def save_json(name: str, obj) -> Path:
    RESULTS.mkdir(parents=True, exist_ok=True)
    p = RESULTS / f"{name}.json"
    p.write_text(json.dumps(obj, indent=1, default=float))
    return p
