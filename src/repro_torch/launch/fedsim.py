"""FedSim launcher: the HCEF round and its baselines on the paper's vision
models at a configuration's topology, on the card unless ``--device cpu``.
The reference has no FedSim launcher of its own; this is the port's.  The
port of the reference's experiment harness, ``benchmarks/common.py``'s
``make_sim`` (the MLP on 16 devices in 8 clusters, FedSimConfig's
defaults), is ``repro_torch/experiments/common.py``, whose dataset table
this launcher reads.

    PYTHONPATH=src python -m repro_torch.launch.fedsim --model resnet20 \
        --schemes hcef,cef --rounds 10

builds the FedSim on the synthetic CIFAR-10 (or FEMNIST) stand-in with the
configuration's topology (8 clusters x 8 devices), round (tau, q, eta) and
HCEF budgets, and prints one line per round: loss, accuracy where
evaluated, mean rho and theta, simulated time and energy, and wall time.
``--model mlp`` runs the benchmark sweeps' MLP (eta 0.02) on the CIFAR
stand-in with the ResNet-20 configuration's topology, tau, q and budgets.
``--profile`` traces the rounds after a warm-up round with torch.profiler
and prints the device's busy share and its kernels by device time.
``--chaos`` injects faults (dropout 0.2, partitions 0.1, coordinator
failures 0.2 a round, seeded with ``--seed``); ``--population N`` rotates
a cohort of the devices through N logical clients, each with its own
shard (``data.synthetic.client_image_shard``, SHARD_SIZE images), its EF
and momentum paged under ``--store-root`` (default: kept in memory).
"""
from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from repro_torch.configs.vision import (FEMNIST_CNN, RESNET20_CIFAR10,
                                        VisionConfig)
from repro_torch.data.synthetic import (client_image_shard,
                                        dirichlet_partition, synthetic_images)
from repro_torch.experiments.common import _DATASETS as DATASETS
from repro_torch.experiments.common import mlp_config
from repro_torch.fl.baselines import CONTROLLERS, make_controller
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.launch.profiling import activities, print_profile
from repro_torch.models.vision import make_vision_model, param_count
from repro_torch.runtime.chaos import ChaosConfig
from repro_torch.runtime.driver import FedSim, FedSimConfig

MODELS = {"resnet20": RESNET20_CIFAR10, "femnist_cnn": FEMNIST_CNN,
          "mlp": RESNET20_CIFAR10}
SHARD_SIZE = 64  # images a client holds in population mode


def vision_config(model: str) -> VisionConfig:
    if model == "mlp":
        return mlp_config("cifar")
    return MODELS[model].vision


def make_sim(scheme: str, *, model: str = "resnet20", n_devices=None,
             n_clusters=None, n_train=None, n_test=None, beta=1.0,
             budgets: bool = True, tau=None, q=None, eta=None, seed=0,
             params0=None, bits_fn=None, device=None, phi=200,
             chaos=None, population=0, store_root=None,
             verify_conservation=False) -> FedSim:
    """The FedSim of ``model``'s configuration on its synthetic stand-in.
    ``budgets=False`` runs without time/energy budgets (then HCEF's theta
    is 1); ``params0`` defaults to the port's He init seeded ``seed``.
    ``chaos``: a ``ChaosConfig``.  ``population``: logical clients behind
    the devices, each with SHARD_SIZE images of its own (the Dirichlet
    ``beta`` label mix), its state in a store under ``store_root`` (None:
    in memory); ``verify_conservation`` checks every cohort swap."""
    bundle = MODELS[model]
    hc, fl = bundle.hcef, bundle.fl
    ds = DATASETS[bundle.dataset]
    vc = vision_config(model)
    init_fn, loss_fn, acc_fn, _ = make_vision_model(vc)
    Xt, Yt = synthetic_images(ds["kind"], n_test or ds["n_test"],
                              seed=seed + 1, noise=ds["noise"])
    n_devices = n_devices or fl.num_devices
    tau = tau or hc.tau
    # the MLP sweeps run at eta 0.02 (benchmarks/common.py:make_sim)
    eta = eta or (0.02 if model == "mlp" else hc.eta)
    cfg = FedSimConfig(n_devices=n_devices,
                       n_clusters=n_clusters or fl.clusters, tau=tau,
                       q=q or hc.q, eta=eta, momentum=hc.momentum,
                       batch_size=50, backhaul=fl.backhaul, seed=seed,
                       theta_min=hc.theta_min, rho_min=hc.rho_min,
                       population=population)
    if params0 is None:
        params0 = init_fn(torch.Generator().manual_seed(seed))
    n_params = sum(int(np.prod(np.shape(p))) for p in params0.values())
    het = HeterogeneityModel(num_devices=n_devices,
                             model_bits=float(n_params) * 32, seed=seed,
                             population=population)
    if population:
        data, data_fn = None, functools.partial(
            client_image_shard, ds["kind"], SHARD_SIZE, beta=beta,
            seed=seed)
    else:
        X, Y = synthetic_images(ds["kind"], n_train or ds["n_train"],
                                seed=seed, noise=ds["noise"])
        parts = dirichlet_partition(Y, n_devices, beta=beta, seed=seed)
        data, data_fn = [(X[p], Y[p]) for p in parts], None
    return FedSim(cfg, params0=params0, loss_fn=loss_fn, acc_fn=acc_fn,
                  device_data=data, data_fn=data_fn, chaos=chaos,
                  store_root=store_root,
                  verify_conservation=verify_conservation,
                  test_data=(Xt, Yt),
                  controller=make_controller(scheme, tau,
                                             theta_min=hc.theta_min,
                                             rho_min=hc.rho_min),
                  het=het,
                  time_budget=hc.time_budget if budgets else np.inf,
                  energy_budget=hc.energy_budget if budgets else np.inf,
                  phi=phi, bits_fn=bits_fn, device=device)


def print_round(sim, label: str = ""):
    """An ``on_round`` for ``FedSim.run`` that prints the round's line."""
    def show(rec):
        acc = f" acc={rec['acc']:.4f}" if "acc" in rec else ""
        extra = ""
        if "participation" in rec:
            extra += (f" part={rec['participation']:.2f} miss="
                      f"{rec['n_deadline_missed']} cut="
                      f"{rec['n_partitioned']}")
        if "cohort_new" in rec:
            extra += (f" new={rec['cohort_new']} "
                      f"res={rec['resident_clients']}")
        print(f"{label}round {rec['round']:3d} loss={rec['loss']:.4f}{acc} "
              f"rho={rec['rho_mean']:.3f} theta={rec['theta_mean']:.3f} "
              f"time={rec['time']:.1f}s energy={rec['energy']:.1f}J "
              f"wall={sim.round_ms[-1]:.1f}ms{extra}", flush=True)
    return show


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet20", choices=sorted(MODELS))
    ap.add_argument("--schemes", default="hcef",
                    help=f"comma-separated, of {sorted(CONTROLLERS)}")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    ap.add_argument("--devices", type=int, default=None,
                    help="devices (default: the configuration's 64)")
    ap.add_argument("--clusters", type=int, default=None)
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--no-budgets", dest="budgets", action="store_false",
                    help="run without the configuration's budgets")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the rounds after one warm-up round and "
                         "print the device busy share and kernels by time")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded fault injection (runtime/chaos)")
    ap.add_argument("--population", type=int, default=0,
                    help="logical clients behind the devices")
    ap.add_argument("--store-root", default=None)
    args = ap.parse_args(argv)
    chaos = (ChaosConfig(seed=args.seed, dropout_prob=0.2,
                         partition_prob=0.1, coordinator_fail_prob=0.2)
             if args.chaos else None)
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is f32
    torch.backends.cudnn.allow_tf32 = False
    for scheme in args.schemes.split(","):
        if scheme not in CONTROLLERS:
            ap.error(f"scheme {scheme!r} not in {sorted(CONTROLLERS)}")
        sim = make_sim(scheme, model=args.model, n_devices=args.devices,
                       n_clusters=args.clusters, n_train=args.n_train,
                       budgets=args.budgets, seed=args.seed,
                       device=args.device, chaos=chaos,
                       population=args.population,
                       store_root=args.store_root)
        n_params = param_count({k: p[0] for k, p in sim.params.items()})
        print(f"{scheme}: {args.model}, {n_params} params, "
              f"{sim.cfg.n_devices} devices in {sim.cfg.n_clusters} "
              f"clusters, tau={sim.cfg.tau} q={sim.cfg.q} "
              f"eta={sim.cfg.eta}, on {sim.device}", flush=True)
        if not args.profile:
            sim.run(args.rounds, eval_every=args.eval_every,
                    on_round=print_round(sim, f"{scheme} "))
            continue
        sim.run(1, eval_every=args.eval_every,
                on_round=print_round(sim, f"{scheme} warm-up "))
        with torch.profiler.profile(
                activities=activities(sim.device)) as prof:
            t0 = time.perf_counter()
            sim.run(args.rounds, eval_every=args.eval_every,
                    on_round=print_round(sim, f"{scheme} "))
            wall = time.perf_counter() - t0
        print_profile(prof, wall)


if __name__ == "__main__":
    main()
