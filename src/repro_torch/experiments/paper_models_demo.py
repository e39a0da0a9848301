"""The paper's exact experimental models, trained for a few steps (port of
``examples/paper_models_demo.py``).

    PYTHONPATH=src python -m repro_torch.experiments.paper_models_demo \
        [--device cpu]

ResNet-20 (269,722 parameters) and the LEAF FEMNIST CNN (6,603,710), at
their full size: 3 plain SGD steps (lr 0.05) each on 64 synthetic images,
printing the parameter count and the loss after the first and the last
step.  The weights come from ``init_fn`` with a generator seeded 0 (the
reference's ``PRNGKey(0)`` draws cannot be reproduced), so ``run`` takes
them (``params``).  On the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_vision_config
from repro_torch.data.synthetic import synthetic_images
from repro_torch.device import resolve
from repro_torch.models.vision import make_vision_model, param_count

MODELS = (("resnet20_cifar10", "cifar"), ("femnist_cnn", "femnist"))
LR, STEPS, N = 0.05, 3, 64


def run(n: int = N, steps: int = STEPS, *, device=None, params=None,
        verbose: bool = True):
    """Each model's ``steps`` SGD steps on ``n`` images.  ``params``:
    {config name: initial weights} (default: ``init_fn`` seeded 0).
    Returns {config name: {"count", "losses", "params"}}, the losses after
    each step."""
    dev = resolve(device)
    out = {}
    for name, ds in MODELS:
        vc = get_vision_config(name).vision
        init_fn, loss_fn, _, _ = make_vision_model(vc)
        p = (params or {}).get(name)
        if p is None:
            p = init_fn(torch.Generator().manual_seed(0), dev)
        p = {k: v.to(dev) for k, v in p.items()}
        count = param_count(p)
        X, Y = synthetic_images(ds, n, seed=0)
        if ds == "cifar":
            Y = Y % vc.num_classes
        batch = {"images": torch.as_tensor(X, device=dev),
                 "labels": torch.as_tensor(np.asarray(Y), device=dev)}
        t0 = time.time()
        losses = []
        for _ in range(steps):
            leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
            with torch.enable_grad():
                grads = torch.autograd.grad(loss_fn(leaves, batch),
                                            list(leaves.values()))
            with torch.no_grad():
                p = {k: v - LR * g for (k, v), g in zip(leaves.items(),
                                                        grads)}
                losses.append(float(loss_fn(p, batch)))
        out[name] = {"count": count, "losses": losses, "params": p}
        if verbose:
            print(f"{vc.name}: {count:,} params; {steps} SGD steps in "
                  f"{time.time() - t0:.1f}s; loss {losses[0]:.3f} -> "
                  f"{losses[-1]:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
