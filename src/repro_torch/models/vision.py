"""The paper's vision models on plain dicts of tensors (port of
``repro/models/vision.py``): ResNet-20 (CIFAR-10, 269,722 parameters), the
LEAF FEMNIST CNN (6,603,710) and the MLP of the benchmark sweeps.

Public functions keep the reference's layouts: images NHWC, conv weights
HWIO, fc weights (in, out), and its leaf names, so parameters and
checkpoints carry over leaf for leaf.  Inside, the convolutions run in
NCHW with the XLA "SAME" pads written out (asymmetric at stride 2 on even
sizes), and batch norm uses the batch's statistics only.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def he_init(gen, shape, device=None):
    """He fan-in init (conv HWIO or fc (in, out)) from a torch.Generator
    (the reference draws from jax.random; the values differ)."""
    fan_in = 1
    for s in shape[:-1]:
        fan_in *= s
    w = torch.randn(shape, generator=gen, dtype=torch.float32)
    return (w * (2.0 / fan_in) ** 0.5).to(device)


def same_pads(n: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x, w, stride=1):
    """x: (B, C, H, W); w: HWIO.  XLA "SAME" convolution."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_pads(x.shape[-2], kh, stride)
    left, right = same_pads(x.shape[-1], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride)


def _bn(x, scale, bias, eps=1e-5):
    """Batch-statistics normalisation over (B, H, W), biased variance."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    return ((x - mean) * torch.rsqrt(var + eps) * scale[None, :, None, None]
            + bias[None, :, None, None])


# ---------------------------------------------------------------------------
# ResNet-20
# ---------------------------------------------------------------------------

def resnet20_init(gen, cfg, device=None) -> Dict[str, torch.Tensor]:
    widths = cfg.widths
    ones = lambda n: torch.ones((n,), device=device)
    zeros = lambda n: torch.zeros((n,), device=device)
    p = {"conv0": he_init(gen, (3, 3, cfg.channels, widths[0]), device),
         "bn0_s": ones(widths[0]), "bn0_b": zeros(widths[0])}
    c_in = widths[0]
    for si, w_out in enumerate(widths):
        for bi in range(cfg.blocks_per_stage):
            pre = f"s{si}b{bi}_"
            p[pre + "conv1"] = he_init(gen, (3, 3, c_in, w_out), device)
            p[pre + "bn1_s"] = ones(w_out)
            p[pre + "bn1_b"] = zeros(w_out)
            p[pre + "conv2"] = he_init(gen, (3, 3, w_out, w_out), device)
            p[pre + "bn2_s"] = ones(w_out)
            p[pre + "bn2_b"] = zeros(w_out)
            c_in = w_out
    p["fc_w"] = he_init(gen, (widths[-1], cfg.num_classes), device)
    p["fc_b"] = zeros(cfg.num_classes)
    return p


def resnet20_forward(params, images, cfg):
    x = conv_same(images.permute(0, 3, 1, 2), params["conv0"])
    x = F.relu(_bn(x, params["bn0_s"], params["bn0_b"]))
    for si, w_out in enumerate(cfg.widths):
        for bi in range(cfg.blocks_per_stage):
            pre = f"s{si}b{bi}_"
            stride = 2 if (si > 0 and bi == 0) else 1
            h = conv_same(x, params[pre + "conv1"], stride)
            h = F.relu(_bn(h, params[pre + "bn1_s"], params[pre + "bn1_b"]))
            h = conv_same(h, params[pre + "conv2"])
            h = _bn(h, params[pre + "bn2_s"], params[pre + "bn2_b"])
            sc = x
            if stride != 1 or sc.shape[1] != w_out:
                sc = sc[:, :, ::stride, ::stride]  # option A: subsample and
                pad_c = w_out - sc.shape[1]        # zero-pad the channels
                sc = F.pad(sc, (0, 0, 0, 0, pad_c // 2, pad_c - pad_c // 2))
            x = F.relu(h + sc)
    x = x.mean(dim=(2, 3))
    return x @ params["fc_w"] + params["fc_b"]


# ---------------------------------------------------------------------------
# FEMNIST CNN (LEAF)
# ---------------------------------------------------------------------------

def femnist_cnn_init(gen, cfg, device=None) -> Dict[str, torch.Tensor]:
    flat = (cfg.image_size // 4) ** 2 * 64
    zeros = lambda n: torch.zeros((n,), device=device)
    return {
        "conv1": he_init(gen, (5, 5, cfg.channels, 32), device),
        "b1": zeros(32),
        "conv2": he_init(gen, (5, 5, 32, 64), device),
        "b2": zeros(64),
        "fc1_w": he_init(gen, (flat, 2048), device),
        "fc1_b": zeros(2048),
        "fc2_w": he_init(gen, (2048, cfg.num_classes), device),
        "fc2_b": zeros(cfg.num_classes),
    }


def femnist_cnn_forward(params, images, cfg):
    x = conv_same(images.permute(0, 3, 1, 2), params["conv1"])
    x = F.max_pool2d(F.relu(x + params["b1"][None, :, None, None]), 2)
    x = conv_same(x, params["conv2"])
    x = F.max_pool2d(F.relu(x + params["b2"][None, :, None, None]), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC order (:123)
    x = F.relu(x @ params["fc1_w"] + params["fc1_b"])
    return x @ params["fc2_w"] + params["fc2_b"]


# ---------------------------------------------------------------------------
# MLP (the benchmark sweeps' model, benchmarks/common.py:43)
# ---------------------------------------------------------------------------

def mlp_init(gen, cfg, device=None, hidden=(256, 128)):
    dims = [cfg.image_size ** 2 * cfg.channels, *hidden, cfg.num_classes]
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = he_init(gen, (dims[i], dims[i + 1]), device)
        p[f"b{i}"] = torch.zeros((dims[i + 1],), device=device)
    return p


def mlp_forward(params, images, cfg):
    x = images.reshape(images.shape[0], -1)
    n = len([k for k in params if k.startswith("w")])
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = F.relu(x)
    return x


_MODELS = {"resnet20": (resnet20_init, resnet20_forward),
           "femnist_cnn": (femnist_cnn_init, femnist_cnn_forward),
           "mlp": (mlp_init, mlp_forward)}


def make_vision_model(cfg):
    """Returns (init_fn(gen, device), loss_fn(params, batch),
    acc_fn(params, batch), forward(params, images))."""
    if cfg.kind not in _MODELS:
        raise ValueError(cfg.kind)
    init, fwd = _MODELS[cfg.kind]

    def init_fn(gen, device=None):
        return init(gen, cfg, device)

    def forward(params, images):
        return fwd(params, images, cfg)

    def loss_fn(params, batch):
        logits = forward(params, batch["images"])
        labels = batch["labels"].long()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[:, None])[:, 0]
        return (lse - ll).mean()

    def acc_fn(params, batch):
        logits = forward(params, batch["images"])
        return (logits.argmax(-1) == batch["labels"].long()).float().mean()

    return init_fn, loss_fn, acc_fn, forward


def param_count(params) -> int:
    return sum(p.numel() for p in params.values())
