"""The paper's vision configurations (own copy of
``repro/configs/resnet20_cifar10.py``, ``femnist_cnn.py`` and the FL
parts of ``repro/configs/base.py``): the model, the cluster topology and
the HCEF round with its budgets."""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs.base import FLTopology, HCEFConfig


@dataclass(frozen=True)
class VisionConfig:
    name: str
    kind: str  # resnet20 | femnist_cnn | mlp
    image_size: int
    channels: int
    num_classes: int
    widths: tuple = (16, 32, 64)
    blocks_per_stage: int = 3


@dataclass(frozen=True)
class VisionBundle:
    vision: VisionConfig
    fl: FLTopology
    hcef: HCEFConfig = field(default_factory=HCEFConfig)
    dataset: str = "cifar"  # data/synthetic.py kind
    source: str = ""


RESNET20_CIFAR10 = VisionBundle(
    vision=VisionConfig(name="resnet20-cifar10", kind="resnet20",
                        image_size=32, channels=3, num_classes=10),
    fl=FLTopology(clusters=8, devices_per_cluster=8),  # paper: 64 devices
    hcef=HCEFConfig(tau=5, q=5, eta=0.05, time_budget=8.5e4,
                    energy_budget=15e3),
    dataset="cifar", source="paper sec 6.1")

FEMNIST_CNN = VisionBundle(
    vision=VisionConfig(name="femnist-cnn", kind="femnist_cnn",
                        image_size=28, channels=1, num_classes=62),
    fl=FLTopology(clusters=8, devices_per_cluster=8),
    hcef=HCEFConfig(tau=5, q=5, eta=0.03, time_budget=1.3e5,
                    energy_budget=230e3),
    dataset="femnist", source="paper sec 6.1")

VISION_CONFIGS = {"resnet20_cifar10": RESNET20_CIFAR10,
                  "femnist_cnn": FEMNIST_CNN}
