"""The paper's vision configurations (own copy of
``repro/configs/resnet20_cifar10.py``, ``femnist_cnn.py`` and the FL
parts of ``repro/configs/base.py``): the model, the cluster topology and
the HCEF round with its budgets."""
from __future__ import annotations

from dataclasses import dataclass, field


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
class FLTopology:
    clusters: int
    devices_per_cluster: int
    backhaul: str = "ring"  # ring | complete | erdos_renyi

    @property
    def num_devices(self) -> int:
        return self.clusters * self.devices_per_cluster


@dataclass(frozen=True)
class HCEFConfig:
    """Round structure and controller knobs (base.py:139), the fields the
    FedSim reads."""
    tau: int = 4
    q: int = 4
    eta: float = 0.05
    momentum: float = 0.9
    theta_min: float = 0.05
    rho_min: float = 0.1
    time_budget: float = float("inf")
    energy_budget: float = float("inf")


@dataclass(frozen=True)
class VisionBundle:
    vision: VisionConfig
    fl: FLTopology
    hcef: HCEFConfig = field(default_factory=HCEFConfig)
    dataset: str = "cifar"  # data/synthetic.py kind
    source: str = ""


def validate_theta_levels(theta_levels) -> None:
    """Sparse-gossip level grid (base.py:120): non-empty, in (0, 1], and
    reaching 1.0, since ``quantize_theta`` rounds up and raises above the
    largest level."""
    if not theta_levels:
        raise ValueError("sparse_gossip requires theta_levels")
    if any(not 0.0 < float(t) <= 1.0 for t in theta_levels):
        raise ValueError(
            f"theta_levels must lie in (0, 1], got {theta_levels}")
    if max(float(t) for t in theta_levels) < 1.0:
        raise ValueError(
            f"theta_levels {theta_levels} do not cover [theta_min, 1.0]: "
            f"the largest level must be 1.0")


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
