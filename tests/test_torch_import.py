"""The PyTorch port stands alone: importing it pulls in neither JAX nor the
JAX package, and its numpy -> torch bridge is bit-exact for bfloat16."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.device import from_numpy, resolve

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
# the gossip wire's modules, the last two architectures' configs and the
# experiments' harness and serving bench must be among those imported
missing = {"repro_torch.dist.collectives", "repro_torch.dist.policies",
           "repro_torch.kernels.wire_pack",
           "repro_torch.configs.internvl2_2b",
           "repro_torch.configs.seamless_m4t_large_v2",
           "repro_torch.experiments.common",
           "repro_torch.experiments.serving_bench"} - set(names)
print(len(names), bad + sorted(missing))
"""


def test_import_pulls_in_no_jax_and_no_reference():
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split(maxsplit=1)
    n_modules, bad = int(out[0]), out[1].strip()
    # serving, FedSim, the round step, the gossip wire, every architecture,
    # the experiments
    assert n_modules >= 77
    assert bad == "[]", f"repro_torch imported (or is missing) {bad}"


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PORT.rglob("*.py"),
                                         ROOT / "chip_smoke.py"]))
def test_sources_name_no_jax_or_reference(path):
    for line in (ROOT / path).read_text().splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax")), line
        assert not s.startswith(("import repro.", "from repro.",
                                 "from repro import")), line
        assert s != "import repro", line


def test_bf16_bridge_is_bit_exact():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    bits = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    arr = bits.view(ml_dtypes.bfloat16)   # every bf16 pattern, NaNs included
    t = from_numpy(arr, "cpu")
    assert t.dtype == torch.bfloat16 and t.shape == (256, 256)
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), bits)
    # a strided view goes through a contiguous copy, same bits
    t2 = from_numpy(arr[:, ::3], "cpu")
    assert np.array_equal(t2.view(torch.int16).numpy().view(np.uint16),
                          bits[:, ::3])


def test_bf16_bridge_matches_jax_values():
    jnp = pytest.importorskip("jax.numpy")
    x = np.random.default_rng(0).normal(size=(64, 33)).astype(np.float32)
    j = np.asarray(jnp.asarray(x, jnp.bfloat16))
    t = from_numpy(j, "cpu")
    np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
    assert torch.equal(t, torch.from_numpy(x).to(torch.bfloat16))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve(None)
    with pytest.raises(RuntimeError):
        resolve("cuda")
    assert resolve("cpu") == torch.device("cpu")
