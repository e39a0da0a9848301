"""The round step and the train launcher with a "model" axis for mamba2 and
griffin, on the CPU: the port's fused branch over a (4, 2) ("data",
"model") gloo world against the JAX package's round step on its (4, 2)
mesh of fake CPU devices, and the launcher's ``--model-axis 2`` on
mamba2 against its ``--model-axis 1`` run.

- The round step: the smoke mamba2 (8 heads over one group: B and C
  whole on both model ranks), its 2-group variant (the groups split) and
  the smoke griffin (the recurrent width, the MLP and the vocab split,
  the attention whole), f32, C 2 x Dev 2 (R 4, one replica a data rank),
  tau = 2; the reference's ``make_round_step(policy=make_train_policy(
  make_mesh((4, 2), ...)))`` under ``jax.jit`` (XLA backend level 0) and
  ``with mesh:``, the port's ``make_round_step`` on a (4, 2) world from
  the same state (``convert.shard_slabs`` of the reference's
  ``init_state``): an intra round, then from its state a gossip round on
  the sparse int8 wire at per-cluster levels (0.1, 0.6) with the CHOCO
  wire EF.  The reference's sharded tolerances
  (tests/test_sharded_consistency.py:59-76): the losses within 1e-3, the
  parameters, momentum, EF and wire-EF estimates within 5e-3.
- The launcher: the smoke mamba2's ``--mesh single --model-axis 2``
  (fl_single, R 16) on 4 ranks, (2, 2), 2 rounds (intra, then gossip on
  the int8 wire), against ``--model-axis 1`` on 1 rank in this process,
  within the same tolerances.
"""
import importlib.util

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import run_world
from test_torch_round_tensor import (LOSS_TOL, STATE_ATOL, _leaves, _np,
                                     launch)

# the ranks import this module: nothing of JAX at its top
pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the reference needs jax")
MESH = (4, 2)
C, DEV = 2, 2
R = C * DEV
TAU, SEQ = 2, 17
LEVELS = (0.1, 0.6, 1.0)
CLUSTER_LEVELS = (0.1, 0.6)
THETA = (0.08, 0.08, 0.5, 0.5)
HCEF = dict(tau=TAU, q=2, eta=0.1, momentum=0.9, sparse_gossip=True,
            wire_dtype="int8", wire_ef=True, theta_levels=LEVELS)
VARIANTS = {"mamba2": ("mamba2_1p3b", {}),
            "mamba2 groups split": ("mamba2_1p3b", dict(ssm_groups=2)),
            "griffin": ("recurrentgemma_9b", {})}
FIELDS = ("params", "momentum", "ef", "wire_ef")
ARGV = ["--device", "cpu", "--arch", "mamba2_1p3b", "--rounds", "2",
        "--seq", "32", "--tau", "2", "--q", "2", "--sparse-gossip",
        "--wire-dtype", "int8", "--mesh", "single"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tokens(variant):
    rng = np.random.default_rng(7 + list(VARIANTS).index(variant))
    return [rng.integers(0, 257, (R * TAU * 2, SEQ)) for _ in range(2)]


def port_rounds(mesh, params0, bits):
    """Each variant's intra round, then its gossip round from its state,
    on this rank: {variant: (losses of both rounds, gathered state)}."""
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.configs.base import FLTopology, HCEFConfig
    from repro_torch.convert import (gather_slabs, params_from_jax,
                                     shard_slabs)
    from repro_torch.core import round as tround
    from repro_torch.dist.policies import make_train_policy
    topo = FLTopology(C, DEV)
    policy = make_train_policy(mesh, topo, dp_axes=("data",))
    assert (policy.model, policy.local_replicas) == (2, 1)
    out = {}
    for variant, (arch, extra) in VARIANTS.items():
        cfg = smoke_model(get_config(arch).model).replace(**extra)
        toks = tokens(variant)
        vbits = bits[variant]

        def step(g):
            return tround.make_round_step(
                cfg, HCEFConfig(**HCEF), topo, policy, gossip=g, impl="ref",
                cluster_levels=CLUSTER_LEVELS if g else None,
                bits_fn=lambda key, rho_: vbits[key - 1000])

        whole = tround.init_state(cfg, HCEFConfig(**HCEF), topo,
                                  params_from_jax(params0[variant], "cpu"),
                                  device="cpu")
        dims = policy.storage_dims(whole.params)
        cut = lambda t: shard_slabs(t, policy, dims)
        state = whole._replace(**{f: cut(getattr(whole, f))
                                  for f in FIELDS})
        rho, theta = np.full(R, 0.85), np.asarray(THETA)
        losses = []
        for r, g in enumerate((False, True)):
            state, m = step(g)(state, {"tokens": torch.from_numpy(
                toks[r])}, rho, theta, 1000 + r)
            losses.append(m["loss"].numpy())
        out[variant] = (losses, {f: _np(gather_slabs(getattr(state, f),
                                                     policy, dims))
                                 for f in FIELDS})
    return out if mesh.rank == 0 else None


def _reference_mesh():
    from repro.configs.base import FLTopology as JTopo
    from repro.dist.compat import make_mesh
    from repro.dist.policies import make_train_policy as j_policy
    jtopo = JTopo(clusters=C, devices_per_cluster=DEV)
    mesh = make_mesh(MESH, ("data", "model"))
    return jtopo, mesh, j_policy(mesh, jtopo, dp_axes=("data",))


def reference_start(variant):
    """The reference's config, initial state, its parameters (one
    replica, numpy) and the masked-step bits of both rounds."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    arch, extra = VARIANTS[variant]
    jcfg = j_smoke(j_get_config(arch).model).replace(**extra)
    state = jround.init_state(jcfg, JHCEF(**HCEF), _reference_mesh()[0],
                              jax.random.PRNGKey(0))
    rho = jnp.full(R, 0.85, jnp.float32)
    bits = [np.asarray(jax.vmap(
        lambda k, p: jax.random.bernoulli(k, p, (TAU,)))(
            jax.random.split(jax.random.PRNGKey(1000 + r), R), rho),
        np.float32) for r in range(2)]
    return jcfg, state, jax.tree.map(lambda x: np.asarray(x[0]),
                                     state.params), bits


def reference_rounds(variant, jcfg, state):
    """The reference's intra round, then its gossip round from that
    state, on its (4, 2) mesh: (both rounds' losses, every field)."""
    import jax
    import jax.numpy as jnp
    from test_torch_round import FAST_COMPILE, _jit

    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    jtopo, mesh, policy = _reference_mesh()
    toks = tokens(variant)
    rho = jnp.full(R, 0.85, jnp.float32)
    losses = []
    for r, g in enumerate((False, True)):
        step = _jit(jround.make_round_step(
            jcfg, JHCEF(**HCEF), jtopo, policy, gossip=g, impl="ref",
            cluster_levels=CLUSTER_LEVELS if g else None), FAST_COMPILE)
        with mesh:
            state, m = step(state, {"tokens": jnp.asarray(toks[r])}, rho,
                            jnp.asarray(THETA, jnp.float32),
                            jax.random.split(jax.random.PRNGKey(1000 + r),
                                             R))
        losses.append(np.asarray(m["loss"]))
    return losses, {f: _leaves(getattr(state, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's rounds, the (4, 2) world's, the 1-rank launcher in
    this process and the launcher on a (2, 2) world.  The reference
    makes its starting states and compiles its round steps in threads, a
    variant each, the round steps while the worlds run: they share only
    the starting states."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        starts = dict(zip(VARIANTS, pool.map(reference_start, VARIANTS)))
        params0 = {v: st[2] for v, st in starts.items()}
        bits = {v: st[3] for v, st in starts.items()}
        jobs = {v: pool.submit(reference_rounds, v, *starts[v][:2])
                for v in VARIANTS}
        got = run_world(port_rounds, 8, params0, bits, shape=MESH,
                        device="cpu", timeout_s=300,
                        root=tmp_path_factory.mktemp("world"))
        one = launch(None, ARGV)
        ranks = run_world(launch, 4, ARGV + ["--model-axis", "2"],
                          device="cpu", timeout_s=300,
                          root=tmp_path_factory.mktemp("world"))
        want = {v: job.result() for v, job in jobs.items()}
    return want, got[0], one, ranks


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_round_matches_reference(runs, variant):
    """Both rounds' losses for all R, and every field gathered from the
    slabs, within the reference's sharded tolerances."""
    want, got = runs[0][variant], runs[1][variant]
    for w, g in zip(want[0], got[0]):
        assert np.abs(g - w).max() < LOSS_TOL, (g, w)
    for field, leaves in want[1].items():
        assert sorted(got[1][field]) == sorted(leaves), field
        for k, w in leaves.items():
            g = got[1][field][k]
            assert g.shape == w.shape, (field, k)
            err = float(np.abs(g.astype(np.float32)
                               - w.astype(np.float32)).max())
            assert err < STATE_ATOL, (variant, field, k, err)
    assert max(np.abs(v).max() for k, v in got[1]["wire_ef"].items()
               if k.startswith("est_self")) > 0
    assert max(np.abs(v).max() for v in got[1]["ef"].values()) > 0


def test_launcher_model_axis_matches_one_rank(runs):
    """Every rank's history against the 1-rank run, and the state
    gathered from the ranks' slabs against the 1-rank run's last."""
    _, _, (one_hist, one_states), ranks = runs
    for hist, _ in ranks:
        assert len(hist) == 2 and hist[1]["gossip"]
        for h, w in zip(hist, one_hist):
            assert abs(h["loss"] - w["loss"]) < LOSS_TOL
            assert h["theta_mean"] == w["theta_mean"]
            assert len(h["rank_tensor_staged_bytes"]) == 4
    final = ranks[0][1]
    for f, leaves in one_states[-1].items():
        for k, w in leaves.items():
            g = final[f][k]
            assert g.shape == w.shape and g.shape[0] == 16
            err = float(np.abs(g - w).max())
            assert err < STATE_ATOL, (f, k, err)
