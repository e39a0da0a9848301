"""The round step and the train launcher with a "model" axis, on the CPU:
the port's fused branch over a (4, 2) ("data", "model") gloo world
against the JAX package's round step on its (4, 2) mesh of fake CPU
devices, the per-shard Q bit for bit, and the launcher's ``--model-axis
2`` against its ``--model-axis 1`` run.

- Q on the slabs: one seeded delta and EF (the smoke smollm's leaves,
  with smollm-135M's unaligned ``ln1`` and ``final_norm`` beside them and
  one aligned full-width ``wq``), each of the 8 (data, model) slabs cut
  by ``convert.shard_slabs`` and compressed by ``compress_delta``, then
  reassembled, against the reference's ``compress_delta(mesh=, specs=)``
  (its per-leaf shard_map, compression.py:86-105) on (4, 2): bit for bit,
  the shifted block partitions of the unaligned leaves included.
- The round step: the smoke smollm (f32, 4 heads over 2 KV heads: the
  heads split), C 2 x Dev 2 (R 4, one replica a data rank), tau = 2, the
  reference's ``make_round_step(policy=make_train_policy(make_mesh((4,
  2), ...)))`` under ``jax.jit`` (XLA backend level 0) and ``with
  mesh:``; the port's ``make_round_step`` on a (4, 2) world from the same
  state (``convert.shard_slabs`` of the reference's ``init_state``).  An
  intra round, then from its state a gossip round on the dense mix and
  one on the sparse int8 wire at per-cluster levels (0.1, 0.6) with the
  CHOCO wire EF.  The reference's sharded tolerances
  (tests/test_sharded_consistency.py:59-76): the loss within 1e-3, the
  parameters, EF (and momentum, wire-EF estimates) within 5e-3.
- The launcher: ``--mesh single --model-axis 2`` (fl_single, R 16) on 4
  ranks, (2, 2), 2 rounds (intra, then gossip on the int8 wire), against
  ``--model-axis 1`` on 1 rank in this process, within the same
  tolerances; its ``--ckpt-dir`` checkpoints equal, bit for bit, the
  state gathered from the ranks' slabs (``convert.gather_slabs``) after
  each round.
A world of 4 x 2 ranks runs the round step, one of 2 x 2 the launcher.
"""
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import run_world

# the ranks import this module: nothing of JAX at its top
pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the reference needs jax")
LOSS_TOL, STATE_ATOL = 1e-3, 5e-3  # tests/test_sharded_consistency.py
MESH = (4, 2)
C, DEV = 2, 2
R = C * DEV
TAU, SEQ = 2, 17
LEVELS = (0.1, 0.6, 1.0)
THETA = (0.08, 0.08, 0.5, 0.5)
HCEF = dict(tau=TAU, q=2, eta=0.1, momentum=0.9, sparse_gossip=True,
            wire_dtype="int8", wire_ef=True, theta_levels=LEVELS)
SCENARIOS = {"dense": None, "sparse": (0.1, 0.6)}  # cluster levels
ARGV = ["--device", "cpu", "--arch", "smollm_135m", "--rounds", "2",
        "--seq", "32", "--tau", "2", "--q", "2", "--sparse-gossip",
        "--wire-dtype", "int8", "--mesh", "single"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def hcef_kw(sparse):
    kw = dict(HCEF)
    if not sparse:
        kw.update(sparse_gossip=False, wire_ef=False)
    return kw


def tokens():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 257, (R * TAU * 2, SEQ)) for _ in range(2)]


def _np(tree):
    """Copies of a tree's leaves (the round step writes its state in
    place)."""
    from repro_torch.tree import flatten
    return {k: v.numpy().copy() for k, v in flatten(tree).items()}


def port_rounds(mesh, params0, bits):
    """The intra round, then each scenario's gossip round from its state,
    on this rank: {scenario: (losses of both rounds, gathered state)}."""
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.configs.base import FLTopology, HCEFConfig
    from repro_torch.convert import (gather_slabs, params_from_jax,
                                     shard_slabs)
    from repro_torch.core import round as tround
    from repro_torch.dist.policies import make_train_policy
    from repro_torch.tree import tree_map
    topo = FLTopology(C, DEV)
    policy = make_train_policy(mesh, topo, dp_axes=("data",))
    assert (policy.model, policy.local_replicas) == (2, 1)
    cfg = smoke_model(get_config("smollm_135m").model)
    toks = tokens()

    def step(sparse, g, levels=None):
        return tround.make_round_step(
            cfg, HCEFConfig(**hcef_kw(sparse)), topo, policy, gossip=g,
            impl="ref", cluster_levels=levels,
            bits_fn=lambda key, rho_: bits[key - 1000])

    whole = tround.init_state(cfg, HCEFConfig(**HCEF), topo,
                              params_from_jax(params0, "cpu"), device="cpu")
    dims = policy.storage_dims(whole.params)
    cut = lambda t: shard_slabs(t, policy, dims)
    state0 = whole._replace(params=cut(whole.params),
                            momentum=cut(whole.momentum), ef=cut(whole.ef),
                            wire_ef=cut(whole.wire_ef))
    rho, theta = np.full(R, 0.85), np.asarray(THETA)
    state0, m0 = step(False, False)(state0, {"tokens": torch.from_numpy(
        toks[0])}, rho, theta, 1000)
    out = {}
    for sc, levels in SCENARIOS.items():
        state = state0._replace(**{f: tree_map(torch.clone, getattr(
            state0, f)) for f in ("params", "momentum", "ef", "wire_ef")})
        state, m = step(sc == "sparse", True, levels)(
            state, {"tokens": torch.from_numpy(toks[1])}, rho, theta, 1001)
        fields = ("params", "momentum", "ef") + (
            ("wire_ef",) if sc == "sparse" else ())
        out[sc] = ([m0["loss"].numpy(), m["loss"].numpy()],
                   {f: _np(gather_slabs(getattr(state, f), policy, dims))
                    for f in fields})
    return out


def launch(mesh, argv):
    """The launcher: its history and its final state (on ranks gathered
    from every rank's slabs, kept by rank 0); on 1 rank also each
    round's state."""
    from repro_torch.convert import gather_slabs
    from repro_torch.launch import train
    fields = ("params", "momentum", "ef")
    states = []
    out = train.main(argv, on_round=None if mesh is not None else (
        lambda rnd, st, rec: states.append(
            {f: _np(getattr(st, f)) for f in fields})))
    st = out["state"]
    if mesh is not None:
        final = {f: _np(gather_slabs(getattr(st, f), out["policy"],
                                     out["dims"])) for f in fields}
        return out["history"], (final if mesh.rank == 0 else None)
    return out["history"], states


def round_world(mesh, params0, bits):
    """The round step's scenarios; rank 0 returns them."""
    rounds = port_rounds(mesh, params0, bits)
    return rounds if mesh.rank == 0 else None


def _leaves(tree):
    import jax
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference_rounds():
    """The reference's intra round and each scenario's gossip round on
    its (4, 2) mesh, and its initial parameters (one replica) and
    masked-step bits of both rounds."""
    import jax
    import jax.numpy as jnp
    from test_torch_round import FAST_COMPILE, _jit

    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.configs.base import FLTopology as JTopo
    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    from repro.dist.compat import make_mesh
    from repro.dist.policies import make_train_policy as j_policy
    jtopo = JTopo(clusters=C, devices_per_cluster=DEV)
    mesh = make_mesh(MESH, ("data", "model"))
    policy = j_policy(mesh, jtopo, dp_axes=("data",))
    jcfg = j_smoke(j_get_config("smollm_135m").model)
    toks = tokens()

    def step(sparse, g, levels=None):
        return _jit(jround.make_round_step(
            jcfg, JHCEF(**hcef_kw(sparse)), jtopo, policy, gossip=g,
            impl="ref", cluster_levels=levels), FAST_COMPILE)

    rho = jnp.full(R, 0.85, jnp.float32)
    args = lambda r: ({"tokens": jnp.asarray(toks[r])}, rho,
                      jnp.asarray(THETA, jnp.float32),
                      jax.random.split(jax.random.PRNGKey(1000 + r), R))
    state0 = jround.init_state(jcfg, JHCEF(**HCEF), jtopo,
                               jax.random.PRNGKey(0))
    params0 = jax.tree.map(lambda x: np.asarray(x[0]), state0.params)
    bits = [np.asarray(jax.vmap(
        lambda k, p: jax.random.bernoulli(k, p, (TAU,)))(
            jax.random.split(jax.random.PRNGKey(1000 + r), R), rho),
        np.float32) for r in range(2)]
    with mesh:
        state0, m0 = step(False, False)(state0, *args(0))
    out = {}
    for sc, levels in SCENARIOS.items():
        with mesh:
            state, m = step(sc == "sparse", True, levels)(state0, *args(1))
        fields = ("params", "momentum", "ef") + (
            ("wire_ef",) if sc == "sparse" else ())
        out[sc] = ([np.asarray(m0["loss"]), np.asarray(m["loss"])],
                   {f: _leaves(getattr(state, f)) for f in fields})
    return out, params0, bits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's rounds, the (4, 2) world's, the 1-rank launcher
    in this process and the launcher on a (2, 2) world: (reference, port
    rounds, 1-rank launcher, [rank launcher results], checkpoint
    directory)."""
    want, params0, bits = reference_rounds()
    got = run_world(round_world, 8, params0, bits, shape=MESH,
                    device="cpu", timeout_s=300,
                    root=tmp_path_factory.mktemp("world"))
    one = launch(None, ARGV)
    ckpt = tmp_path_factory.mktemp("ckpt")
    argv = ARGV + ["--model-axis", "2", "--ckpt-dir", str(ckpt)]
    ranks = run_world(launch, 4, argv, device="cpu", timeout_s=300,
                      root=tmp_path_factory.mktemp("world"))
    return want, got[0], one, ranks, ckpt


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_round_matches_reference(runs, scenario):
    """Both rounds' losses for all R, and every field gathered from the
    slabs, within the reference's sharded tolerances."""
    want, got = runs[0][scenario], runs[1][scenario]
    for w, g in zip(want[0], got[0]):
        assert np.abs(g - w).max() < LOSS_TOL, (g, w)
    for field, leaves in want[1].items():
        assert sorted(got[1][field]) == sorted(leaves), field
        for k, w in leaves.items():
            g = got[1][field][k]
            assert g.shape == w.shape, (field, k)
            err = float(np.abs(g.astype(np.float32)
                               - w.astype(np.float32)).max())
            assert err < STATE_ATOL, (field, k, err)
    if scenario == "sparse":
        assert max(np.abs(v).max() for k, v in got[1]["wire_ef"].items()
                   if k.startswith("est_self")) > 0
    assert max(np.abs(v).max() for v in got[1]["ef"].values()) > 0


def test_launcher_model_axis_matches_one_rank(runs):
    """Every rank's history against the 1-rank run; each round's
    checkpoint (all R rows, whole leaves) against the 1-rank state of
    that round."""
    from repro_torch.runtime.checkpoint import META_KEY
    _, _, (one_hist, one_states), ranks, ckpt = runs
    for hist, _ in ranks:
        assert len(hist) == 2 and hist[1]["gossip"]
        for h, w in zip(hist, one_hist):
            assert abs(h["loss"] - w["loss"]) < LOSS_TOL
            assert h["theta_mean"] == w["theta_mean"]
            assert len(h["rank_tensor_staged_bytes"]) == 4
    for rnd, want in enumerate(one_states):
        with np.load(Path(ckpt) / f"ckpt_{rnd:06d}.npz") as data:
            keys = [k for k in data.files
                    if k not in (META_KEY, "round_idx")]
            assert sorted(keys) == sorted(
                f"{f}/{k}" for f, v in want.items() for k in v)
            for f, leaves in want.items():
                for k, w in leaves.items():
                    g = data[f"{f}/{k}"]
                    assert g.shape == w.shape and g.shape[0] == 16
                    err = float(np.abs(g - w).max())
                    assert err < STATE_ATOL, (rnd, f, k, err)


def test_checkpoint_is_the_gathered_state(runs):
    """The last checkpoint, written by rank 0 from every rank's slab,
    equals the state every rank gathers, bit for bit."""
    _, _, _, ranks, ckpt = runs
    final = ranks[0][1]
    with np.load(Path(ckpt) / "ckpt_000001.npz") as data:
        for f, leaves in final.items():
            for k, w in leaves.items():
                g = data[f"{f}/{k}"]
                assert g.dtype == w.dtype and np.array_equal(g, w), (f, k)
        assert int(data["round_idx"]) == 2


def _slab_tree(full, d, m, dims):
    """(d, m)'s slab of a stacked tree through ``convert.shard_slabs``,
    with a stand-in policy at that coordinate of a (4, 2) mesh."""
    from repro_torch.convert import shard_slabs
    mesh = types.SimpleNamespace(
        size=lambda axes: int(np.prod([dict(data=4, model=2)[a]
                                       for a in axes])),
        flat_index=lambda axes: d if tuple(axes) == ("data",) else 0)
    pol = types.SimpleNamespace(mesh=mesh, replica_axes=("data",),
                                tensor_axes=("model",), model=2,
                                model_index=m)
    return shard_slabs(full, pol, dims)


def test_per_shard_q_is_the_reference_bit_for_bit():
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.compression import compress_delta as j_compress
    from repro.dist.compat import make_mesh
    from repro.dist.policies import make_train_policy as j_policy
    from repro.configs.base import FLTopology as JTopo
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.core.compression import compress_delta
    from repro_torch.dist.policies import leaf_split
    from repro_torch.models import lm
    from repro_torch.tree import flatten, tree_map
    cfg = smoke_model(get_config("smollm_135m").model)
    shapes = flatten(tree_map(lambda v: (R,) + tuple(v.shape),
                              lm.init(cfg, device="meta")))
    # smollm-135M's unaligned norms and an aligned full-width weight
    shapes.update({"full/ln1": (R, 30, 576), "full/final_norm": (R, 576),
                   "full/wq": (R, 2, 576, 576)})
    rng = np.random.default_rng(11)
    delta = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    ef = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
          for k, s in shapes.items()}
    theta = np.asarray([0.1, 0.3, 0.6, 1.0], np.float32)
    dims = {k: leaf_split(s, 2) for k, s in shapes.items()}
    assert dims["full/ln1"] == 2 and dims["full/final_norm"] == 1
    assert dims["full/wq"] == 2 and dims["emb"] == 1

    mesh = make_mesh(MESH, ("data", "model"))
    jpol = j_policy(mesh, JTopo(C, DEV), dp_axes=("data",))
    specs = {k: jpol._leaf_spec(s, stacked=True) for k, s in shapes.items()}
    with mesh:
        jc, je = jax.jit(lambda d, e, t: j_compress(
            d, e, t, block=1024, mesh=mesh, specs=specs,
            replica_spec=P("data")))(
                {k: jnp.asarray(v) for k, v in delta.items()},
                {k: jnp.asarray(v) for k, v in ef.items()},
                jnp.asarray(theta))
    comp = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    res = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for d in range(MESH[0]):
        for m in range(MESH[1]):
            td = _slab_tree({k: torch.from_numpy(v) for k, v in
                             delta.items()}, d, m, dims)
            te = _slab_tree({k: torch.from_numpy(v) for k, v in
                             ef.items()}, d, m, dims)
            c, e = compress_delta(td, te, torch.from_numpy(theta[d:d + 1]),
                                  block=1024)
            for k, s in shapes.items():
                idx = [slice(d, d + 1)] + [slice(None)] * (len(s) - 1)
                if dims[k] is not None:
                    n = s[dims[k]] // 2
                    idx[dims[k]] = slice(m * n, (m + 1) * n)
                comp[k][tuple(idx)] = c[k].numpy()
                res[k][tuple(idx)] = e[k].numpy()
    for k in shapes:
        assert np.array_equal(comp[k], np.asarray(jc[k])), k
        assert np.array_equal(res[k], np.asarray(je[k])), k
    # the unaligned leaves' shard-local Q is not the unsharded Q
    c1, _ = compress_delta({"x": torch.from_numpy(delta["full/ln1"].copy())},
                           {"x": torch.from_numpy(ef["full/ln1"].copy())},
                           torch.from_numpy(theta), block=1024)
    assert not np.array_equal(c1["x"].numpy(), comp["full/ln1"])
