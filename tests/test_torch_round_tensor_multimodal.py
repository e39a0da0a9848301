"""The round step and the train launcher with a "model" axis for
internvl2-2b's ViT stub and seamless-m4t-large-v2's encoder-decoder, and
the overlap engine, chaos masks and the population store on that axis, on
the CPU: the port's fused branch over a (4, 2) ("data", "model") gloo
world against the JAX package's round steps on its (4, 2) mesh of fake
CPU devices, and the launcher's ``--model-axis 2`` against its
``--model-axis 1`` run.

- The round step: the smoke internvl2-2b (4 heads over 2 KV heads of 16,
  8 patch positions) and seamless-m4t-large-v2 (4 over 4, 2 encoder and 2
  decoder layers), f32, C 2 x Dev 2 (R 4, one replica a data rank), tau =
  2, the patch embeddings or frames N(0, 1) beside the tokens; the
  reference's ``make_round_step(policy=make_train_policy(make_mesh((4,
  2), ...)))`` under ``jax.jit`` (XLA backend level 0) and ``with
  mesh:``, the port's on a (4, 2) world from the same state
  (``convert.shard_slabs`` of the reference's ``init_state``): an intra
  round, then from its state three gossip rounds, each on the sparse
  int8 wire at per-cluster levels (0.1, 0.6): with the CHOCO wire EF;
  under chaos masks (device 2 dropped, cluster 1's backhaul cut: no wire
  EF, which a cut cannot take); and the overlapped step at staleness 1,
  every cluster stale, ``pending`` the intra round's model, against the
  reference's ``make_overlap_round_step`` under the same policy.  The
  reference's sharded tolerances (tests/test_sharded_consistency.py:
  59-76): the losses within 1e-3, the parameters, momentum, EF and
  wire-EF estimates within 5e-3.
- The launcher: ``--mesh single --model-axis 2`` (fl_single, R 16) on 4
  ranks, (2, 2), 2 rounds (intra, then gossip on the int8 wire): the
  smoke internvl2-2b with ``--overlap --staleness 1 --stale-quantile
  0.2`` (every cluster stale in the gossip round) and the smoke
  seamless-m4t-large-v2 with ``--chaos --population 32
  --verify-conservation --ckpt-dir``, each against ``--model-axis 1`` on
  1 rank in this process: the histories' discrete parts (stale sets,
  faults, cohorts, the controller's and the cost model's numbers) equal,
  every swap's sums conserved, the losses and the state gathered from the
  slabs within the same tolerances; the store's accounting on every rank
  and the checkpoint directory's manifests (accounting and page
  versions) equal, its checkpoints within the state tolerance and every
  client's page within PAGE_RTOL of each leaf's largest entry; the same
  run with the swap's slabs joined in the wrong order fails that check.
A world of 4 x 2 ranks runs the round step, one of 2 x 2 each launcher
run.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import run_world
from test_torch_round_tensor import LOSS_TOL, STATE_ATOL, _leaves, _np

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
# the masked and the overlapped gossip rounds: the wire without its EF
HCEF_NO_WEF = dict(HCEF, wire_ef=False, overlap=True, staleness=1)
ALIVE = np.array([1.0, 1.0, 0.0, 1.0], np.float32)
CONN = np.array([1.0, 0.0], np.float32)
ARCHS = {"internvl2_2b": ("patch_embeds", 8),
         "seamless_m4t_large_v2": ("frames", SEQ)}
SCENARIOS = ("sparse", "chaos", "overlap")  # the gossip rounds
FIELDS = ("params", "momentum", "ef", "wire_ef")
ARGV = ["--device", "cpu", "--rounds", "2", "--seq", "16", "--tau", "2",
        "--q", "2", "--sparse-gossip", "--wire-dtype", "int8", "--mesh",
        "single"]
# name: (arch, extra arguments; a trailing --ckpt-dir takes a directory)
RUNS = {"overlap": ("internvl2_2b", ["--overlap", "--staleness", "1",
                                     "--stale-quantile", "0.2"]),
        "population": ("seamless_m4t_large_v2",
                       ["--chaos", "--population", "32",
                        "--verify-conservation", "--ckpt-dir"])}
# a client page's leaves against the --model-axis 1 run's, relative to
# the leaf's largest entry: a slab joined in the wrong order moves entries
# by their own size, where the f32 sums' order moves them by the rounding
# of what they are the difference of (here at most 5.8e-7; the smoke
# smollm's EF under chaos 9.7e-5, 3.7e-9 on 3.8e-5).  The checkpoints'
# state is held to the reference's STATE_ATOL (top-k picks that flip
# reach 2e-3 of a leaf's largest entry); their join is held bit for bit
# against ``convert.gather_slabs`` in tests/test_torch_round_tensor.py.
PAGE_RTOL = 1e-3
HOST_KEYS = ("gossip", "rho_mean", "theta_mean", "time", "energy", "stale",
             "cohort", "participation", "n_deadline_missed", "coordinator",
             "n_partitioned", "degraded")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def round_inputs(arch):
    """Both rounds' tokens and frontend inputs, numpy."""
    key, positions = ARCHS[arch]
    rng = np.random.default_rng(11 + list(ARCHS).index(arch))
    n = R * TAU * 2
    return [{"tokens": rng.integers(0, 257, (n, SEQ)),
             key: rng.standard_normal((n, positions, 64), dtype=np.float32)}
            for _ in range(2)]


def _weights():
    from repro_torch.dist.collectives import participation_weights
    return participation_weights(ALIVE, clusters=C, dev=DEV)


def port_rounds(mesh, params0, bits):
    """Each config's intra round, then each scenario's gossip round from
    its state, on this rank: {arch: {scenario: (losses, stale_frac or
    None, gathered state)}} on rank 0."""
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
    rho, theta = np.full(R, 0.85), np.asarray(THETA)
    out = {}
    for arch in ARCHS:
        cfg = smoke_model(get_config(arch).model)
        ins = [{k: torch.from_numpy(v) for k, v in r.items()}
               for r in round_inputs(arch)]
        abits = bits[arch]
        kw = dict(impl="ref", bits_fn=lambda key, rho_: abits[key - 1000])
        whole = tround.init_state(cfg, HCEFConfig(**HCEF), topo,
                                  params_from_jax(params0[arch], "cpu"),
                                  device="cpu")
        dims = policy.storage_dims(whole.params)
        state0 = whole._replace(**{f: shard_slabs(getattr(whole, f), policy,
                                                  dims) for f in FIELDS})
        state0, m0 = tround.make_round_step(
            cfg, HCEFConfig(**HCEF), topo, policy, gossip=False, **kw)(
                state0, ins[0], rho, theta, 1000)
        copy = lambda: state0._replace(**{f: tree_map(
            torch.clone, getattr(state0, f)) for f in FIELDS})
        out[arch] = {"intra": ([m0["loss"].numpy()], None, {
            f: _np(gather_slabs(getattr(state0, f), policy, dims))
            for f in FIELDS})}
        for sc in SCENARIOS:
            hcef = HCEFConfig(**(HCEF if sc == "sparse" else HCEF_NO_WEF))
            args = (ins[1], rho, theta, 1001)
            if sc == "overlap":
                st = tround.OverlapState(fl=copy(), pending=tree_map(
                    torch.clone, state0.params))
                st, m = tround.make_overlap_round_step(
                    cfg, hcef, topo, policy, gossip=True,
                    cluster_levels=CLUSTER_LEVELS, **kw)(st, *args)
                st = st.fl
            else:
                masks = (dict(alive=ALIVE, alive_w=_weights(), conn=CONN)
                         if sc == "chaos" else {})
                st, m = tround.make_round_step(
                    cfg, hcef, topo, policy, gossip=True,
                    cluster_levels=CLUSTER_LEVELS, **kw)(copy(), *args,
                                                         **masks)
            frac = m.get("stale_frac")
            out[arch][sc] = ([m0["loss"].numpy(), m["loss"].numpy()],
                             None if frac is None else float(frac),
                             {f: _np(gather_slabs(getattr(st, f), policy,
                                                  dims))
                              for f in FIELDS})
    return out if mesh.rank == 0 else None


def _reference_mesh():
    from repro.configs.base import FLTopology as JTopo
    from repro.dist.compat import make_mesh
    from repro.dist.policies import make_train_policy as j_policy
    jtopo = JTopo(clusters=C, devices_per_cluster=DEV)
    mesh = make_mesh(MESH, ("data", "model"))
    return jtopo, mesh, j_policy(mesh, jtopo, dp_axes=("data",))


def reference_start(arch):
    """The reference's config, initial state, its parameters (one
    replica, numpy) and the masked-step bits of both rounds."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    jcfg = j_smoke(j_get_config(arch).model)
    state = jround.init_state(jcfg, JHCEF(**HCEF), _reference_mesh()[0],
                              jax.random.PRNGKey(0))
    rho = jnp.full(R, 0.85, jnp.float32)
    bits = [np.asarray(jax.vmap(
        lambda k, p: jax.random.bernoulli(k, p, (TAU,)))(
            jax.random.split(jax.random.PRNGKey(1000 + r), R), rho),
        np.float32) for r in range(2)]
    return jcfg, state, jax.tree.map(lambda x: np.asarray(x[0]),
                                     state.params), bits


def reference_rounds(arch, jcfg, state):
    """The reference's intra round, then each scenario's gossip round
    from its state, on its (4, 2) mesh."""
    import jax
    import jax.numpy as jnp
    from test_torch_round import FAST_COMPILE, _jit

    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    jtopo, mesh, policy = _reference_mesh()
    ins = [{k: jnp.asarray(v) for k, v in r.items()}
           for r in round_inputs(arch)]
    rho = jnp.full(R, 0.85, jnp.float32)
    theta = jnp.asarray(THETA, jnp.float32)
    keys = lambda r: jax.random.split(jax.random.PRNGKey(1000 + r), R)
    step = _jit(jround.make_round_step(jcfg, JHCEF(**HCEF), jtopo, policy,
                                       gossip=False, impl="ref"),
                FAST_COMPILE)
    with mesh:
        state0, m0 = step(state, ins[0], rho, theta, keys(0))
    out = {"intra": ([np.asarray(m0["loss"])], None,
                     {f: _leaves(getattr(state0, f)) for f in FIELDS})}
    for sc in SCENARIOS:
        hcef = JHCEF(**(HCEF if sc == "sparse" else HCEF_NO_WEF))
        if sc == "overlap":
            step = _jit(jround.make_overlap_round_step(
                jcfg, hcef, jtopo, policy, gossip=True, impl="ref",
                cluster_levels=CLUSTER_LEVELS), FAST_COMPILE)
            start, extra = jround.OverlapState(fl=state0,
                                               pending=state0.params), ()
        else:
            step = _jit(jround.make_round_step(
                jcfg, hcef, jtopo, policy, gossip=True, impl="ref",
                cluster_levels=CLUSTER_LEVELS), FAST_COMPILE)
            start = state0
            extra = ((jnp.asarray(ALIVE), jnp.asarray(_weights()),
                      jnp.asarray(CONN)) if sc == "chaos" else ())
        with mesh:
            st, m = step(start, ins[1], rho, theta, keys(1), *extra)
        if sc == "overlap":
            st = st.fl
        frac = m.get("stale_frac")
        out[sc] = ([np.asarray(m0["loss"]), np.asarray(m["loss"])],
                   None if frac is None else float(frac),
                   {f: _leaves(getattr(st, f)) for f in FIELDS})
    return out


def launch(mesh, argv):
    """The launcher on this rank: its history's host keys and losses, its
    state (on ranks gathered from the slabs, kept by rank 0) with
    ``pending``, the store's accounting, the swap bytes."""
    from repro_torch.convert import gather_slabs
    from repro_torch.launch import train
    from repro_torch.tree import flatten
    out = train.main(argv)
    st = out["state"]
    fl = st.fl if hasattr(st, "fl") else st
    tree = {f: getattr(fl, f) for f in ("params", "momentum", "ef")}
    if hasattr(st, "pending"):
        tree["pending"] = st.pending
    if mesh is not None:
        tree = {f: gather_slabs(t, out["policy"], out["dims"])
                for f, t in tree.items()}
    state = {f: {k: v.numpy() for k, v in flatten(t).items()}
             for f, t in tree.items()}
    hist = []
    for h in out["history"]:
        keep = {k: h[k] for k in HOST_KEYS + ("loss",) if k in h}
        if "swap_check" in h:
            keep["swap_check"] = {k: v for k, v in h["swap_check"].items()
                                  if k != "host_ms"}
        hist.append(keep)
    store = out["pop_store"]
    acct = None if store is None else {
        a: np.array(getattr(store, a)) for a in (
            "rounds_participated", "last_round", "energy_spent",
            "time_spent")}
    return {"history": hist, "acct": acct, "swap_bytes": out["swap_bytes"],
            "state": state if mesh is None or mesh.rank == 0 else None}


def _argv(name, root):
    arch, extra = RUNS[name]
    if extra[-1] == "--ckpt-dir":
        extra = extra + [str(root)]
    return ARGV + ["--arch", arch] + extra


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's rounds, the (4, 2) world's, and each launcher run
    on 1 rank here and on a (2, 2) world.  The reference makes its
    starting states and compiles its round steps in threads, a config
    each, the round steps while the worlds run."""
    from concurrent.futures import ThreadPoolExecutor
    dirs = {name: (tmp_path_factory.mktemp(f"{name}_one"),
                   tmp_path_factory.mktemp(f"{name}_ranks"))
            for name in RUNS}
    with ThreadPoolExecutor(len(ARCHS)) as pool:
        starts = dict(zip(ARCHS, pool.map(reference_start, ARCHS)))
        params0 = {a: st[2] for a, st in starts.items()}
        bits = {a: st[3] for a, st in starts.items()}
        jobs = {a: pool.submit(reference_rounds, a, *starts[a][:2])
                for a in ARCHS}
        got = run_world(port_rounds, 8, params0, bits, shape=MESH,
                        device="cpu", timeout_s=300,
                        root=tmp_path_factory.mktemp("world"))
        launched = {}
        for name in RUNS:
            one = launch(None, _argv(name, dirs[name][0]))
            ranks = run_world(launch, 4, _argv(name, dirs[name][1])
                              + ["--model-axis", "2"], device="cpu",
                              timeout_s=300,
                              root=tmp_path_factory.mktemp("world"))
            launched[name] = (one, ranks) + dirs[name]
        want = {a: job.result() for a, job in jobs.items()}
    return want, got[0], launched


def _state_close(got, want, label):
    for field, leaves in want.items():
        assert sorted(got[field]) == sorted(leaves), (label, field)
        for k, w in leaves.items():
            g = got[field][k]
            assert g.shape == w.shape, (label, field, k)
            err = float(np.abs(g.astype(np.float32)
                               - w.astype(np.float32)).max())
            assert err < STATE_ATOL, (label, field, k, err)


@pytest.mark.parametrize("scenario", ("intra",) + SCENARIOS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_round_matches_reference(runs, arch, scenario):
    """The rounds' losses for all R, the overlapped round's stale share,
    and every field gathered from the slabs, within the reference's
    sharded tolerances."""
    want, got = runs[0][arch][scenario], runs[1][arch][scenario]
    for w, g in zip(want[0], got[0]):
        assert np.abs(g - w).max() < LOSS_TOL, (g, w)
    assert got[1] == want[1]
    assert (got[1] == 1.0) == (scenario == "overlap")
    _state_close(got[2], want[2], (arch, scenario))
    if scenario == "sparse":
        assert max(np.abs(v).max() for k, v in got[2]["wire_ef"].items()
                   if k.startswith("est_self")) > 0
    if scenario != "intra":  # every gossip round moved the model
        moved = max(float(np.abs(v - runs[1][arch]["intra"][2]["params"][k])
                          .max()) for k, v in got[2]["params"].items())
        assert moved > 1e-4


def test_chaos_dropped_device_keeps_its_update_in_ef(runs):
    """The dropped device's compressed update folds into its EF: its EF
    row moves away from the fault-free round's."""
    for arch in ARCHS:
        ef = runs[1][arch]["chaos"][2]["ef"]
        free = runs[1][arch]["sparse"][2]["ef"]
        assert max(float(np.abs(ef[k][2] - free[k][2]).max())
                   for k in ef) > 1e-4


@pytest.mark.parametrize("name", sorted(RUNS))
def test_launcher_model_axis_matches_one_rank(runs, name):
    """Every rank's history: its discrete parts and the host's numbers
    equal, the losses within the sharded tolerance; the state gathered
    from the slabs within it."""
    one, ranks, _, _ = runs[2][name]
    assert len(ranks) == 4
    for out in ranks:
        assert len(out["history"]) == len(one["history"]) == 2
        for h, w in zip(out["history"], one["history"]):
            assert abs(h["loss"] - w["loss"]) < LOSS_TOL
            for k in HOST_KEYS:
                assert h.get(k) == w.get(k), (name, k)
            if "swap_check" in w:
                assert h["swap_check"]["equal"] and \
                    w["swap_check"]["equal"]
                for k in ("ef_before", "ef_after", "state_before",
                          "state_after"):
                    assert abs(h["swap_check"][k] - w["swap_check"][k]) \
                        < STATE_ATOL * 64, (k, h["swap_check"][k],
                                            w["swap_check"][k])
    hist = one["history"]
    if name == "overlap":
        assert hist[1]["stale"] == list(range(8)) and "stale" not in hist[0]
        for k, v in ranks[0]["state"]["pending"].items():
            assert np.array_equal(v, ranks[0]["state"]["params"][k])
    else:
        assert any(h["degraded"] for h in hist)
        assert sum("swap_check" in h for h in hist) == 1
        assert len({tuple(h["cohort"]) for h in hist}) > 1
    _state_close(ranks[0]["state"], one["state"], name)
    assert all(out["state"] is None for out in ranks[1:])


def test_population_accounting_on_every_rank(runs):
    one, ranks, _, _ = runs[2]["population"]
    assert one["acct"]["rounds_participated"].sum() == 2 * 16
    for out in ranks:
        for a, v in one["acct"].items():
            np.testing.assert_array_equal(out["acct"][a], v, err_msg=a)
        assert out["swap_bytes"] == one["swap_bytes"]


def _pages(ckpt_dir, manifest):
    """Every client's page that ``manifest`` pins, read back through a
    store restored from it: {client: {leaf: array}}."""
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.core.round import client_template, init_state
    from repro_torch.models import lm
    from repro_torch.runtime.population import PopulationStore
    bundle = get_config(RUNS["population"][0])
    cfg = smoke_model(bundle.model)
    tmpl = client_template(init_state(cfg, bundle.hcef, bundle.fl_single,
                                      lm.init(cfg, device="meta"),
                                      device="meta", replicas=1))
    store = PopulationStore(32, tmpl, root=Path(ckpt_dir) / "pop_store")
    store.restore(Path(ckpt_dir) / manifest)
    return {cid: {k: v.numpy() for k, v in
                  zip(store.keys, store._client_rows(cid, lru=False))}
            for cid in sorted(store.touched)}


def _leaf_rel(a, b):
    """|a - b|'s largest entry over a's largest |entry| (float64)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    if not a.size:
        return 0.0
    return float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)


def _pages_rel(want, got):
    """The largest of every client page leaf's ``_leaf_rel``, or inf where
    the pages differ in clients or shapes."""
    if sorted(got) != sorted(want):
        return float("inf")
    worst = 0.0
    for cid, leaves in want.items():
        for k, w in leaves.items():
            if got[cid][k].shape != w.shape:
                return float("inf")
            worst = max(worst, _leaf_rel(w, got[cid][k]))
    return worst


def test_rank_zero_writes_the_one_rank_manifests_and_pages(runs):
    """The checkpoint directory: the same files; each manifest's
    accounting and page versions equal; each checkpoint (all R rows, the
    reference's layout) within the state tolerance; every pinned client
    page's leaves within PAGE_RTOL of their largest entry."""
    _, _, d_one, d_ranks = runs[2]["population"]
    names = sorted(p.relative_to(d_one).as_posix()
                   for p in Path(d_one).rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(d_ranks).as_posix()
                           for p in Path(d_ranks).rglob("*") if p.is_file())
    assert [n for n in names if n.endswith(".pop.npz")] == [
        f"ckpt_{r:06d}.pop.npz" for r in range(2)]
    assert any(n.startswith("pop_store/") for n in names)
    for n in names:
        if not n.endswith(".npz"):
            continue
        with np.load(Path(d_one) / n) as w, np.load(Path(d_ranks) / n) as g:
            assert sorted(g.files) == sorted(w.files), n
            for k in w.files:
                a, b = w[k], g[k]
                assert a.shape == b.shape and a.dtype == b.dtype, (n, k)
                if ".pop" in n or k.startswith("__"):
                    assert np.array_equal(a, b), (n, k)
                else:
                    assert a.ndim == 0 or a.shape[0] == 16, (n, k)
                    err = float(np.abs(a.astype(np.float64)
                                       - b.astype(np.float64)).max()) \
                        if a.size else 0.0
                    assert err < STATE_ATOL, (n, k, err)
    want = _pages(d_one, "ckpt_000001.pop.npz")
    got = _pages(d_ranks, "ckpt_000001.pop.npz")
    # the first cohort's 16 clients, paged out by the swap before round 1
    assert len(want) == 16
    assert max(float(np.abs(v).max()) for leaves in want.values()
               for k, v in leaves.items() if k.startswith("momentum/")) > 0
    assert _pages_rel(want, got) < PAGE_RTOL


def launch_misjoined(mesh, argv):
    """``launch`` with a fault planted in the cohort swap: each leaf's
    model pieces joined in reverse rank order on rank 0's host."""
    from repro_torch import convert
    real = convert.gather_slabs_to_host

    def reversed_join(tree, policy, dims):
        out = real(tree, policy, dims)
        flip = lambda x, d: x if d is None else torch.cat(
            x.chunk(policy.model, dim=d)[::-1], dim=d)
        return None if out is None else convert._walk(flip, out, dims)
    convert.gather_slabs_to_host = reversed_join
    try:
        return launch(mesh, argv)
    finally:
        convert.gather_slabs_to_host = real


def test_a_misjoined_swap_fails_the_page_check(runs, tmp_path):
    """The page check has teeth: with the swap's slabs joined in the
    wrong rank order, the pages leave PAGE_RTOL far behind."""
    _, _, d_one, _ = runs[2]["population"]
    (tmp_path / "world").mkdir()
    run_world(launch_misjoined, 4, _argv("population", tmp_path)
              + ["--model-axis", "2"], device="cpu", timeout_s=300,
              root=tmp_path / "world")
    want = _pages(d_one, "ckpt_000001.pop.npz")
    assert _pages_rel(want, _pages(tmp_path, "ckpt_000001.pop.npz")) > 0.1
