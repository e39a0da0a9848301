"""The train launcher's ``--overlap``, ``--population`` and ``--ckpt-dir``
with the FL replicas split over gloo ranks on the CPU, each held to the
same launcher on 1 rank in this process.

The smoke smollm (f32), tau = q = 2, 4 rounds (rounds 1 and 3 gossip on
the int4 wire at per-cluster levels), 33-token sequences:
  * ``--mesh single --overlap --staleness 1`` on 2 ranks (fl_single, R
    16, layout B): every rank's history (losses, stale sets, the cost
    model's time) and the ranks' rows of the working state and of
    ``pending``;
  * ``--mesh single --population 32 --ckpt-dir --verify-conservation``
    on 2 ranks: the histories (cohorts, the swaps' sums), the rows, and
    every file of the checkpoint directory: each checkpoint's and
    manifest's arrays and meta, and every page's bytes (the store lives
    on rank 0);
  * ``--mesh multi --population 64 --store-root`` on 4 ranks of ("pod",
    "data") = (2, 2) (fl_multi, R 32): histories, rows, the store's
    accounting on every rank.
Rows bit for bit, as the 1-rank run's sums run in the same order; losses
within 1e-6 relative (the mean of the gathered metrics).
"""
import hashlib
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import run_world
from repro_torch.launch import train

ARGV = ["--device", "cpu", "--arch", "smollm_135m", "--rounds", "4",
        "--seq", "32", "--tau", "2", "--q", "2", "--sparse-gossip",
        "--wire-dtype", "int4"]
# name: (ranks, extra arguments)
RUNS = {"overlap": (2, ["--mesh", "single", "--overlap", "--staleness", "1"]),
        "ckpt": (2, ["--mesh", "single", "--population", "32",
                     "--verify-conservation", "--ckpt-dir"]),
        "multi": (4, ["--mesh", "multi", "--population", "64",
                      "--store-root"])}
HOST_KEYS = ("loss", "gossip", "rho_mean", "theta_mean", "time", "energy",
             "stale", "cohort", "swap_check")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def launch(mesh, argv):
    """The launcher on this rank: its history's host keys (the swap
    check without its host ms), its rows, the store's accounting."""
    from repro_torch.tree import flatten
    out = train.main(argv)
    st = out["state"]
    fl = st.fl if hasattr(st, "fl") else st
    rows = {f: {k: v.numpy() for k, v in flatten(getattr(fl, f)).items()}
            for f in ("params", "momentum", "ef")}
    if hasattr(st, "pending"):
        rows["pending"] = {k: v.numpy()
                           for k, v in flatten(st.pending).items()}
    hist = []
    for h in out["history"]:
        h = {k: h[k] for k in HOST_KEYS if k in h}
        if "swap_check" in h:
            h["swap_check"] = {k: v for k, v in h["swap_check"].items()
                               if k != "host_ms"}
        hist.append(h)
    store = out["pop_store"]
    acct = None if store is None else {
        a: np.array(getattr(store, a)) for a in (
            "rounds_participated", "last_round", "energy_spent",
            "time_spent")}
    return {"history": hist, "rows": rows, "acct": acct,
            "first": out["policy"].first_replica,
            "swap_bytes": out["swap_bytes"]}


def _argv(name, root):
    n, extra = RUNS[name]
    if extra[-1] in ("--ckpt-dir", "--store-root"):
        extra = extra + [str(root)]
    return ARGV + extra


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (1-rank result, the ranks' results, the 1-rank and the
    ranks' checkpoint directories)}: the 1-rank runs here, the worlds in
    threads meanwhile."""
    got, threads = {}, []
    dirs = {name: (tmp_path_factory.mktemp(f"{name}_one"),
                   tmp_path_factory.mktemp(f"{name}_ranks"))
            for name in RUNS}

    def world(name):
        try:
            got[name] = run_world(launch, RUNS[name][0],
                                  _argv(name, dirs[name][1]), device="cpu",
                                  timeout_s=240,
                                  root=tmp_path_factory.mktemp("world"))
        except BaseException as e:  # raised below
            got[name] = e

    for name in RUNS:
        threads.append(threading.Thread(target=world, args=(name,)))
        threads[-1].start()
    one = {name: launch(None, _argv(name, dirs[name][0])) for name in RUNS}
    for t in threads:
        t.join()
    for g in got.values():
        if isinstance(g, BaseException):
            raise g
    return {name: (one[name], got[name]) + dirs[name] for name in RUNS}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_every_rank_has_the_one_rank_history(runs, name):
    one, many, _, _ = runs[name]
    for out in many:
        assert len(out["history"]) == len(one["history"]) == 4
        for h, w in zip(out["history"], one["history"]):
            np.testing.assert_allclose(h["loss"], w["loss"], rtol=1e-6)
            assert ({k: v for k, v in h.items() if k != "loss"}
                    == {k: v for k, v in w.items() if k != "loss"})
    if name == "overlap":
        stale = [h.get("stale") for h in one["history"]]
        assert stale[0] is None and stale[2] is None
        assert stale[1] and stale[3]  # gossip rounds run stale clusters
    else:
        checks = [h["swap_check"] for h in one["history"]
                  if "swap_check" in h]
        assert len(checks) == (3 if name == "ckpt" else 0)
        assert all(c["equal"] for c in checks)
        assert len({tuple(h["cohort"]) for h in one["history"]}) > 1


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranks_rows_are_the_one_rank_state(runs, name):
    one, many, _, _ = runs[name]
    parts = sorted(many, key=lambda o: o["first"])
    for f, leaves in one["rows"].items():
        for k, w in leaves.items():
            got = np.concatenate([o["rows"][f][k] for o in parts])
            np.testing.assert_array_equal(got, w, err_msg=f"{f} {k}")
    if name == "overlap":
        for k, v in one["rows"]["params"].items():
            assert np.array_equal(v, one["rows"]["pending"][k])


@pytest.mark.parametrize("name", ["ckpt", "multi"])
def test_every_rank_keeps_the_store_accounting(runs, name):
    one, many, _, _ = runs[name]
    assert one["acct"]["rounds_participated"].sum() == 4 * (
        16 if name == "ckpt" else 32)
    for out in many:
        for a, v in one["acct"].items():
            np.testing.assert_array_equal(out["acct"][a], v, err_msg=a)
        assert out["swap_bytes"] == one["swap_bytes"]


def _contents(root):
    """Every file under ``root`` by relative path: a ``.npz``'s arrays
    (its zip entries carry their write time), any other file's sha256."""
    out = {}
    for p in sorted(Path(root).rglob("*")):
        if not p.is_file():
            continue
        key = p.relative_to(root).as_posix()
        if p.suffix == ".npz":
            with np.load(p) as data:
                out[key] = {k: data[k] for k in data.files}
        else:
            out[key] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


def test_rank_zero_writes_the_one_rank_checkpoints(runs):
    """Every checkpoint (all R rows, the meta with the cohort), every
    population manifest and every page file of the 1-rank run, equal."""
    _, _, d_one, d_ranks = runs["ckpt"]
    want, got = _contents(d_one), _contents(d_ranks)
    assert sorted(got) == sorted(want)
    names = sorted(want)
    assert [n for n in names if n.startswith("ckpt_")
            and n.endswith(".npz") and ".pop" not in n] == [
        f"ckpt_{r:06d}.npz" for r in range(4)]
    assert sum(n.endswith(".pop.npz") for n in names) == 4
    assert sum(n.startswith("pop_store/") for n in names) > 0
    for n, w in want.items():
        if isinstance(w, dict):
            assert sorted(got[n]) == sorted(w), n
            for k, a in w.items():
                assert got[n][k].dtype == a.dtype, (n, k)
                assert np.array_equal(got[n][k], a), (n, k)
        else:
            assert got[n] == w, n
    with np.load(Path(d_ranks) / "ckpt_000003.npz") as data:
        leaf = next(k for k in data.files if k.startswith("params/"))
        assert data[leaf].shape[0] == 16  # all R rows
