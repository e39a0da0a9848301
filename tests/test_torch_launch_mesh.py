"""The train launcher's ``--mesh single|multi`` across gloo ranks on the
CPU, and the training policy's checks.

The smoke smollm (f32), tau = q = 2, 2 rounds (an intra round, then a
gossip round on the int4 wire at per-cluster levels), 33-token
sequences: ``--mesh single`` (fl_single, 8 x 2, R 16) on 2 ranks, layout
B with 4 whole clusters a rank, and ``--mesh multi`` (fl_multi, 8 x 4, R
32) on 4 ranks of ("pod", "data") = (2, 2), multi-axis replica dims (the
psum fallback of ``mix_local``, the flat rotations of the wire at the
largest level), each against its 1-rank run in this process.  Every
rank's history is the whole round's, and the ranks' rows gathered in
order are the 1-rank state: bit for bit on ``single`` (the sums run in
the one-process order), within 1e-6 on ``multi`` (the psum adds the
clusters' rows in its own order).  Also ``make_train_policy``'s tiling
checks (tests/test_sharded_consistency.py:111) and its "model" axis, on
which a family other than the dense decoder raises naming ROADMAP.md
item 5 (``--overlap``, ``--population`` and ``--ckpt-dir`` on ranks:
tests/test_torch_launch_mesh_state.py; the model axis:
tests/test_torch_tensor_axis.py and tests/test_torch_round_tensor.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import FLTopology
from repro_torch.dist.mesh import RankMesh, run_world
from repro_torch.dist.policies import make_train_policy
from repro_torch.launch import train

ARGV = ["--device", "cpu", "--arch", "smollm_135m", "--rounds", "2",
        "--seq", "32", "--tau", "2", "--q", "2", "--sparse-gossip",
        "--wire-dtype", "int4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def launch(mesh, argv):
    """The launcher on this rank: its history, the policy's split, its
    state's rows and, on ranks, the whole state every rank gathered
    (``convert.gather_rows``), as numpy."""
    from repro_torch.convert import gather_rows
    from repro_torch.tree import flatten
    out = train.main(argv)
    st, pol = out["state"], out["policy"]
    as_np = lambda t: {k: v.numpy() for k, v in flatten(t).items()}
    fields = ("params", "momentum", "ef")
    res = {"history": out["history"],
           "split": (pol.replicas, pol.local_replicas, pol.first_replica,
                     pol.replica_axes),
           "state": {f: as_np(getattr(st, f)) for f in fields}}
    if mesh is not None:
        res["gathered"] = {f: as_np(gather_rows(getattr(st, f), pol.mesh,
                                                pol.replica_axes))
                           for f in fields}
    return res


@pytest.fixture(scope="module", params=[("single", 2), ("multi", 4)])
def runs(request, tmp_path_factory):
    mesh, n = request.param
    argv = ARGV + ["--mesh", mesh]
    one = launch(None, argv)
    many = run_world(launch, n, argv, device="cpu", timeout_s=240,
                     root=tmp_path_factory.mktemp("world"))
    return mesh, n, one, many


def test_every_rank_sees_the_whole_round(runs):
    mesh, n, one, many = runs
    R = 16 if mesh == "single" else 32
    assert one["split"][:3] == (R, R, 0)
    for rank, out in enumerate(many):
        assert out["split"][:3] == (R, R // n, rank * (R // n))
        assert out["split"][3] == (("data",) if mesh == "single"
                                   else ("pod", "data"))
        assert len(out["history"]) == 2
        for h, w in zip(out["history"], one["history"]):
            np.testing.assert_allclose(h["loss"], w["loss"], rtol=1e-6)
            assert h["rho_mean"] == w["rho_mean"]
            assert h["theta_mean"] == w["theta_mean"]
            assert h["time"] == w["time"] and h["energy"] == w["energy"]
            assert h["gossip"] == w["gossip"]
            assert len(h["rank_peak_gb"]) == n
        assert out["history"][1]["gossip"]
        assert sum(out["history"][1]["rank_messages"]) > 0


@pytest.mark.parametrize("field", ["params", "momentum", "ef"])
def test_ranks_rows_are_the_one_rank_state(runs, field):
    mesh, n, one, many = runs
    for k, w in one["state"][field].items():
        got = np.concatenate([out["state"][field][k] for out in many])
        if mesh == "single":
            np.testing.assert_array_equal(got, w, err_msg=k)
        else:
            np.testing.assert_allclose(got, w, rtol=0, atol=1e-6,
                                       err_msg=k)
        for out in many:  # every rank gathered the whole state
            np.testing.assert_array_equal(out["gathered"][field][k], got)


def test_train_policy_topology_tiling():
    """inner_dp > 1 topologies get a replicated replica dim; mis-sized
    ones fail at policy construction (reference :149, as
    tests/test_sharded_consistency.py:111 checks it)."""
    mesh = RankMesh((4, 1), ("data", "model"), world=4)  # no group needed
    topo = FLTopology(clusters=2, devices_per_cluster=1, inner_dp=2)
    p = make_train_policy(mesh, topo, dp_axes=("data",))
    assert p.replica_axes == () and p.ranks == 1 and p.local_replicas == 2
    with pytest.raises(ValueError, match="do not tile"):
        make_train_policy(mesh, FLTopology(clusters=3,
                                           devices_per_cluster=1),
                          dp_axes=("data",))
    p = make_train_policy(mesh, FLTopology(4, 2), dp_axes=("data",))
    assert (p.replica_axes, p.ranks, p.local_replicas) == (("data",), 4, 2)
    assert p.tensor_axes == ("model",)
    one = make_train_policy(FLTopology(2, 2))
    assert (one.mesh.shape, one.replica_axes, one.ranks) == ((1, 1),
                                                            ("data",), 1)


def test_model_axis_exits_naming_item_5():
    """A model axis builds a policy (the dense decoder, mamba2 and
    griffin run on it, tests/test_torch_tensor_axis.py and
    tests/test_torch_tensor_recurrent.py); a family that does not (MoE)
    raises naming item 5 when its round step is made."""
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.configs.base import HCEFConfig
    from repro_torch.core.round import make_round_step
    mesh = RankMesh((1, 2), ("data", "model"), world=2)  # no group needed
    p = make_train_policy(mesh, FLTopology(2, 2), dp_axes=("data",))
    assert (p.model, p.tensor_axes) == (2, ("model",))
    cfg = smoke_model(get_config("granite_moe_1b_a400m").model)
    with pytest.raises(NotImplementedError, match="item 5.3"):
        make_round_step(cfg, HCEFConfig(), FLTopology(2, 2), p)


def test_world_failure_raises(tmp_path):
    """A rank that raises fails the world (no hang)."""
    with pytest.raises(RuntimeError, match="exited with"):
        run_world(_fail_on_rank_1, 2, device="cpu", timeout_s=60,
                  root=tmp_path)


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    mesh.barrier()  # rank 0 waits for a peer that is gone
