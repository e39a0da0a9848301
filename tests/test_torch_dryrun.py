"""The port's dry run (``launch/dryrun.py``, ``dist/step_analysis.py``,
``experiments/roofline.py``, ``experiments/wire_bytes_report.py``) and the
pieces it stands on, against the JAX package's, on the CPU.

- Bundles: every architecture's and vision config's shape cells, skips
  and topologies, and every architecture's parameter count at full size,
  equal the reference's.
- Abstract shapes: ``input_specs``, ``cache_specs``, ``abstract_state``
  and ``abstract_overlap_state`` on ``meta`` against ``jax.eval_shape``
  of the reference's, for every architecture at full size.
- ``make_serve_step`` / ``make_prefill_step`` at smoke size, f32, within
  the reference's f32 tolerance 2e-5.
- The roofline's analytic ``model_flops``, ``attn_flops_fwd`` and
  ``active_fraction_params`` equal the reference's bit for bit for every
  architecture x shape.
- ``analyze_step``'s counted FLOPs and dot bytes of a local step (loss
  and gradients) against ``analyze_hlo`` of the reference's compiled
  step.  Two faults of the reference's analyzer on this jax (0.9.0,
  ROADMAP.md section 3) are routed around: ``compiled.as_text()`` prints
  no operand shapes, so every dot's contracted length reads as 1 (the
  HLO is printed here with ``print_operand_shape``); a while loop's
  condition is a fused compare, so every loop counts one trip (the
  cases have one layer and one attention KV block).
- The gossip's wire bytes against the ``nbytes`` of the real payloads,
  and the static-k verdicts and the wire report's v2 bar on a smoke cell.
- The CLI: ``--mesh single`` exits naming ROADMAP.md item 5.
- The kernel bench (``experiments/kernels_bench.py``), ``--smoke
  --device cpu``: every row name of the reference's benchmark
  (benchmarks/kernels_bench.py) and a ``_plain`` twin for each kernel
  row.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax._src.lib import xla_client  # noqa: E402

from benchmarks import roofline as jroof  # noqa: E402
from repro.configs import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs import PAPER_IDS as J_PAPER_IDS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.core import round as jround  # noqa: E402
from repro.dist.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch.configs import (ARCH_IDS, PAPER_IDS, get_config,  # noqa
                                 get_vision_config, smoke_model)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.core.round import _per_layer  # noqa: E402
from repro_torch.dist import collectives as col  # noqa: E402
from repro_torch.dist import step_analysis as sa  # noqa: E402
from repro_torch.experiments import (common, kernels_bench,  # noqa: E402
                                     roofline, wire_bytes_report)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_round import FAST_COMPILE  # noqa: E402

F32_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_kernels.py:12
# the reference's four-operand within-chunk einsum (kernels/ref.py:252)
# contracts in another order than the port's two products: at the
# mamba2 case's shapes XLA's path adds two dots of 24,576 FLOPs (forward
# and backward), 0.17 % of the step
SSD_FLOPS_RTOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _leaves(tree):
    """{path: (shape, dtype name)} of a port tree (tensors only)."""
    if isinstance(tree, dict):
        tree = {k: v for k, v in tree.items() if isinstance(v, dict)
                or isinstance(v, torch.Tensor)}
    return {k: (tuple(v.shape), _dt(v)) for k, v in flatten(tree).items()}


def _jleaves(tree):
    """The same of a reference pytree of arrays / ShapeDtypeStructs."""
    return {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def j_param_count(arch):
    jcfg = j_get_config(arch).model
    shapes = jax.eval_shape(lambda: jreg.get_model(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_arch_ids_are_the_reference_s():
    assert ARCH_IDS == J_ARCH_IDS and PAPER_IDS == J_PAPER_IDS


def _topo(t):
    return (t.clusters, t.devices_per_cluster, t.inner_dp, t.backhaul)


@pytest.mark.parametrize("arch", ARCH_IDS + PAPER_IDS)
def test_bundle_cells_skips_and_topologies(arch):
    jb = j_get_config(arch)
    b = get_config(arch) if arch in ARCH_IDS else get_vision_config(arch)
    assert [dataclasses.astuple(s) for s in b.shapes] == [
        dataclasses.astuple(s) for s in jb.shapes]
    assert tuple(b.skip_shapes) == tuple(jb.skip_shapes)
    assert b.skip_reason == jb.skip_reason
    assert _topo(b.fl_single) == _topo(jb.fl_single)
    assert _topo(b.fl_multi) == _topo(jb.fl_multi)
    for f in dataclasses.fields(b.hcef):
        assert getattr(b.hcef, f.name) == getattr(jb.hcef, f.name), f.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_at_full_size(arch):
    cfg = get_config(arch).model
    params = registry.get_model(cfg).init(cfg, device="meta")
    assert sum(v.numel() for v in flatten(params).values()) == \
        j_param_count(arch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_shapes_at_full_size(arch):
    """Inputs and caches of every cell, the fl_single state and the
    overlapped state, shapes and types, against jax.eval_shape."""
    b, jb = get_config(arch), j_get_config(arch)
    cfg, jcfg = b.model, jb.model
    for shape, jshape in zip(b.shapes, jb.shapes):
        assert _leaves(registry.input_specs(cfg, shape)) == _jleaves(
            jreg.input_specs(jcfg, jshape)), shape.name
        if shape.kind != "train":
            cache = registry.cache_specs(cfg, shape)
            jcache = jreg.cache_specs(jcfg, jshape)
            assert cache["pos"] == 0 and jcache["pos"].shape == ()
            jcache = {k: v for k, v in jcache.items() if k != "pos"}
            assert _leaves(cache) == _jleaves(jcache), shape.name
    st = tround.abstract_overlap_state(cfg, b.hcef, b.fl_single)
    jst = jround.abstract_overlap_state(jcfg, jb.hcef, jb.fl_single)
    for f in ("params", "momentum", "ef"):
        got, want = getattr(st.fl, f), getattr(jst.fl, f)
        assert (got is None) == (want is None), f
        if got is not None:
            assert _leaves(got) == _jleaves(want), f
    assert _leaves(st.pending) == _jleaves(jst.pending)
    # abstract_state is the overlapped state's fl, built alone
    st0 = tround.abstract_state(cfg, b.hcef, b.fl_single)
    assert _leaves(st0.params) == _leaves(st.fl.params)
    assert all(v.device.type == "meta"
               for v in flatten(st0.params).values())


def _smoke(arch):
    jcfg = j_smoke(j_get_config(arch).model)
    cfg = smoke_model(get_config(arch).model)
    jm = jreg.get_model(jcfg)
    jparams = jm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, jm, jparams, cfg, params_from_jax(
        jax.tree.map(np.asarray, jparams), "cpu")


def _jit(fn):
    return lambda *a: jax.jit(fn).lower(*a).compile(
        compiler_options=FAST_COMPILE)(*a)


@pytest.mark.parametrize("arch", ["smollm_135m", "mamba2_1p3b"])
def test_prefill_and_serve_steps_match_reference(arch):
    jcfg, jm, jparams, cfg, params = _smoke(arch)
    B, S, T = 2, 12, 24
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jlog, jcache = _jit(jround.make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)}, jm.init_cache(jcfg, B, T))
    m = registry.get_model(cfg)
    log, cache = tround.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks)},
        m.init_cache(cfg, B, T, device="cpu"))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **F32_TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)[:, None]
    jlog, jcache = _jit(jround.make_serve_step(jcfg))(
        jparams, jcache, jnp.asarray(tok))
    log, cache = tround.make_serve_step(cfg)(params, cache,
                                             torch.from_numpy(tok))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **F32_TOL)
    assert cache["pos"] == int(jcache["pos"]) == S + 1
    for k, v in cache.items():
        if k != "pos":
            np.testing.assert_allclose(v.numpy(), np.asarray(jcache[k]),
                                       **F32_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_flops_bit_for_bit(arch):
    cfg, jcfg = get_config(arch).model, j_get_config(arch).model
    n = j_param_count(arch)
    assert roofline.active_fraction_params(cfg, n) == \
        jroof.active_fraction_params(jcfg, n)
    for s in get_config(arch).shapes:
        B, S = s.global_batch, s.seq_len
        assert roofline.attn_flops_fwd(cfg, B, S) == \
            jroof.attn_flops_fwd(jcfg, B, S)
        assert roofline.model_flops(cfg, s.kind, B, S, n) == \
            jroof.model_flops(jcfg, s.kind, B, S, n), s.name
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)


def _hlo_with_operand_shapes(compiled) -> str:
    opts = xla_client._xla.HloPrintOptions()
    opts.print_operand_shape = True
    return "\n".join(m.to_string(opts)
                     for m in compiled.runtime_executable().hlo_modules())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["smollm_135m", "mamba2_1p3b"])
def test_counted_flops_match_reference_hlo(arch, remat):
    """One layer, S 33 (one attention KV block, three SSD chunks of 16):
    the port's counted FLOPs and dot bytes of loss and gradients equal the
    reference's (dense), or within SSD_FLOPS_RTOL (mamba2).  With remat
    both sides recompute each layer's forward in the backward: that term
    is in both counts."""
    jcfg, jm, jparams, cfg, params = _smoke(arch)
    jcfg, cfg = (c.replace(num_layers=1, remat=remat) for c in (jcfg, cfg))
    jparams = jm.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32)
    compiled = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(jcfg, p, b))).lower(
        jparams, {"tokens": jnp.asarray(toks)}).compile(
        compiler_options=FAST_COMPILE)
    want = analyze_hlo(_hlo_with_operand_shapes(compiled))
    model = registry.get_model(cfg)

    def step(params, batch):
        leaves, rebuild = _per_layer(params)
        ps = [v.detach().requires_grad_() for v in leaves]
        with torch.enable_grad():
            return torch.autograd.grad(
                model.loss_fn(cfg, rebuild(ps), batch), ps)
    got = sa.analyze_step(step, params, {"tokens": torch.from_numpy(toks)})
    if cfg.family == "ssm":
        assert abs(got["flops"] - want["flops"]) <= \
            SSD_FLOPS_RTOL * want["flops"]
        assert want["flops"] - got["flops"] == 2 * 24576
    else:
        assert got["flops"] == want["flops"]
        assert got["dot_bytes"] == want["dot_bytes"]
    # the reference's analyzer on the default text: operand shapes absent
    raw = analyze_hlo(compiled.as_text())
    assert raw["flops"] < got["flops"] / 10


def test_step_counter_counts_mm_conv_and_their_backward():
    a = torch.randn(64, 32, requires_grad=True)
    b = torch.randn(32, 16)

    def mm(a, b):
        with torch.enable_grad():
            return torch.autograd.grad((a @ b).sum(), [a])
    got = sa.analyze_step(mm, a, b)
    assert got["flops"] == 2 * (2 * 64 * 32 * 16)
    x = torch.randn(2, 3, 8, 8, device="meta", requires_grad=True)
    w = torch.randn(4, 3, 3, 3, device="meta", requires_grad=True)

    def conv(x, w):
        with torch.enable_grad():
            y = torch.nn.functional.conv2d(x, w, padding=1)
            return torch.autograd.grad(y.sum(), [x, w])
    got = sa.analyze_step(conv, x, w)
    assert got["flops"] == 3 * (2 * 2 * 4 * 8 * 8 * 3 * 9)
    assert got["argument_bytes"] == (x.numel() + w.numel()) * 4
    assert got["output_bytes"] == got["argument_bytes"]  # the gradients


def test_peak_follows_live_storages():
    x = torch.empty(1000, device="meta")  # 4000 bytes

    def step(x):
        a = x * 2      # +4000
        b = a + 1      # +4000, peak 8000 over the arguments
        del a
        c = b[:10].clone()  # +40
        return c
    got = sa.analyze_step(step, x)
    assert got["argument_bytes"] == 4000
    assert got["peak_est_bytes"] == 4000 + 8000
    assert got["output_bytes"] == 40


@pytest.mark.parametrize("wire_dtype", col.WIRE_DTYPES)
def test_gossip_bytes_are_the_payloads_nbytes(wire_dtype):
    """round_gossip_bytes against every plan's real payload, at each level
    of the grid and at per-cluster levels, times H's bands."""
    C, Ls, wb = 4, (5000, 576, 64, 3000), 1024
    gen = torch.Generator().manual_seed(0)
    levels = (0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
    bands = sa.gossip_bands("ring", C)
    assert bands == 2
    for kw in [dict(theta=t) for t in levels] + [
            dict(cluster_theta=(0.05, 1.0, 0.2, 0.05))]:
        want = 0
        for L in Ls:
            layout, w = col._exchange_layout(
                L, torch.bfloat16, C, k=None, hkind="ring", p_edge=0.4,
                seed=0, wire_block=wb, wire_dtype=wire_dtype,
                **dict(dict(theta=None, cluster_theta=None), **kw))
            rows = torch.randn((C, L), generator=gen)
            for payload, _ in col._chunk_payloads(
                    rows, layout, wb=w, wire_dtype=wire_dtype,
                    dense_dtype=torch.bfloat16):
                want += sum(t.nbytes for t in payload if t is not None)
        got = sa.round_gossip_bytes(Ls, clusters=C, wire_dtype=wire_dtype,
                                    wire_block=wb, dense_itemsize=2, **kw)
        assert got == want * bands, kw
    dense = sa.round_gossip_bytes(Ls, clusters=C, sparse=False)
    assert dense == C * sum(Ls) * 2 * bands


TRAIN_S = ShapeConfig("train_s", "train", 32, 64)  # 16 devices x tau 4


@pytest.fixture()
def cells(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    return tmp_path


def test_smoke_cells_verdicts_report_and_roofline(cells, capsys):
    """The smoke smollm's train cell at every wire dtype (16 devices in 8
    clusters on the ring): the static-k verdict, the per-cluster one, the
    wire report's v2 bar and the roofline over the cells."""
    paths = []
    for wd in col.WIRE_DTYPES:
        res = dryrun.lower_cell("smollm_135m", shape=TRAIN_S, smoke=True,
                                wire_dtype=wd, verbose=False)
        assert res["status"] == "ok"
        assert res["gossip_bytes_scale_with_theta"]["ok"], wd
        assert res["hlo"]["coll_total"] == 0.0
        assert res["local_steps_counted"] == 64 and res["b_local"] == 1
        p = cells / f"smollm.{wd}.json"
        p.write_text(json.dumps(res))
        paths.append(str(p))
    spread = dryrun.lower_cell("smollm_135m", shape=TRAIN_S, smoke=True,
                               wire_dtype="int4", theta_spread="0.05,0.8",
                               verbose=False)
    v = spread["cluster_gossip_bytes"]
    assert v["ok"] and 0.0 < v["byte_win"] < 1.0
    report = wire_bytes_report.main(paths + ["--require", "int8/int4:2.0"])
    assert report["_requirements"][0]["ok"]
    rows = roofline.main(results=cells)
    out = capsys.readouterr().out
    assert out.count("arch,shape,mesh,compute_s") == 1
    assert "# worst roofline fraction" in out
    assert len(rows) == len(col.WIRE_DTYPES)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "long_500k"])
def test_serve_cells_and_skips(shape):
    res = dryrun.lower_cell("smollm_135m", shape, smoke=True,
                            verbose=False)
    if shape == "long_500k":
        assert res["status"] == "skipped"
        assert res["reason"] == j_get_config("smollm_135m").skip_reason
        return
    assert res["status"] == "ok" and res["hlo"]["flops"] > 0
    assert res["memory"]["argument_bytes"] >= res["cache_bytes"]


def test_run_cell_writes_the_cell_and_keeps_an_error(cells):
    res = dryrun.run_cell("smollm_135m", "long_500k")
    p = cells / "smollm_135m.long_500k.host.json"
    assert json.loads(p.read_text()) == res and res["status"] == "skipped"
    res = dryrun.run_cell("smollm_135m", "train_1m")  # no such cell
    assert res["status"] == "error" and "KeyError" in res["error"]
    assert dryrun.cell_path("a", "s", "int4", "0.05,0.8") == \
        cells / "a.s.host.int4.spread0.05_0.8.json"


def test_mesh_single_exits_naming_item_5(capsys):
    for mesh in ("single", "multi"):
        with pytest.raises(SystemExit) as e:
            dryrun.main(["--mesh", mesh, "--all"])
        assert e.value.code == 2
        assert "item 5" in capsys.readouterr().err


def reference_row_names():
    """benchmarks/kernels_bench.py's row names (its main and the two
    benches it calls)."""
    names = ["flash_attention_512", "ssd_chunked_1k", "topk_compress_8x1M",
             "rglru_assoc_2k"]
    for arch in ("femnist_cnn", "resnet20_cifar10"):
        for R in (16, 64, 128):
            names += [f"agg_{k}_R{R}_{arch}"
                      for k in ("dense", "structured", "fused")]
    for variant in ("dense", "sparse"):
        names += [f"round_{variant}_gossip_th{th}" for th in (0.1, 0.4, 1.0)]
    return names + ["round_sparse_pc_gossip_th0.1-1.0",
                    "round_overlap_stale1_gossip",
                    "round_overlap_model_smollm"]


KERNEL_ROWS = ("flash_attention_512", "ssd_chunked_1k", "topk_compress_8x1M")


def test_kernel_bench_smoke_prints_every_reference_row(capsys, monkeypatch,
                                                       tmp_path):
    monkeypatch.setattr(common, "RESULTS", tmp_path)
    rows = kernels_bench.main(["--smoke", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    printed = [ln.split(",")[0] for ln in lines[1:-1]]
    want = reference_row_names()
    twins = [n + "_plain" for n in want
             if n in KERNEL_ROWS or n.startswith("round_")
             and n != "round_overlap_model_smollm"]
    assert sorted(printed) == sorted(want + twins)
    assert [r[0] for r in rows] == printed
    for name, us, derived, out in rows:
        assert us > 0 and derived.split("|")[0] in ("plain", "model"), name
    # on the CPU a kernel row runs the plain version: its twin's bits
    by = {r[0]: r[3] for r in rows}
    for n in KERNEL_ROWS:
        a, b = by[n], by[n + "_plain"]
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y), n
    assert (tmp_path / "kernels.json").exists()
