"""The port's vision models and SGD against the JAX package's.

The reference's parameters (its own init, carried over bit for bit) and the
same numpy batch go through both: logits, loss and gradients of the MLP,
the FEMNIST CNN and ResNet-20 agree within the stated tolerances, the
"SAME" padding matches XLA's at odd and even sizes, and ``sgd_update``
matches the reference's.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.femnist_cnn import VISION as J_FEMNIST  # noqa: E402
from repro.configs.resnet20_cifar10 import VISION as J_RESNET  # noqa: E402
from repro.configs.resnet20_cifar10 import VisionConfig as JVC  # noqa: E402
from repro.models import vision as jvision  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.configs import get_vision_config  # noqa: E402
from repro_torch.configs.vision import VisionConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import vision  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402

J_MLP = JVC(name="mlp-cifar", kind="mlp", image_size=32, channels=3,
            num_classes=10)
MODELS = {
    "mlp": (J_MLP, VisionConfig(name="mlp-cifar", kind="mlp", image_size=32,
                                channels=3, num_classes=10)),
    "femnist_cnn": (J_FEMNIST, get_vision_config("femnist_cnn").vision),
    "resnet20": (J_RESNET, get_vision_config("resnet20_cifar10").vision),
}
# f32 on the CPU; XLA and ATen sum the convolutions and products in other
# orders.  Gradients are compared relative to each leaf's largest entry.
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL = 1e-4


def _both(name, batch=4, seed=0):
    jcfg, tcfg = MODELS[name]
    init, jloss, jacc, jfwd = jvision.make_vision_model(jcfg)
    jp = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    hw, ch = jcfg.image_size, jcfg.channels
    images = rng.normal(size=(batch, hw, hw, ch)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, batch).astype(np.int32)
    jb = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    tb = {"images": torch.from_numpy(images),
          "labels": torch.from_numpy(labels)}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (jp, jb, jloss, jfwd), (tp, tb, tcfg)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_loss_grad_match_reference(name):
    (jp, jb, jloss, jfwd), (tp, tb, tcfg) = _both(name)
    _, loss_fn, acc_fn, fwd = vision.make_vision_model(tcfg)
    np.testing.assert_allclose(fwd(tp, tb["images"]).numpy(),
                               np.asarray(jfwd(jp, jb["images"])),
                               **LOGIT_TOL)
    jl, jg = jax.value_and_grad(jloss)(jp, jb)
    tg, tl = torch.func.grad_and_value(loss_fn)(tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), **LOGIT_TOL)
    assert set(tg) == set(jg)
    for k in jg:
        want = np.asarray(jg[k])
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(tg[k].numpy(), want,
                                   atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_init_names_shapes_and_counts(name):
    jcfg, tcfg = MODELS[name]
    jp = jvision.make_vision_model(jcfg)[0](jax.random.PRNGKey(0))
    tp = vision.make_vision_model(tcfg)[0](torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert list(tp) == list(jp)  # the reference's leaf order
    want = {"mlp": 820874, "femnist_cnn": 6_603_710, "resnet20": 269_722}
    assert vision.param_count(tp) == want[name]
    # He init: std sqrt(2 / fan_in) on a large leaf
    w = tp["fc1_w" if name == "femnist_cnn" else
           "w0" if name == "mlp" else "s2b2_conv2"]
    fan_in = int(np.prod(w.shape[:-1]))
    assert abs(float(w.std()) / (2.0 / fan_in) ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("n", [7, 8, 15, 32])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_same_padding_matches_xla(n, k, stride):
    rng = np.random.default_rng(n * 10 + k + stride)
    x = rng.normal(size=(2, n, n, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = vision.conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(w), stride).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if n % 2 == 0 and stride == 2 and k == 3:
        assert vision.same_pads(n, k, stride) == (0, 1)  # not (1, 1)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_sgd_update_matches_reference(momentum):
    rng = np.random.default_rng(5)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jm, tm = jsgd.sgd_init(jp, momentum), sgd.sgd_init(tp, momentum)
    for step in range(3):
        scale = 0.0 if step == 1 else 1.0  # a masked step: zero gradient
        jg = {k: jnp.asarray(v * scale) for k, v in g.items()}
        tg = {k: torch.from_numpy(v * scale) for k, v in g.items()}
        jp, jm = jsgd.sgd_update(jp, jg, jm, lr=0.05, momentum=momentum)
        prev = tp
        tp, tm = sgd.sgd_update(tp, tg, tm, lr=0.05, momentum=momentum)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=1e-6)
            if momentum:
                np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                           atol=1e-7, rtol=1e-6)
        if step == 1:
            # the masked step still moves the params through the momentum
            assert momentum == 0.0 or not torch.equal(tp["a"], prev["a"])
