"""The port's vision families — ``models/mlp.py``, ``mnist_cnn.py``,
``resnet.py``, ``vit.py`` and the hub's detector — held against the JAX
package's on the CPU: parameters from the JAX ``init`` carried across
with ``convert.params_from_numpy``, the same numpy inputs, fp32 compute.

Tolerances: logits and losses within rtol 1e-4, atol 1e-5; gradients
(``jax.grad`` against ``torch.autograd.grad``, leaf by leaf by tree path)
within rtol 1e-3 and an atol of 1e-6 of the leaf's largest value — for
ResNet-26, 1e-4 of it: 16 GroupNorm backwards in fp32 leave the two
packages up to 2.8e-5 of a leaf's largest gradient apart, and the JAX
package's own fp32 gradients 4.8e-5 from its float64 ones. The
full-width trees (ResNet-50, ViT-S/16, BERT-base) are compared by path
and shape without allocating: ``jax.eval_shape`` on the JAX side, the
port's ``init`` on the meta device with its draws stubbed on the other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu import model_hub as jhub
from determined_clone_tpu.models import bert as jbert
from determined_clone_tpu.models import mlp as jmlp
from determined_clone_tpu.models import mnist_cnn as jmnist
from determined_clone_tpu.models import resnet as jresnet
from determined_clone_tpu.models import vit as jvit
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch import model_hub as thub
from determined_clone_tpu_torch.models import bert as tbert
from determined_clone_tpu_torch.models import mlp as tmlp
from determined_clone_tpu_torch.models import mnist_cnn as tmnist
from determined_clone_tpu_torch.models import resnet as tresnet
from determined_clone_tpu_torch.models import vit as tvit
from determined_clone_tpu_torch.ops import layers as tl
from determined_clone_tpu_torch.training import optim

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def flat(tree, prefix=""):
    """{tree path: leaf} over dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def assert_out(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def assert_grads(tgrads, jgrads, atol_of_max=1e-6):
    t, j = flat(tgrads), flat(jgrads)
    assert set(t) == set(j)
    for path in j:
        want = np.asarray(j[path])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(t[path]), want, rtol=1e-3,
                                   atol=atol_of_max * scale, err_msg=path)


def jax_params(init, cfg, seed=0):
    return jax.device_get(jax.jit(init, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))


def port_value_and_grad(loss, params_np, *args):
    """(loss, grads as numpy trees) of ``loss(params, *args)`` in the port
    on params converted from numpy."""
    params = convert.params_from_numpy(params_np, "cpu")
    leaves = optim.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    value = loss(params, *args)
    grads = torch.autograd.grad(value, leaves)
    grads = optim.unflatten(params, [g.numpy() for g in grads])
    return value.item(), grads


def jax_value_and_grad(loss, params_np, *args):
    value, grads = jax.jit(jax.value_and_grad(loss))(params_np, *args)
    return float(value), jax.device_get(grads)


def _t(a):
    return torch.tensor(np.asarray(a))


# -- MLP -----------------------------------------------------------------------

def test_mlp_matches_jax():
    jcfg = jmlp.MLPConfig()
    tcfg = tmlp.MLPConfig()
    params = jax_params(jmlp.init, jcfg)
    rng = np.random.RandomState(0)
    x = rng.normal(size=(8, 28, 28, 1)).astype(np.float32)
    y = rng.randint(0, 10, size=8).astype(np.int32)
    tp = convert.params_from_numpy(params, "cpu")
    assert_out(tmlp.apply(tp, tcfg, _t(x)).detach(),
               jmlp.apply(params, jcfg, x))
    jv, jg = jax_value_and_grad(lambda p: jmlp.loss_fn(p, jcfg, x, y), params)
    tv, tg = port_value_and_grad(
        lambda p: tmlp.loss_fn(p, tcfg, _t(x), _t(y)), params)
    assert abs(tv - jv) <= ATOL + RTOL * abs(jv)
    assert_grads(tg, jg)
    assert set(flat(tmlp.init(torch.Generator().manual_seed(0), tcfg,
                              "cpu"))) == set(flat(params))


# -- mnist CNN -----------------------------------------------------------------

def _mnist_batch(b=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, size=(b, 28, 28, 1)).astype(np.float32)
    return x, rng.randint(0, 10, size=b).astype(np.int32)


def test_mnist_cnn_matches_jax_at_default_widths():
    jcfg, tcfg = jmnist.MnistCNNConfig(), tmnist.MnistCNNConfig()
    params = jax_params(jmnist.init, jcfg)
    x, y = _mnist_batch()
    tp = convert.params_from_numpy(params, "cpu")
    assert_out(tmnist.apply(tp, tcfg, _t(x)).detach(),
               jmnist.apply(params, jcfg, x))
    # a flat [B, 784] batch is accepted as the JAX model accepts it
    assert_out(tmnist.apply(tp, tcfg, _t(x.reshape(4, -1))).detach(),
               jmnist.apply(params, jcfg, x))
    jv, jg = jax_value_and_grad(
        lambda p: jmnist.loss_fn(p, jcfg, x, y), params)
    tv, tg = port_value_and_grad(
        lambda p: tmnist.loss_fn(p, tcfg, _t(x), _t(y)), params)
    assert abs(tv - jv) <= ATOL + RTOL * abs(jv)
    assert_grads(tg, jg)


def test_mnist_cnn_flattens_nhwc_as_jax():
    """fc1's rows are in (H, W, C) order: feeding it an NCHW flatten (the
    torch habit) disagrees with the JAX logits; the port's flatten does
    not."""
    jcfg, tcfg = jmnist.MnistCNNConfig(), tmnist.MnistCNNConfig()
    params = jax_params(jmnist.init, jcfg)
    x, _ = _mnist_batch()
    tp = convert.params_from_numpy(params, "cpu")
    want = np.asarray(jmnist.apply(params, jcfg, x))
    h = torch.relu(tl.conv2d(tp["conv1"], _t(x)))
    h = tmnist._maxpool2(h)
    h = tmnist._maxpool2(torch.relu(tl.conv2d(tp["conv2"], h)))
    nchw = h.permute(0, 3, 1, 2).reshape(4, -1)
    wrong = tl.dense(tp["fc2"], torch.relu(tl.dense(tp["fc1"], nchw)))
    assert np.abs(wrong.detach().numpy() - want).max() > 100 * ATOL
    nhwc = h.reshape(4, -1)
    right = tl.dense(tp["fc2"], torch.relu(tl.dense(tp["fc1"], nhwc)))
    assert_out(right.detach(), want)


def test_mnist_cnn_dropout_streams():
    """Dropout only when training with a seed: one seed always draws the
    same masks, another seed others; rates 0 give the eval logits."""
    cfg = tmnist.MnistCNNConfig()
    params = tmnist.init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = _t(_mnist_batch()[0])
    ev = tmnist.apply(params, cfg, x)
    a = tmnist.apply(params, cfg, x, training=True, dropout_seed=3)
    b = tmnist.apply(params, cfg, x, training=True, dropout_seed=3)
    c = tmnist.apply(params, cfg, x, training=True, dropout_seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ev)
    assert torch.equal(tmnist.apply(params, cfg, x, dropout_seed=3), ev)
    off = dataclasses.replace(cfg, dropout_1=0.0, dropout_2=0.0)
    assert torch.equal(tmnist.apply(params, off, x, training=True,
                                    dropout_seed=3), ev)


# -- ResNet --------------------------------------------------------------------

def test_resnet_tiny_matches_jax():
    """ResNet-26 at width 16 on 32×32: the stem's 7×7/2 SAME pads (2, 3),
    the stem pool and every stage-entry conv2 pad (0, 1)."""
    jcfg, tcfg = jresnet.ResNetConfig.tiny(), tresnet.ResNetConfig.tiny()
    params = jax_params(jresnet.init, jcfg)
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    tp = convert.params_from_numpy(params, "cpu")
    assert_out(tresnet.apply(tp, tcfg, _t(x)).detach(),
               jresnet.apply(params, jcfg, x))
    jv, jg = jax_value_and_grad(
        lambda p: jresnet.loss_fn(p, jcfg, x, y), params)
    tv, tg = port_value_and_grad(
        lambda p: tresnet.loss_fn(p, tcfg, _t(x), _t(y)), params)
    assert abs(tv - jv) <= ATOL + RTOL * abs(jv)
    assert_grads(tg, jg, atol_of_max=1e-4)
    assert tresnet.param_count(tp) == jresnet.param_count(params)


def test_resnet_depths_and_config_errors():
    assert tresnet.DEPTHS == jresnet.DEPTHS
    with pytest.raises(ValueError, match="unsupported resnet depth"):
        tresnet.ResNetConfig(depth=34).stage_blocks


# -- ViT -----------------------------------------------------------------------

def _images(b, size, seed=0):
    return np.random.RandomState(seed).normal(
        size=(b, size, size, 3)).astype(np.float32)


def test_vit_patchify_order_matches_jax():
    cfg = tvit.ViTConfig.tiny()
    x = _images(2, 32)
    assert_out(tvit.patchify(cfg, _t(x)),
               jvit.patchify(jvit.ViTConfig.tiny(), jnp.asarray(x)))


def test_vit_tiny_matches_jax():
    jcfg, tcfg = jvit.ViTConfig.tiny(), tvit.ViTConfig.tiny()
    params = jax_params(jvit.init, jcfg)
    x = _images(3, 32, seed=2)
    y = np.array([1, 5, 9], np.int32)
    tp = convert.params_from_numpy(params, "cpu")
    assert_out(tvit.encode(tp, tcfg, _t(x)).detach(),
               jvit.encode(params, jcfg, x))
    assert_out(tvit.apply(tp, tcfg, _t(x)).detach(),
               jvit.apply(params, jcfg, x))
    jv, jg = jax_value_and_grad(lambda p: jvit.loss_fn(p, jcfg, x, y), params)
    tv, tg = port_value_and_grad(
        lambda p: tvit.loss_fn(p, tcfg, _t(x), _t(y)), params)
    assert abs(tv - jv) <= ATOL + RTOL * abs(jv)
    assert_grads(tg, jg)
    # remat recomputes each block in the backward: the same gradients
    rv, rg = port_value_and_grad(
        lambda p: tvit.loss_fn(p, dataclasses.replace(tcfg, remat=True),
                               _t(x), _t(y)), params)
    assert rv == tv
    for path, g in flat(tg).items():
        np.testing.assert_array_equal(flat(rg)[path], g, err_msg=path)
    assert tvit.param_count(tp) == jvit.param_count(params)


def test_vit_bf16_keeps_an_fp32_residual():
    cfg = dataclasses.replace(tvit.ViTConfig.tiny(),
                              compute_dtype=torch.bfloat16)
    params = tvit.init(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = tvit.encode(params, cfg, _t(_images(2, 32)))
    assert tokens.dtype == torch.float32 and tokens.shape == (2, 17, 64)


# -- the hub's detector --------------------------------------------------------

def _detection_batch(cfg, b=3):
    return next(iter(jhub.synthetic_detection_batches(
        cfg, batch_size=b, n_batches=1, seed=5)))


def test_detector_matches_jax():
    jcfg, tcfg = jhub.DetectorConfig(), thub.DetectorConfig()
    params = jax_params(jhub.detector_init, jcfg)
    batch = _detection_batch(jcfg)
    tbatch = {k: _t(v) for k, v in batch.items()}
    tp = convert.params_from_numpy(params, "cpu")
    assert isinstance(tp["backbone"], list) and len(tp["backbone"]) == 3
    jpred = jhub.detector_apply(params, jcfg, batch["image"])
    tpred = thub.detector_apply(tp, tcfg, tbatch["image"])
    assert set(tpred) == set(jpred)
    for k in jpred:
        assert_out(tpred[k].detach(), jpred[k])
    args = ("image", "boxes", "labels", "mask")
    jtotal, jparts = jhub.detection_loss(params, jcfg,
                                         *[batch[a] for a in args])
    ttotal, tparts = thub.detection_loss(tp, tcfg, *[tbatch[a] for a in args])
    assert_out(ttotal.detach(), jtotal)
    for k in jparts:
        assert_out(tparts[k].detach(), jparts[k])
    jv, jg = jax_value_and_grad(
        lambda p: jhub.detection_loss(p, jcfg, *[batch[a] for a in args])[0],
        params)
    tv, tg = port_value_and_grad(
        lambda p: thub.detection_loss(p, tcfg, *[tbatch[a] for a in args])[0],
        params)
    assert_grads(tg, jg)


def test_synthetic_detection_batches_match_jax():
    cfg = thub.DetectorConfig()
    for jb, tb in zip(jhub.synthetic_detection_batches(
            jhub.DetectorConfig(), batch_size=4, n_batches=2, seed=1),
            thub.synthetic_detection_batches(cfg, batch_size=4, n_batches=2,
                                             seed=1)):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
            assert tb[k].dtype == jb[k].dtype


# -- convert walks lists --------------------------------------------------------

def test_convert_walks_the_detectors_list():
    params = jax_params(jhub.detector_init, jhub.DetectorConfig())
    nested = convert.params_from_numpy(params, "cpu")
    flat_keys = {".".join(p.split("/")): v for p, v in flat(params).items()}
    assert "backbone.0.kernel" in flat_keys
    from_flat = convert.params_from_numpy(flat_keys, "cpu")
    for tree in (nested, from_flat):
        assert isinstance(tree["backbone"], list)
        assert set(flat(tree)) == set(flat(params))
        for path, leaf in flat(tree).items():
            np.testing.assert_array_equal(leaf.numpy(), flat(params)[path])
    as_tuple = convert.params_from_numpy(
        {"xs": (np.zeros(2, np.float32), np.ones(3, np.float32))}, "cpu")
    assert isinstance(as_tuple["xs"], tuple)
    assert [t.shape[0] for t in as_tuple["xs"]] == [2, 3]


# -- full-width trees, by path and shape --------------------------------------

def _meta_draws(monkeypatch):
    """The port's initialisers give meta tensors: no memory, no draw."""
    def trunc_normal(gen, shape, stddev=0.02, dtype=torch.float32,
                     device=None):
        return torch.empty(shape, dtype=dtype, device="meta")

    monkeypatch.setattr(tl, "trunc_normal", trunc_normal)
    monkeypatch.setattr(tbert, "trunc_normal", trunc_normal)


@pytest.mark.parametrize("family", ["resnet50", "vit_s16", "bert_base"])
def test_full_width_trees_match_jax(monkeypatch, family):
    jinit, jcfg, tinit, tcfg = {
        "resnet50": (jresnet.init, jresnet.ResNetConfig(),
                     tresnet.init, tresnet.ResNetConfig()),
        "vit_s16": (jvit.init, jvit.ViTConfig(), tvit.init, tvit.ViTConfig()),
        "bert_base": (jbert.init, jbert.BertConfig(), tbert.init,
                      tbert.BertConfig()),
    }[family]
    shapes = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    _meta_draws(monkeypatch)
    tree = tinit(torch.Generator(), tcfg, device="meta")
    want = {p: tuple(s.shape) for p, s in flat(shapes).items()}
    got = {p: tuple(t.shape) for p, t in flat(tree).items()}
    assert got == want
    assert all(t.dtype == torch.float32 for t in flat(tree).values())
    n = sum(int(np.prod(s)) for s in want.values())
    expected = {"resnet50": 25_557_032, "vit_s16": 22_009_192,
                "bert_base": 109_514_300}[family]
    assert n == expected
