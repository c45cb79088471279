"""The port's BERT (``determined_clone_tpu_torch/models/bert.py``) held
against the JAX package's on the CPU at ``BertConfig.tiny()``: params
from the JAX ``init`` carried across with ``convert.params_from_numpy``,
the same tokens, segments and pad masks (rows half padding), fp32.

Tolerances: outputs and losses within rtol 1e-4, atol 1e-5; gradients
within rtol 1e-3 and an atol of 1e-6 of the leaf's largest value. Remat
must give the same loss and gradients as no remat, bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from determined_clone_tpu.models import bert as jbert
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.models import bert as tbert
from determined_clone_tpu_torch.training import optim

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
JCFG, TCFG = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
B, T = 4, 16


def flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat(v, f"{prefix}{k}/"))
    return out


def assert_out(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def assert_grads(tgrads, jgrads):
    t, j = flat(tgrads), flat(jgrads)
    assert set(t) == set(j)
    for path in j:
        want = np.asarray(j[path])
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(np.asarray(t[path]), want, rtol=1e-3,
                                   atol=1e-6 * scale, err_msg=path)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jax.jit(jbert.init, static_argnums=1)(
        jax.random.PRNGKey(0), JCFG))


@pytest.fixture(scope="module")
def batch():
    """Tokens, segments, a pad mask with rows 1 and 3 half padding, labels,
    MLM targets and an MLM mask."""
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, JCFG.vocab_size, size=(B, T)).astype(np.int32)
    segments = (np.arange(T)[None, :] >= rng.randint(4, 12, size=(B, 1))
                ).astype(np.int32)
    pad = np.ones((B, T), np.float32)
    pad[1, T // 2:] = 0.0
    pad[3, T // 2:] = 0.0
    return {"tokens": tokens, "segments": segments, "pad": pad,
            "labels": np.array([0, 1, 1, 0], np.int32),
            "targets": rng.randint(0, JCFG.vocab_size,
                                   size=(B, T)).astype(np.int32),
            "mlm_mask": (rng.uniform(size=(B, T)) < 0.3).astype(np.float32)}


def _t(a):
    return torch.tensor(np.asarray(a))


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def test_encode_matches_jax_with_padding_and_segments(params, batch):
    tp = convert.params_from_numpy(params, "cpu")
    b, tb = batch, _tb(batch)
    want = np.asarray(jbert.encode(params, JCFG, b["tokens"], b["segments"],
                                   b["pad"]))
    got = tbert.encode(tp, TCFG, tb["tokens"], tb["segments"], tb["pad"])
    assert_out(got, want)
    # padded positions are zeroed after the blocks
    assert float(got[1, T // 2:].abs().max()) == 0.0
    # defaults: no segments, no padding
    assert_out(tbert.encode(tp, TCFG, tb["tokens"]),
               jbert.encode(params, JCFG, b["tokens"]))


def test_padded_keys_do_not_reach_real_tokens(params, batch):
    """Changing the tokens under the padding leaves every real position's
    output as it was: padded keys are at NEG_INF."""
    tp = convert.params_from_numpy(params, "cpu")
    tb = _tb(batch)
    other = tb["tokens"].clone()
    other[1, T // 2:] = (other[1, T // 2:] + 7) % TCFG.vocab_size
    a = tbert.encode(tp, TCFG, tb["tokens"], tb["segments"], tb["pad"])
    b = tbert.encode(tp, TCFG, other, tb["segments"], tb["pad"])
    torch.testing.assert_close(a[1, :T // 2], b[1, :T // 2], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("head", ["classify", "mlm_logits"])
def test_heads_match_jax(params, batch, head):
    tp = convert.params_from_numpy(params, "cpu")
    b, tb = batch, _tb(batch)
    want = getattr(jbert, head)(params, JCFG, b["tokens"], b["segments"],
                                b["pad"])
    got = getattr(tbert, head)(tp, TCFG, tb["tokens"], tb["segments"],
                               tb["pad"])
    assert got.dtype == torch.float32
    assert_out(got, want)
    assert_out(tbert.pooled(tp, TCFG, tbert.encode(tp, TCFG, tb["tokens"])),
               jbert.pooled(params, JCFG, jbert.encode(params, JCFG,
                                                       b["tokens"])))


def _loss_args(b, loss):
    if loss == "classify_loss":
        return (b["tokens"], b["labels"], b["segments"], b["pad"])
    return (b["tokens"], b["targets"], b["mlm_mask"], b["segments"])


def _port_value_and_grad(params_np, cfg, loss, args):
    tp = convert.params_from_numpy(params_np, "cpu")
    leaves = optim.leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    value = getattr(tbert, loss)(tp, cfg, *args)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(value, leaves, allow_unused=True))]
    return value.detach(), optim.unflatten(tp, list(grads))


@pytest.mark.parametrize("loss", ["classify_loss", "mlm_loss"])
def test_losses_and_gradients_match_jax(params, batch, loss):
    jv, jg = jax.jit(jax.value_and_grad(
        lambda p, *a: getattr(jbert, loss)(p, JCFG, *a)))(
        params, *_loss_args(batch, loss))
    tv, tg = _port_value_and_grad(params, TCFG, loss,
                                  _loss_args(_tb(batch), loss))
    assert_out(tv, jv)
    assert_grads(optim.tree_map(lambda g: g.numpy(), tg), jax.device_get(jg))


@pytest.mark.parametrize("loss", ["classify_loss", "mlm_loss"])
def test_remat_equals_no_remat(params, batch, loss):
    args = _loss_args(_tb(batch), loss)
    v0, g0 = _port_value_and_grad(params, TCFG, loss, args)
    v1, g1 = _port_value_and_grad(
        params, dataclasses.replace(TCFG, remat=True), loss, args)
    assert torch.equal(v0, v1)
    for path, g in flat(g0).items():
        assert torch.equal(flat(g1)[path], g), path


def test_bf16_keeps_the_activations_in_bf16(params, batch):
    """bf16 compute: the blocks' output stays bf16 (the pad mask is cast,
    not promoted), and the logits land near the fp32 ones."""
    tp = convert.params_from_numpy(params, "cpu")
    tb = _tb(batch)
    cfg = dataclasses.replace(TCFG, compute_dtype=torch.bfloat16)
    seq = tbert.encode(tp, cfg, tb["tokens"], tb["segments"], tb["pad"])
    assert seq.dtype == torch.bfloat16
    lo = tbert.classify(tp, cfg, tb["tokens"], tb["segments"], tb["pad"])
    hi = tbert.classify(tp, TCFG, tb["tokens"], tb["segments"], tb["pad"])
    assert lo.dtype == torch.float32
    assert float((lo - hi).abs().max()) < 0.05 * max(
        float(hi.abs().max()), 1.0)


def test_param_count_and_tree_match_jax(params):
    tree = tbert.init(torch.Generator().manual_seed(0), TCFG, "cpu")
    assert {p: tuple(t.shape) for p, t in flat(tree).items()} == {
        p: np.shape(a) for p, a in flat(params).items()}
    assert tbert.param_count(tree) == jbert.param_count(params)
