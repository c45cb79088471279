"""The port's convolution, pooling and normalisation layers
(``determined_clone_tpu_torch/ops/layers.py``) held against the JAX
package's on the CPU, on the same numpy inputs.

Tolerances, fp32: outputs within rtol 1e-4, atol 1e-5; gradients (a
random cotangent through each side's autodiff) within rtol 1e-3 and an
atol of 1e-6 of the largest gradient value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from determined_clone_tpu.models import mnist_cnn as jmnist
from determined_clone_tpu.models import resnet as jresnet
from determined_clone_tpu.ops import layers as jl
from determined_clone_tpu_torch.ops import layers as tl

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.tensor(np.asarray(a))


def _assert_out(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _assert_grad(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-3,
                               atol=1e-6 * max(scale, 1e-30))


def _vjp_both(jfn, tfn, *arrays, seed=0):
    """Output and input gradients of ``jfn`` and ``tfn`` on the same
    arrays, under one random cotangent."""
    jarrays = [jnp.asarray(a) for a in arrays]
    jout = jax.jit(jfn)(*jarrays)
    ct = np.random.RandomState(seed).normal(size=jout.shape).astype(
        np.float32)
    jgrads = jax.jit(jax.grad(lambda *xs: jnp.sum(jfn(*xs) * ct),
                              argnums=tuple(range(len(arrays)))))(*jarrays)
    ts = [_t(a).requires_grad_(True) for a in arrays]
    tout = tfn(*ts)
    tgrads = torch.autograd.grad((tout * _t(ct)).sum(), ts)
    return (np.asarray(jout), [np.asarray(g) for g in jgrads],
            tout.detach().numpy(), [g.numpy() for g in tgrads])


# -- XLA's SAME padding ------------------------------------------------------

@pytest.mark.parametrize("n,k,s,want", [
    (224, 7, 2, (2, 3)),   # the ResNet stem
    (56, 3, 2, (0, 1)),    # a stride-2 bottleneck conv2 / the stem pool
    (112, 3, 2, (0, 1)),
    (7, 3, 2, (1, 1)),     # odd size: symmetric
    (28, 3, 1, (1, 1)),
    (8, 1, 2, (0, 0)),
    (5, 7, 1, (3, 3)),
])
def test_same_pads_are_xlas(n, k, s, want):
    assert tl.same_pads(n, k, s) == want


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("h", [7, 8, 28, 32])
def test_conv2d_matches_jax(padding, k, s, h):
    rng = np.random.RandomState(h * 100 + k * 10 + s)
    x = rng.normal(size=(2, h, h + 1, 3)).astype(np.float32)
    w = rng.normal(size=(k, k, 3, 4)).astype(np.float32)
    jout, jg, tout, tg = _vjp_both(
        lambda x, w: jl.conv2d({"kernel": w}, x, stride=s, padding=padding),
        lambda x, w: tl.conv2d({"kernel": w}, x, stride=s, padding=padding),
        x, w)
    assert tout.shape == jout.shape
    _assert_out(tout, jout)
    for a, b in zip(tg, jg):
        _assert_grad(a, b)


@pytest.mark.parametrize("k,h", [(3, 8), (3, 32), (7, 32), (7, 28)])
def test_symmetric_padding_fails_where_same_is_asymmetric(k, h):
    """A port that pads with torch's ``padding=k//2`` gives the JAX output
    shape at stride 2 on an even size, every window a pixel off: it
    disagrees with JAX, and the port's explicit pads do not."""
    rng = np.random.RandomState(k + h)
    x = rng.normal(size=(1, h, h, 2)).astype(np.float32)
    w = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
    want = np.asarray(jl.conv2d({"kernel": jnp.asarray(w)}, jnp.asarray(x),
                                stride=2, padding="SAME"))
    sym = F.conv2d(_t(x).permute(0, 3, 1, 2), _t(w).permute(3, 2, 0, 1),
                   stride=2, padding=k // 2).permute(0, 2, 3, 1).numpy()
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 100 * ATOL
    _assert_out(tl.conv2d({"kernel": _t(w)}, _t(x), stride=2), want)


def test_conv2d_bf16_compute_and_nhwc_layout():
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    w = rng.normal(size=(3, 3, 16, 8)).astype(np.float32) * 0.1
    y = tl.conv2d({"kernel": _t(w)}, _t(x), stride=2,
                  compute_dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.shape == (2, 4, 4, 8)
    assert y.is_contiguous()  # NHWC memory, as the next layer expects
    ref = tl.conv2d({"kernel": _t(w)}, _t(x), stride=2)
    assert (y.float() - ref).abs().max() < 0.05 * ref.abs().max()


# -- pools -------------------------------------------------------------------

@pytest.mark.parametrize("h", [8, 14, 28, 56])
def test_maxpool2_valid_matches_jax(h):
    x = np.random.RandomState(h).normal(size=(2, h, h, 5)).astype(np.float32)
    jout, jg, tout, tg = _vjp_both(jmnist._maxpool2, tl_maxpool2, x)
    _assert_out(tout, jout)
    _assert_grad(tg[0], jg[0])


def tl_maxpool2(x):
    return tl.max_pool(x, 2, 2, "VALID")


@pytest.mark.parametrize("h", [7, 8, 16, 56, 112])
def test_maxpool3_s2_same_matches_jax(h):
    """3×3/2 SAME pads (0, 1) with -inf on an even size: the port's pool
    keeps the JAX windows and never picks the padding."""
    x = np.random.RandomState(h).normal(size=(2, h, h, 4)).astype(np.float32)
    x -= 10.0  # all negative: a zero pad would win every edge window
    from determined_clone_tpu_torch.models import resnet as tresnet
    jout, jg, tout, tg = _vjp_both(jresnet._maxpool3_s2,
                                   tresnet._maxpool3_s2, x)
    assert tout.shape == jout.shape == (2, -(-h // 2), -(-h // 2), 4)
    _assert_out(tout, jout)
    _assert_grad(tg[0], jg[0])


def test_max_pool_rejects_unknown_padding():
    with pytest.raises(ValueError, match="SAME"):
        tl.max_pool(torch.zeros(1, 4, 4, 1), 2, 2, "FULL")


# -- normalisation -----------------------------------------------------------

@pytest.mark.parametrize("c,groups", [(64, 32), (48, 32), (24, 32),
                                      (16, 32), (96, 8)])
def test_groupnorm_matches_jax(c, groups):
    rng = np.random.RandomState(c + groups)
    x = (3.0 + 2.0 * rng.normal(size=(2, 5, 6, c))).astype(np.float32)
    scale = rng.normal(size=(c,)).astype(np.float32)
    bias = rng.normal(size=(c,)).astype(np.float32)
    jout, jg, tout, tg = _vjp_both(
        lambda x, s, b: jl.groupnorm({"scale": s, "bias": b}, x,
                                     groups=groups),
        lambda x, s, b: tl.groupnorm({"scale": s, "bias": b}, x,
                                     groups=groups),
        x, scale, bias)
    _assert_out(tout, jout)
    for a, b in zip(tg, jg):
        _assert_grad(a, b)


def test_groupnorm_group_count_and_dtype():
    """C=48 with 32 groups normalises 24 groups of 2 contiguous channels:
    each pair has mean 0 and variance 1 on its own."""
    x = torch.randn(1, 4, 4, 48, generator=torch.Generator().manual_seed(0))
    x = x * torch.arange(1, 49).float()  # a different scale per channel
    p = tl.groupnorm_init(48)
    y = tl.groupnorm(p, x).reshape(1, 16, 24, 2)
    torch.testing.assert_close(y.mean(dim=(1, 3)), torch.zeros(1, 24),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(y.square().mean(dim=(1, 3)),
                               torch.ones(1, 24), atol=1e-3, rtol=0)
    yb = tl.groupnorm(p, x.to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_jax(training):
    rng = np.random.RandomState(int(training))
    x = (1.5 + rng.normal(size=(4, 3, 3, 6))).astype(np.float32)
    params = {"scale": rng.normal(size=6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32),
              "mean": rng.normal(size=6).astype(np.float32),
              "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    jy, jstats = jl.batchnorm(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(x), training=training)
    ty, tstats = tl.batchnorm({k: _t(v) for k, v in params.items()}, _t(x),
                              training=training)
    _assert_out(ty, jy)
    assert set(tstats) == set(jstats)
    for k in jstats:
        _assert_out(tstats[k], jstats[k])
    if training:  # the running stats moved by 0.1 of the batch's
        batch_mean = x.reshape(-1, 6).mean(0)
        np.testing.assert_allclose(
            tstats["mean"].numpy(),
            0.9 * params["mean"] + 0.1 * batch_mean, rtol=1e-5, atol=1e-6)
        biased = x.reshape(-1, 6).var(0)  # numpy's var is the biased one
        np.testing.assert_allclose(
            tstats["var"].numpy(), 0.9 * params["var"] + 0.1 * biased,
            rtol=1e-4, atol=1e-6)
    else:
        assert tstats is not None and all(
            torch.equal(tstats[k], _t(params[k])) for k in params)
    # the gradient of the training form, through the batch statistics
    jout, jg, tout, tg = _vjp_both(
        lambda x: jl.batchnorm(jax.tree.map(jnp.asarray, params), x,
                               training=training)[0],
        lambda x: tl.batchnorm({k: _t(v) for k, v in params.items()}, x,
                               training=training)[0], x)
    _assert_grad(tg[0], jg[0])


# -- initialisers ------------------------------------------------------------

def test_he_normal_draws_match_jax_statistics():
    """JAX draws a normal truncated at ±2, scaled by sqrt(2 / fan_in):
    its std is 0.8796 of the scale. The port's draws have the JAX draws'
    std within 2% and none beyond twice the scale."""
    fan_in = 3 * 3 * 64
    scale = np.sqrt(2.0 / fan_in)
    shape = (100_000,)
    j = np.asarray(jl.he_normal(jax.random.PRNGKey(0), shape, fan_in=fan_in))
    t = tl.he_normal(torch.Generator().manual_seed(0), shape,
                     fan_in=fan_in).numpy()
    assert abs(t.std() / j.std() - 1) < 0.02
    assert abs(t.std() / scale - 0.8796) < 0.02 * 0.8796
    assert np.abs(t).max() <= 2 * scale * (1 + 1e-6)
    assert abs(t.mean()) < 0.01 * scale


def test_conv_init_is_hwio_with_fan_in_of_the_window():
    p = tl.conv_init(torch.Generator().manual_seed(0), 16, 32, 3)
    jp = jl.conv_init(jax.random.PRNGKey(0), 16, 32, 3)
    assert set(p) == set(jp) == {"kernel"}
    assert tuple(p["kernel"].shape) == jp["kernel"].shape == (3, 3, 16, 32)
    assert abs(float(p["kernel"].std()) / float(jp["kernel"].std()) - 1) < 0.1
