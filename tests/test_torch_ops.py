"""The PyTorch port's ops held against the JAX package's on the CPU, and
the port's import rule.

Inputs come from numpy with a fixed seed and go through both sides.
Tolerances: 1e-5 in fp32 (the two frameworks sum in different orders),
2e-2 in bf16 (one bf16 ulp at magnitude 2 is 1.6e-2; the frameworks
round intermediates at different places).
"""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.ops import attention as jattn
from determined_clone_tpu.ops import layers as jlayers
from determined_clone_tpu_torch.ops import attention as tattn
from determined_clone_tpu_torch.ops import layers as tlayers

# one intra-op thread per test worker: the suite runs six workers on a
# shared box, and torch's default (one thread per core) oversubscribes it
torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

REPO = Path(__file__).resolve().parent.parent
DTYPES = [("float32", 1e-5), ("bfloat16", 2e-2)]


def _pair(x, dtype):
    """One numpy array as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(j, t, atol):
    np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                               t.float().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_dense(dtype, atol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kernel = (0.2 * rng.standard_normal((16, 24))).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    jx, tx = _pair(x, "float32")
    cd = (getattr(jnp, dtype), getattr(torch, dtype))
    jy = jlayers.dense({"kernel": jnp.asarray(kernel),
                        "bias": jnp.asarray(bias)}, jx, compute_dtype=cd[0])
    ty = tlayers.dense({"kernel": torch.from_numpy(kernel),
                        "bias": torch.from_numpy(bias)}, tx,
                       compute_dtype=cd[1])
    assert ty.dtype == getattr(torch, dtype)
    _close(jy, ty, atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_layernorm(dtype, atol):
    rng = np.random.default_rng(1)
    x = (3.0 + 2.0 * rng.standard_normal((3, 7, 32))).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jy = jlayers.layernorm({"scale": jnp.asarray(scale),
                            "bias": jnp.asarray(bias)}, jx)
    ty = tlayers.layernorm({"scale": torch.from_numpy(scale),
                            "bias": torch.from_numpy(bias)}, tx)
    assert ty.dtype == tx.dtype
    _close(jy, ty, atol * 4)  # outputs reach |y| ~ 8


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_gelu(dtype, atol):
    x = np.random.default_rng(2).standard_normal((4, 64)).astype(np.float32)
    jx, tx = _pair(2 * x, dtype)
    _close(jlayers.gelu(jx), tlayers.gelu(tx), atol)


def test_embedding_gathers_then_casts():
    rng = np.random.default_rng(3)
    table = rng.standard_normal((11, 8)).astype(np.float32)
    ids = rng.integers(0, 11, (2, 5))
    jy = jlayers.embedding({"table": jnp.asarray(table)}, jnp.asarray(ids),
                           compute_dtype=jnp.bfloat16)
    ty = tlayers.embedding({"table": torch.from_numpy(table)},
                           torch.from_numpy(ids),
                           compute_dtype=torch.bfloat16)
    _close(jy, ty, 0.0)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("batched_positions", [False, True])
def test_rotary_embedding(dtype, atol, batched_positions):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 40, (2, 9)) if batched_positions
           else np.arange(9))
    jx, tx = _pair(x, dtype)
    jy = jattn.rotary_embedding(jx, jnp.asarray(pos))
    ty = tattn.rotary_embedding(tx, torch.from_numpy(pos))
    assert ty.dtype == tx.dtype
    _close(jy, ty, atol * 2)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_mha(dtype, atol, causal):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    _close(jattn.mha(jq, jk, jv, causal=causal),
           tattn.mha(tq, tk, tv, causal=causal), atol)


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_mha_explicit_mask(dtype, atol):
    """The paged path's form: non-causal over a longer context under a
    [B, 1, T, S] mask (rows of the padding token fully masked)."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 10, 4, 16)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((2, 1, 3, 10)) < 0.6
    mask[1, 0, 2] = False
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    _close(jattn.mha(jq, jk, jv, causal=False, mask=jnp.asarray(mask)),
           tattn.mha(tq, tk, tv, causal=False, mask=torch.from_numpy(mask)),
           atol)


def test_causal_mask_offsets():
    for args in [(4, 6), (5, 3, 2, 0), (3, 3, 0, 2)]:
        np.testing.assert_array_equal(np.asarray(jattn._causal_mask(*args)),
                                      tattn._causal_mask(*args).numpy())


def test_initializers_shapes_and_bounds():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.trunc_normal(gen, (64, 32), stddev=0.5)
    assert w.shape == (64, 32) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 1.0 + 1e-6  # truncated at two stddevs
    d = tlayers.dense_init(gen, 8, 4, dtype=torch.bfloat16)
    assert d["kernel"].dtype == torch.bfloat16 and d["bias"].shape == (4,)
    assert tlayers.embedding_init(gen, 10, 6)["table"].shape == (10, 6)
    ln = tlayers.layernorm_init(6)
    assert float(ln["scale"].sum()) == 6 and float(ln["bias"].sum()) == 0


def _vjp_pair(jfn, tfn, inputs, g, dtype):
    """Output and input gradients of ``jfn`` (via ``jax.vjp``) and of
    ``tfn`` (via autograd) on the same numpy inputs and cotangent."""
    jin = [jnp.asarray(a, getattr(jnp, dtype)) for a in inputs]
    jout, pullback = jax.vjp(jfn, *jin)
    jgrads = pullback(jnp.asarray(g, getattr(jnp, dtype)))
    tin = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
           for a in inputs]
    tout = tfn(*tin)
    tgrads = torch.autograd.grad(tout, tin,
                                 torch.from_numpy(g).to(tout.dtype))
    return (jout, *jgrads), (tout.detach(), *tgrads)


@pytest.mark.parametrize("dtype,atol", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_causal_blockwise_attention_and_vjp(dtype, atol, causal):
    """Output and dq, dk, dv against the JAX scan: 4 key blocks of 8."""
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal((2, 32, 3, 16)).astype(np.float32)
                  for _ in range(4))
    js, ts = _vjp_pair(
        lambda *a: jattn.causal_blockwise_attention(*a, block_size=8,
                                                    causal=causal),
        lambda *a: tattn.causal_blockwise_attention(*a, block_size=8,
                                                    causal=causal),
        (q, k, v), g, dtype)
    assert ts[0].dtype == getattr(torch, dtype)
    for j, t in zip(js, ts):
        assert t.dtype == getattr(torch, dtype)
        _close(j, t, atol * 2)  # gradients reach |g| ~ 2


def test_blockwise_matches_mha_and_rejects_ragged_blocks():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, 2, 8))
                                .astype(np.float32)) for _ in range(3))
    np.testing.assert_allclose(
        tattn.causal_blockwise_attention(q, k, v, block_size=8).numpy(),
        tattn.mha(q, k, v).numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="evenly divide"):
        tattn.causal_blockwise_attention(q, k, v, block_size=7)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy(smoothing, dtype):
    """Always fp32 inside: bf16 logits are widened exactly, so both
    dtypes hold to the fp32 bound."""
    rng = np.random.default_rng(9)
    logits = (4 * rng.standard_normal((3, 5, 40))).astype(np.float32)
    labels = rng.integers(0, 40, (3, 5))
    jl, tl = _pair(logits, dtype)
    j = jlayers.softmax_cross_entropy(jl, jnp.asarray(labels), smoothing)
    t = tlayers.softmax_cross_entropy(tl, torch.from_numpy(labels),
                                      smoothing)
    assert t.dtype == torch.float32 and t.shape == (3, 5)
    _close(j, t, 1e-5 * 4)  # losses reach ~10


def test_accuracy():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((4, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 7))
    labels[0] = logits[0].argmax(-1)  # some hits for certain
    j = jlayers.accuracy(jnp.asarray(logits), jnp.asarray(labels))
    t = tlayers.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert float(j) == float(t) >= 7 / 28


@pytest.mark.parametrize("dtype,atol", DTYPES)
def test_rmsnorm(dtype, atol):
    rng = np.random.default_rng(11)
    x = (1.0 + 2.0 * rng.standard_normal((3, 7, 32))).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    jx, tx = _pair(x, dtype)
    j = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    t = tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    assert t.dtype == tx.dtype
    _close(j, t, atol * 4)  # outputs reach |y| ~ 8
    init = tlayers.rmsnorm_init(32)
    assert init["scale"].shape == (32,) and float(init["scale"].sum()) == 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keep_rate_scaling_and_dtype(dtype):
    """Masks cannot match JAX's bit for bit; the statistics must: the
    keep rate within 5 sigma of 0.75 over 2**16 draws, kept values
    scaled by exactly 1/keep (4/3, rounded once in bf16), the dtype
    kept."""
    x = torch.full((256, 256), 1.5, dtype=dtype)
    y = tlayers.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert y.dtype == dtype and y.shape == x.shape
    kept = y != 0
    n = x.numel()
    sigma = (0.75 * 0.25 / n) ** 0.5
    assert abs(kept.float().mean().item() - 0.75) < 5 * sigma
    assert torch.equal(y[kept], (x / 0.75)[kept])


def test_dropout_same_seed_same_mask():
    x = torch.ones((64, 64))
    a, b, c = (tlayers.dropout(x, 0.5, torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tlayers.dropout(x, 0.5, None) is x  # not training
    assert tlayers.dropout(x, 0.0, torch.Generator()) is x
    seeds = {tlayers.fold_seed(3, i) for i in range(100)}
    assert len(seeds) == 100 and tlayers.fold_seed(3, 0) == tlayers.fold_seed(
        3, 0)
    assert all(0 <= s < 2 ** 63 for s in seeds)


FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "determined_clone_tpu")


def _port_sources():
    yield from sorted((REPO / "determined_clone_tpu_torch").rglob("*.py"))
    yield REPO / "chip_smoke.py"


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in FORBIDDEN, (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}")
