"""The PyTorch port's ops held against the JAX package's on the CPU, and
the port's import rule.

Inputs come from numpy with a fixed seed and go through both sides.
Tolerances: 1e-5 in fp32 (the two frameworks sum in different orders),
2e-2 in bf16 (one bf16 ulp at magnitude 2 is 1.6e-2; the frameworks
round intermediates at different places).
"""
import ast
from pathlib import Path

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
