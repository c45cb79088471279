"""The port's GPT held against the JAX package's on the CPU: the same
weights (JAX ``init``, converted leaf for leaf by
``convert.params_from_numpy``) and the same numpy tokens through both.

Tolerances: fp32 compute 1e-4 on logits (summation order only); bf16
compute 5e-2 on logits (bf16 activations through two blocks, rounded at
different places by the two frameworks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.core._serialization import save_pytree
from determined_clone_tpu.models import gpt as jgpt
from determined_clone_tpu.serving import kv_cache as jkv
from determined_clone_tpu_torch import convert
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.serving import kv_cache as tkv

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass

TINY = dict(vocab_size=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq_len=128, remat=False, attention_impl="mha")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _cfgs(dtype, **kw):
    jd, td, _ = DTYPES[dtype]
    return (jgpt.GPTConfig(**TINY, compute_dtype=jd, **kw),
            tgpt.GPTConfig(**TINY, compute_dtype=td, **kw))


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(jgpt.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                jgpt.GPTConfig(**TINY))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return convert.params_from_numpy(jax.device_get(jax_params), "cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], shape)


def test_converted_layout_is_leaf_for_leaf(jax_params, port_params):
    jleaves = jax.tree_util.tree_leaves_with_path(jax_params)
    tleaves = jax.tree_util.tree_leaves_with_path(port_params)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_port_init_has_the_jax_layout(jax_params):
    _, tcfg = _cfgs("float32")
    port = tgpt.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jax_params)
    tshapes = jax.tree.map(lambda a: tuple(a.shape), port)
    assert jshapes == tshapes
    assert tgpt.param_count(port) == jgpt.param_count(jax_params)


def test_params_from_checkpoint_shard_keys(tmp_path, jax_params,
                                           port_params):
    """A single-host checkpoint's flat npz keys load into the same dict."""
    save_pytree(str(tmp_path), jax_params)
    with np.load(tmp_path / "shard-0.npz") as z:
        loaded = convert.params_from_numpy(dict(z), "cpu")
    flat = jax.tree_util.tree_leaves_with_path(loaded)
    ref = jax.tree_util.tree_leaves_with_path(port_params)
    assert [p for p, _ in flat] == [p for p, _ in ref]
    for (_, a), (_, b) in zip(flat, ref):
        assert torch.equal(a, b)


def test_params_from_numpy_dtype_cast(jax_params):
    p = convert.params_from_numpy(jax.device_get(jax_params), "cpu",
                                  dtype=torch.bfloat16)
    assert p["blocks"]["attn_qkv"]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_matches_jax(dtype, jax_params, port_params):
    jcfg, tcfg = _cfgs(dtype)
    tokens = _tokens((2, 24))
    jl = jax.jit(jgpt.apply, static_argnums=1)(jax_params, jcfg,
                                              jnp.asarray(tokens))
    tl = tgpt.apply(port_params, tcfg, torch.from_numpy(tokens))
    assert tl.dtype == torch.float32 and tl.shape == (2, 24, 256)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(),
                               atol=DTYPES[dtype][2], rtol=0)


def test_flash_call_site_pads_indivisible_t(port_params):
    """T=37 with 16-token blocks: the block pads to 48, runs the flash
    path (its plain version on the CPU) and slices back — equal to mha."""
    _, tcfg = _cfgs("float32")
    flash_cfg = dataclasses.replace(tcfg, attention_impl="flash",
                                    attention_block_size=16)
    tokens = torch.from_numpy(_tokens((2, 37), seed=1))
    np.testing.assert_allclose(
        tgpt.apply(port_params, tcfg, tokens).numpy(),
        tgpt.apply(port_params, flash_cfg, tokens).numpy(),
        atol=1e-4, rtol=0)


def test_resolved_attention_impl():
    _, tcfg = _cfgs("float32")
    auto = dataclasses.replace(tcfg, attention_impl="auto")
    assert tgpt.resolved_attention_impl(auto, "cpu") == "mha"
    assert tgpt.resolved_attention_impl(auto, torch.device("cuda")) == "flash"
    assert tgpt.resolved_attention_impl(tcfg, "cuda") == "mha"
    with pytest.raises(ValueError):
        tgpt.resolved_attention_impl(
            dataclasses.replace(tcfg, attention_impl="ring"), "cpu")
    for cfg in (dataclasses.replace(tcfg, blockwise_attention=True),
                dataclasses.replace(tcfg, attention_impl="blockwise")):
        assert tgpt.resolved_attention_impl(cfg, "cuda") == "blockwise"
    # the MoE GPT is ported (tests/test_torch_moe.py holds it against JAX)
    moe = tgpt.GPTConfig(moe_experts=4)
    assert tgpt.resolved_attention_impl(moe, "cpu") == "mha"


def test_forward_paged_prefill_then_decode_matches_jax(jax_params,
                                                       port_params):
    """One bucket-padded prefill of two prompts (one padded row, one
    padded position), then one decode step: logits and both pools agree."""
    jcfg, tcfg = _cfgs("float32")
    cache = dict(num_blocks=12, block_size=8)
    jk, jv = jkv.init_kv_pools(jcfg, jkv.KVCacheConfig(**cache))
    tk, tv = tkv.init_kv_pools(tcfg, tkv.KVCacheConfig(**cache), "cpu")
    W = 4
    tables = np.array([[3, 7, 0, 0], [5, 1, 9, 0], [0, 0, 0, 0]], np.int32)
    lens = [11, 16]
    B, T = 3, 16
    tok = np.zeros((B, T), np.int32)
    pos = np.zeros((B, T), np.int32)
    msk = np.zeros((B, T), bool)
    last = np.zeros((B,), np.int32)
    rng = np.random.default_rng(2)
    for i, n in enumerate(lens):
        tok[i, :n] = rng.integers(0, TINY["vocab_size"], n)
        pos[i, :n] = np.arange(n)
        msk[i, :n] = True
        last[i] = n - 1
    assert tables.shape[1] == W

    jfwd = jax.jit(jgpt.forward_paged, static_argnums=1)

    def step(tok, pos, msk, last):
        nonlocal jk, jv
        jl, jk, jv = jfwd(
            jax_params, jcfg, *(jnp.asarray(a) for a in (tok, pos, msk, last)),
            jk, jv, jnp.asarray(tables))
        tl, tk2, tv2 = tgpt.forward_paged(
            port_params, tcfg, *(torch.from_numpy(a)
                                 for a in (tok, pos, msk, last)),
            tk, tv, torch.from_numpy(tables))
        assert tk2 is tk and tv2 is tv  # pools are updated in place
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(np.asarray(jk), tk.numpy(), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=1e-5,
                                   rtol=0)
        return tl

    first = step(tok, pos, msk, last).argmax(-1).numpy()
    tok1 = np.zeros((B, 1), np.int32)
    pos1 = np.zeros((B, 1), np.int32)
    msk1 = np.zeros((B, 1), bool)
    for i, n in enumerate(lens):
        tok1[i, 0], pos1[i, 0], msk1[i, 0] = first[i], n, True
    step(tok1, pos1, msk1, np.zeros((B,), np.int32))
    # block 0 backs only the padding row and unused table entries, which
    # are masked out of every write
    assert not tk[:, 0].any()


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                    jax_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("float32")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt.init(gen, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy(jax.device_get(jax_params))
    assert tgpt.init(gen, tcfg, device="cpu")["embed"]["table"].is_cpu
