"""The port's flash attention on the CPU: its plain version held against
the JAX package's ``flash_attention`` (Pallas in interpret mode off the
TPU, as tests/test_flash_attention.py runs it), the wrapper's contract,
and the device rule — a tensor that is not on the CPU never takes the
plain version. The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py.

Tolerances are the reference's: 1e-4 in fp32, 0.05 in bf16.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.ops.attention import mha as jax_mha
from determined_clone_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from determined_clone_tpu_torch.ops import _build
from determined_clone_tpu_torch.ops import flash_attention as fa
from determined_clone_tpu_torch.ops.attention import mha

torch.set_num_threads(1)
if torch.get_num_interop_threads() != 1:
    try:
        torch.set_num_interop_threads(1)
    except RuntimeError:  # already fixed once inter-op work has run here
        pass


def _qkv(B=1, T=64, H=2, D=16, Tk=None, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Tk or T, H, D)).astype(np.float32)
            for _ in range(2))
    return q, k, v


def _both(q, k, v, dtype="float32", **kw):
    jout = jax_flash(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)),
                     **kw)
    tout = fa.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                for a in (q, k, v)), **kw)
    return np.asarray(jout.astype(jnp.float32)), tout


@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_jax_flash(causal):
    j, t = _both(*_qkv(), causal=causal, block_q=32, block_k=32)
    assert t.dtype == torch.float32 and t.shape == (1, 64, 2, 16)
    np.testing.assert_allclose(j, t.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("bq,bk", [(16, 32), (32, 16)])
def test_uneven_q_k_blocks(bq, bk):
    j, t = _both(*_qkv(seed=1), causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(j, t.numpy(), atol=1e-4, rtol=0)


def test_uneven_q_and_k_lengths():
    """Tq != Tk: causal positions start at 0 on both sides, as in the
    TPU kernel."""
    j, t = _both(*_qkv(T=32, Tk=64, seed=2), causal=True, block_q=16,
                 block_k=32)
    np.testing.assert_allclose(j, t.numpy(), atol=1e-4, rtol=0)


def test_block_clamps_to_seq():
    q, k, v = _qkv(T=32, seed=3)
    j, t = _both(q, k, v)  # default blocks of 128 > 32
    np.testing.assert_allclose(j, t.numpy(), atol=1e-4, rtol=0)
    ref = mha(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(ref.numpy(), t.numpy(), atol=1e-4, rtol=0)


def test_indivisible_seq_rejected():
    q, k, v = _qkv(T=48)
    with pytest.raises(ValueError):
        jax_flash(*(jnp.asarray(a) for a in (q, k, v)), block_q=32,
                  block_k=32)
    with pytest.raises(ValueError):
        fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           block_q=32, block_k=32)


def test_bf16_inputs():
    q, k, v = _qkv(seed=4)
    j, t = _both(q, k, v, dtype="bfloat16", block_q=32, block_k=32)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(j, t.float().numpy(), atol=0.05, rtol=0)
    jm = jax_mha(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    np.testing.assert_allclose(np.asarray(jm.astype(jnp.float32)),
                               t.float().numpy(), atol=0.05, rtol=0)


def test_fully_masked_rows_stay_finite():
    """A causal query tile sees key tiles that are fully masked for
    some of its rows (block_k > block_q); the alpha guard keeps them 0."""
    q, k, v = _qkv(T=64, seed=5)
    t = fa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           block_q=8, block_k=64)
    ref = mha(*(torch.from_numpy(a) for a in (q, k, v)))
    assert bool(torch.isfinite(t).all())
    np.testing.assert_allclose(ref.numpy(), t.numpy(), atol=1e-4, rtol=0)


def _meta(requires_grad=False):
    """Tensors that are not on the CPU; the meta device lets the kernel
    path run up to the launch without a card."""
    return [torch.empty((1, 64, 2, 16), device="meta",
                        requires_grad=requires_grad) for _ in range(3)]


def test_non_cpu_tensor_never_takes_plain_version(monkeypatch):
    launched = []

    def plain(*a, **kw):
        raise AssertionError("plain version called for a device tensor")

    def launch(q, k, v, causal):
        launched.append(causal)
        return torch.empty_like(q)

    monkeypatch.setattr(fa, "flash_attention_reference", plain)
    monkeypatch.setattr(fa, "_launch", launch)
    out = fa.flash_attention(*_meta(), causal=False)
    assert launched == [False] and out.device.type == "meta"


def test_kernel_path_raises_off_cuda():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.flash_attention(*_meta())


def test_device_input_requiring_grad_raises():
    with pytest.raises(NotImplementedError, match="training slice"):
        fa.flash_attention(*_meta(requires_grad=True))


def test_mixed_devices_rejected():
    q, k, v = _meta()
    with pytest.raises(ValueError, match="different devices"):
        fa.flash_attention(torch.zeros(q.shape), k, v)


def test_plain_version_is_not_counted_and_builds_nothing():
    before = fa.flash_attention.launches
    fa.flash_attention(*(torch.from_numpy(a) for a in _qkv()))
    assert fa.flash_attention.launches == before
    assert "flash_attn_fwd" not in _build._libs


def test_c_entry_matches_ctypes_signature():
    """Nothing compiles CUDA here, so hold the kernel's C interface to
    the ctypes declaration by reading the source."""
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    functions = _build.KERNELS["flash_attn_fwd"][1]
    for fn, (_restype, argtypes) in functions.items():
        m = re.search(rf"^\S[^\n]*\b{fn}\(([^)]*)\)\s*{{", src, re.M)
        assert m, f"{fn} not defined at top level of the source"
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), fn
