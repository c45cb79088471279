"""The port's flash attention on the CPU: its plain version held against
the JAX package's ``flash_attention`` (Pallas in interpret mode off the
TPU, as tests/test_flash_attention.py runs it), the wrapper's contract,
and the device rule — a tensor that is not on the CPU never takes the
plain version. The CUDA kernel itself is held against the plain version
on the card by chip_smoke.py.

Tolerances are the reference's: 1e-4 in fp32, 0.05 in bf16. The models of
the kernel's roundings are held to chip_smoke.py's gates: 1e-4 in fp32,
and in bf16 two ulps per element (2**-6 * |ref| + 1e-4).
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from determined_clone_tpu.ops.attention import mha as jax_mha
from determined_clone_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from determined_clone_tpu_torch.models import gpt as tgpt
from determined_clone_tpu_torch.ops import _build
from determined_clone_tpu_torch.ops import flash_attention as fa
from determined_clone_tpu_torch.ops import flash_variants
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
    """Training takes the same route: a device input that requires grad
    launches the kernel through the autograd Function, and off the card
    the launcher raises rather than run the plain version."""
    with pytest.raises(ValueError, match="needs CUDA tensors"):
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


def _stub_launch(monkeypatch):
    """Replace the launcher; returns the list of (q shape, k shape, causal)
    it was called with."""
    calls = []

    def launch(q, k, v, causal):
        calls.append((tuple(q.shape), tuple(k.shape), causal))
        return torch.empty_like(q)

    monkeypatch.setattr(fa, "_launch", launch)
    return calls


def test_gpt_block_passes_unpadded_t_to_kernel(monkeypatch):
    """On a device tensor the block hands T=37 to the kernel as it is (the
    kernel masks ragged edges): no padding to the 16-token block, and the
    public function's divisibility check is not in the way."""
    calls = _stub_launch(monkeypatch)
    cfg = dataclasses.replace(tgpt.GPTConfig.tiny(), attention_impl="flash",
                              attention_block_size=16)
    params = tgpt.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    meta = {name: {leaf: (t.to("meta") if isinstance(t, torch.Tensor) else
                          {k: x.to("meta") for k, x in t.items()})
                   for leaf, t in sub.items()}
            for name, sub in params.items()}
    tokens = torch.zeros((2, 37), dtype=torch.long, device="meta")
    logits = tgpt.apply(meta, cfg, tokens)
    assert logits.shape == (2, 37, cfg.vocab_size)
    H, hd = cfg.n_heads, cfg.head_dim
    assert calls == [((2, 37, H, hd), (2, 37, H, hd), True)] * cfg.n_layers


def test_kernel_route_any_length_never_plain(monkeypatch):
    """``flash_attention_kernel`` takes any length and only the launcher;
    on CPU tensors the launcher raises rather than run the plain
    version."""
    calls = _stub_launch(monkeypatch)
    q = torch.empty((1, 37, 2, 16), device="meta")
    k = torch.empty((1, 45, 2, 16), device="meta")
    fa.flash_attention_kernel(q, k, k, causal=False)
    assert calls == [((1, 37, 2, 16), (1, 45, 2, 16), False)]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        fa.flash_attention_kernel(*(torch.zeros((1, 37, 2, 16))
                                    for _ in range(3)))


# --- the backward: FlashAttentionFunction ----------------------------------

def _jax_vjp(fn, inputs, g):
    out, pullback = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return [np.asarray(x) for x in (out, *pullback(jnp.asarray(g)))]


def _port_vjp(fn, inputs, g):
    """Autograd through ``fn`` on tensors made from ``inputs``; returns
    the output and the gradients of the inputs, as numpy."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [x.detach().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("causal", [True, False])
def test_function_grads_match_jax_flash(causal):
    """The CPU route (plain forward, blockwise recompute backward)
    against ``jax.vjp`` through the JAX flash attention."""
    q, k, v = _qkv(T=64)
    g = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=causal, block_q=32, block_k=32)
    js = _jax_vjp(lambda *a: jax_flash(*a, **kw), (q, k, v), g)
    ts = _port_vjp(lambda *a: fa.flash_attention(*a, **kw), (q, k, v), g)
    for j, t in zip(js, ts):
        np.testing.assert_allclose(j, t, atol=1e-4, rtol=0)


def _mha_launcher(monkeypatch):
    """The launcher replaced by plain attention on CPU tensors, so the
    kernel route's forward runs here and its backward can be checked."""
    calls = []

    def launch(q, k, v, causal):
        calls.append((tuple(q.shape), tuple(k.shape)))
        return mha(q, k, v, causal=causal)

    monkeypatch.setattr(fa, "_launch", launch)
    return calls


def test_kernel_route_ragged_t_grads_match_jax(monkeypatch):
    """T=37 reaches the kernel unpadded; the backward pads K/V to the
    16-key block. q, k, v are strided views of one fused projection, as
    the GPT block hands them over, and the gradient reaches the fused
    tensor. JAX pads q, k, v to 48 and slices back, as its GPT block
    does."""
    calls = _mha_launcher(monkeypatch)
    B, T, H, D = 1, 37, 2, 16
    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)

    def split(x):
        return [x[..., i * H * D:(i + 1) * H * D].reshape(B, T, H, D)
                for i in range(3)]

    def jfn(x):
        pad = ((0, 0), (0, 11), (0, 0), (0, 0))
        q, k, v = (jnp.pad(t, pad) for t in split(x))
        return jax_flash(q, k, v, causal=True, block_q=16,
                         block_k=16)[:, :T]

    js = _jax_vjp(jfn, (qkv,), g)
    ts = _port_vjp(lambda x: fa.flash_attention_kernel(
        *split(x), causal=True, block_k=16), (qkv,), g)
    assert calls == [((B, T, H, D), (B, T, H, D))]
    assert ts[1].shape == qkv.shape
    for j, t in zip(js, ts):
        np.testing.assert_allclose(j, t, atol=1e-4, rtol=0)


def test_kernel_route_noncausal_uneven_grads_match_mha(monkeypatch):
    """Non-causal, Tq=37 against Tk=45: zero keys would be attended, so
    the backward recomputes over one block of all the keys instead."""
    _mha_launcher(monkeypatch)
    q, k, v = _qkv(T=37, Tk=45)
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    js = _jax_vjp(lambda *a: jax_mha(*a, causal=False), (q, k, v), g)
    ts = _port_vjp(lambda *a: fa.flash_attention_kernel(
        *a, causal=False, block_k=16), (q, k, v), g)
    for j, t in zip(js, ts):
        np.testing.assert_allclose(j, t, atol=1e-4, rtol=0)


def test_backward_returns_input_dtype_and_launches_nothing(monkeypatch):
    calls = _mha_launcher(monkeypatch)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
               for a in _qkv(T=40))
    before = fa.flash_attention.launches
    out = fa.flash_attention_kernel(q, k, v, block_k=16)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert [t.dtype for t in grads] == [torch.bfloat16] * 3
    assert len(calls) == 1 and fa.flash_attention.launches == before


# --- launch-argument checks (pure: no card needed) -------------------------

def _fused_qkv(B=2, T=37, H=12, D=64, dtype=torch.bfloat16):
    """q, k, v as the GPT block hands them over: views of one fused
    [B, T, 3*H*D] projection output."""
    qkv = torch.zeros((B, T, 3 * H * D), dtype=dtype)
    return tuple(qkv[..., i * H * D:(i + 1) * H * D].reshape(B, T, H, D)
                 for i in range(3))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_kernel_args_accepts_fused_qkv_views(dtype):
    q, k, v = _fused_qkv(dtype=dtype)
    B, H, Tq, Tk, D, strides = fa.check_kernel_args(q, k, v)
    assert (B, H, Tq, Tk, D) == (2, 12, 37, 37, 64)
    row = 3 * 12 * 64  # elements per token of the fused output
    assert strides == (37 * row, row, 64) * 3
    item = q.element_size()
    assert (v.data_ptr() - q.data_ptr()) == 2 * 12 * 64 * item


def test_check_kernel_args_drops_unit_dim_strides():
    q = torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)
    *_, strides = fa.check_kernel_args(q, q, q)
    assert strides == (0, 16, 0) * 3


@pytest.mark.parametrize("case,match", [
    ("base", "data pointer is not 16-byte aligned"),
    ("t_stride", "T stride"),
    ("h_stride", "H stride"),
    ("head_dim", "head_dim 48"),
    ("dtype", "float32 or bfloat16"),
    ("mixed_dtype", "float32 or bfloat16"),
    ("last_stride", "must be contiguous"),
    ("shape", "shape mismatch"),
    ("rank", r"\[B, T, H, D\]"),
])
def test_check_kernel_args_rejects(case, match):
    bf = torch.bfloat16
    q = k = v = torch.zeros((2, 8, 2, 16), dtype=bf)
    if case == "base":
        q = torch.zeros(2 * 8 * 2 * 16 + 1, dtype=bf)[1:].view(2, 8, 2, 16)
    elif case == "t_stride":  # rows of 2*16 + 4 elements: 72 bytes
        k = torch.zeros((2, 8, 2 * 16 + 4), dtype=bf)[..., :32].view(
            2, 8, 2, 16)
    elif case == "h_stride":  # heads 20 elements apart: 40 bytes
        v = torch.zeros((2, 8, 2, 20), dtype=bf)[..., :16]
    elif case == "head_dim":
        q = k = v = torch.zeros((2, 8, 2, 48), dtype=bf)
    elif case == "dtype":
        q = k = v = torch.zeros((2, 8, 2, 16), dtype=torch.float16)
    elif case == "mixed_dtype":
        v = torch.zeros((2, 8, 2, 16))
    elif case == "last_stride":
        q = torch.zeros((2, 8, 16, 2), dtype=bf).transpose(2, 3)
    elif case == "shape":
        k = torch.zeros((2, 8, 3, 16), dtype=bf)
    elif case == "rank":
        q = torch.zeros((8, 2, 16), dtype=bf)
    with pytest.raises(ValueError, match=match):
        fa.check_kernel_args(q, k, v)


# --- the kernel's numerics, modelled on the CPU ----------------------------

BF16_REL, BF16_ABS = 2.0 ** -6, 1e-4  # chip_smoke.py's per-element gate


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _p_terms_split(p):
    hi = p.to(torch.bfloat16)
    return [hi.float(), (p - hi.float()).to(torch.bfloat16).float()]


def _kernel_model(q, k, v, *, p_terms, mm=torch.matmul):
    """The kernel's roundings in plain torch, causal: scores from the
    inputs as they are (bf16 products are exact in fp32), scaled in fp32;
    softmax in fp32 with l summed from the fp32 P; P.V as the sum of
    ``mm(term, v)`` over ``p_terms(P)``; the output in the input dtype."""
    B, T, H, D = q.shape
    qf, kf, vf = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    s = mm(qf, kf.transpose(-1, -2)) * (1.0 / D ** 0.5)
    keep = torch.ones(T, T, dtype=torch.bool).tril()
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = sum(mm(t, vf) for t in p_terms(p)) / p.sum(-1, keepdim=True)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _model_inputs(dtype, B=1, T=1024, H=2, D=64, seed=7):
    return tuple(torch.from_numpy(a).to(dtype)
                 for a in _qkv(B=B, T=T, H=H, D=D, seed=seed))


def _bf16_bound_used(out, ref):
    bound = BF16_REL * ref.float().abs() + BF16_ABS
    return ((out.float() - ref.float()).abs() / bound).max().item()


@pytest.fixture(scope="module")
def bf16_case():
    q, k, v = _model_inputs(torch.bfloat16)
    return (q, k, v), fa.flash_attention_reference(q, k, v, causal=True)


def test_split_p_model_meets_bf16_gate(bf16_case):
    """P = P_hi + P_lo, both bf16, in the P.V product: within the two-ulp
    gate, with room (0.49 of it at the GPT shape)."""
    (q, k, v), ref = bf16_case
    out = _kernel_model(q, k, v, p_terms=_p_terms_split)
    assert out.dtype == torch.bfloat16
    assert _bf16_bound_used(out, ref) <= 0.75


def test_bf16_p_model_misses_bf16_gate(bf16_case):
    """Why P is split: with P rounded to bf16 once, elements whose |ref|
    is small leave the two-ulp gate (12.9x of it at the GPT shape)."""
    (q, k, v), ref = bf16_case
    out = _kernel_model(q, k, v,
                        p_terms=lambda p: [p.to(torch.bfloat16).float()])
    assert _bf16_bound_used(out, ref) > 2.0


def test_3xtf32_model_meets_fp32_gate():
    q, k, v = _model_inputs(torch.float32)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    out = _kernel_model(q, k, v, p_terms=lambda p: [p], mm=_mm_3xtf32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=0)


def test_one_tf32_pass_misses_fp32_gate():
    """Why fp32 takes three TF32 products: one pass errs by ~1e-3."""
    q, k, v = _model_inputs(torch.float32)
    ref = fa.flash_attention_reference(q, k, v, causal=True)
    out = _kernel_model(q, k, v, p_terms=lambda p: [p], mm=_mm_tf32)
    assert (out - ref).abs().max().item() > 1e-4


def test_tf32_rounding_is_rna():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      1.0 + 3 * 2 ** -11])
    # ties (2**-11 is half a tf32 ulp at 1.0) round away from zero
    expect = torch.tensor([1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10),
                           1.0 + 2 ** -9])
    assert torch.equal(_tf32(x), expect)


@pytest.mark.parametrize("name", sorted(flash_variants.VARIANTS))
def test_kernel_variant_substitutions_apply(name):
    """The variants tool edits the kernel source by text; each edit must
    still find its line once, so an edit of the kernel cannot silently
    leave a variant equal to the kernel."""
    src = (_build.CSRC / "flash_attn_fwd.cu").read_text()
    out = flash_variants.variant_source(name)
    assert (out == src) == (name == "kernel")
