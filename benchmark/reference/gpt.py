"""The plain reference of the benchmark's GPT: float32 PyTorch with TF32
off, written for the benchmark from the architecture's equations, with no
kernel, cache or batching of the program's.

The block: pre-LN (eps from the configuration), a fused q|k|v projection
with bias, rotary positions on the whole head (half-split, base 10000),
causal softmax attention, an output projection with bias, a GELU (tanh
form) MLP with biases, residual adds; a final LN and logits against the
tied embedding table; the loss is the mean next-token cross-entropy.

Training (``train_readings``) follows a number of AdamW steps (clip by
global norm, bias-corrected moments, eps outside the root, decoupled
weight decay on every leaf) from the seed's weights over the given
batches, in blocks of rows (gradients accumulate over the blocks) with
each block's activations recomputed in the backward, so the whole model
fits beside its optimizer state. Serving (``served_gaps``) scores given
token sequences position by position.

``precision="fp8"`` is the control: the program's precision map one step
lower. Every tensor the program holds in its bf16 compute dtype (the
embedded rows, the residual stream after each add, the LN outputs, the
products' operands and results, q and k after rotary, the attention
probabilities and output, the GELU output, the final LN output) is
rounded to float8 e4m3 (one scale per tensor); what the program keeps in
fp32 (parameters, softmax and LN statistics, the logits and the loss)
stays fp32. Gradients pass the roundings straight through.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark import weights

FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


class Ref:
    def __init__(self, cfg: dict, precision: str = "fp32") -> None:
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.r = _fp8 if precision == "fp8" else (lambda t: t)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A product in the compute dtype: operands and result rounded."""
        return self.r(self.r(a) @ self.r(b))

    def layernorm(self, x, scale, bias):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        eps = self.cfg.get("layer_norm_epsilon", 1e-5)
        return (x - mu) * torch.rsqrt(var + eps) * scale + bias

    def rotary(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        half = x.shape[-1] // 2
        freqs = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
        ang = pos[:, None].float() * freqs          # [T, half]
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    def block(self, x, ln1s, ln1b, wqkv, bqkv, wo, bo, ln2s, ln2b, wup,
              bup, wdn, bdn):
        R, T, D = x.shape
        H = self.cfg["n_heads"]
        hd = D // H
        pos = torch.arange(T, device=x.device)
        r = self.r
        h = r(self.layernorm(x, ln1s, ln1b))
        qkv = r(self.mm(h, wqkv) + bqkv)
        q, k, v = qkv.split(D, dim=-1)
        q = r(self.rotary(q.reshape(R, T, H, hd), pos))
        k = r(self.rotary(k.reshape(R, T, H, hd), pos))
        v = v.reshape(R, T, H, hd)
        s = (self.r(q.permute(0, 2, 1, 3)) @ self.r(k.permute(0, 2, 3, 1))
             ) / math.sqrt(hd)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        p = r(torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1))
        a = self.mm(p, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        x = r(x + r(self.mm(a.reshape(R, T, D), wo) + bo))
        h = r(self.layernorm(x, ln2s, ln2b))
        h = r(F.gelu(r(self.mm(h, wup) + bup), approximate="tanh"))
        return r(x + r(self.mm(h, wdn) + bdn))

    _BLOCK = ("ln1/scale", "ln1/bias", "attn_qkv/kernel", "attn_qkv/bias",
              "attn_out/kernel", "attn_out/bias", "ln2/scale", "ln2/bias",
              "mlp_up/kernel", "mlp_up/bias", "mlp_down/kernel",
              "mlp_down/bias")

    def hidden(self, p: Dict[str, torch.Tensor], tokens: torch.Tensor,
               remat: bool) -> torch.Tensor:
        """Final-LN hidden states [R, T, D] of token rows [R, T]."""
        x = self.r(p["embed/table"][tokens])
        for i in range(self.cfg["n_layers"]):
            args = [p["blocks/" + n][i] for n in self._BLOCK]
            if remat:
                x = checkpoint(self.block, x, *args, use_reentrant=False)
            else:
                x = self.block(x, *args)
        return self.r(self.layernorm(x, p["final_norm/scale"],
                                     p["final_norm/bias"]))

    def logits(self, p: Dict[str, torch.Tensor], h: torch.Tensor
               ) -> torch.Tensor:
        """fp32 logits against the tied table, as the program's head."""
        return h @ p["embed/table"].T


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def train_readings(cfg: dict, seed: int, batches: Sequence, device, *,
                   precision: str = "fp32", rows_per_block: int = 2,
                   rows: Optional[int] = None) -> Dict:
    """Follow ``len(batches)`` AdamW steps from the seed's weights.

    ``batches``: int arrays [B, T + 1]. ``rows`` keeps only the first
    ``rows`` of each batch (the loss is then their mean: a fault). Returns
    each step's loss and gradient norm before clipping, and each leaf's
    norm of the first clipped gradient and of the change after the last
    step, by path."""
    _no_tf32()
    ref = Ref(cfg, precision)
    opt = cfg["optimizer"]
    p = {k: t.requires_grad_(True)
         for k, t in weights.flat(weights.make_params(cfg, seed, device))
         .items()}
    names = list(p)
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses: List[float] = []
    norms: List[float] = []
    first_grad: Dict[str, float] = {}
    for step, batch in enumerate(batches, start=1):
        b = torch.as_tensor(batch, device=device).long()
        if rows is not None:
            b = b[:rows]
        B, T = b.shape[0], b.shape[1] - 1
        total = 0.0
        for r0 in range(0, B, rows_per_block):
            blk = b[r0:r0 + rows_per_block]
            h = ref.hidden(p, blk[:, :-1], remat=True)
            lg = ref.logits(p, h)
            loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                                   blk[:, 1:].reshape(-1),
                                   reduction="sum") / (B * T)
            loss.backward()
            total += float(loss.detach())
            del h, lg, loss
        losses.append(total)
        with torch.no_grad():
            g = {k: p[k].grad for k in names}
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(t) for t in g.values()]))
            norms.append(float(norm))
            scale = min(1.0, opt["clip_global_norm"] / float(norm))
            for k in names:
                g[k].mul_(scale)
            if step == 1:
                first_grad = {k: float(torch.linalg.vector_norm(g[k]))
                              for k in names}
            bc1 = 1.0 - opt["b1"] ** step
            bc2 = 1.0 - opt["b2"] ** step
            for k in names:
                m[k].mul_(opt["b1"]).add_(g[k], alpha=1 - opt["b1"])
                v[k].mul_(opt["b2"]).addcmul_(g[k], g[k], value=1 - opt["b2"])
                u = (m[k] / bc1) / ((v[k] / bc2).sqrt() + opt["eps"])
                u.add_(p[k], alpha=opt["weight_decay"])
                p[k].add_(u, alpha=-opt["lr"])
                p[k].grad = None
    del m, v
    change: Dict[str, float] = {}
    with torch.no_grad():
        for i, k in enumerate(names):
            p0 = weights.make_leaf(cfg, seed, i, device)
            change[k] = float(torch.linalg.vector_norm(p[k] - p0))
            del p0
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "grad_norms": norms}


def served_gaps(cfg: dict, seed: int, requests: Sequence, device, *,
                control: bool = False) -> List[List[float]]:
    """For each ``(prompt, served tokens)``: the gap, at each served
    position, between the reference's best logit and the logit of the
    token served there. With ``control``, the served tokens are replaced,
    position by position, by the first choice of the control over the
    same context (the control needs no decode)."""
    _no_tf32()
    ref = Ref(cfg, "fp32")
    low = Ref(cfg, "fp8")
    p = weights.flat(weights.make_params(cfg, seed, device))
    out: List[List[float]] = []
    with torch.no_grad():
        for prompt, served in requests:
            seq = list(prompt) + list(served[:-1])
            tok = torch.tensor([seq], device=device)
            lo, hi = len(prompt) - 1, len(seq)
            lg = ref.logits(p, ref.hidden(p, tok, remat=False)[0, lo:hi])
            if control:
                h = low.hidden(p, tok, remat=False)[0, lo:hi]
                chosen = low.logits(p, h).argmax(-1)
            else:
                chosen = torch.tensor(list(served), device=device)
            best = lg.max(-1).values
            got = lg.gather(-1, chosen[:, None]).squeeze(-1)
            out.append((best - got).tolist())
    return out
