"""Seeded GPT weights, made by the benchmark and handed alike to the
program and to the plain reference.

Each leaf has a generator of its own, seeded from ``(seed, leaf index)``,
so one leaf can be drawn again alone (the reference and the checks do
that leaf by leaf, so that they never hold a second copy of the model).
The layout is the port's stacked-block tree: ``blocks/<name>/<leaf>``
carry a leading ``[L]`` layer dimension, so the whole model is five
draws on the device (the table and the four stacked products, each a
normal truncated to two standard deviations) and ten fills.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# (path, shape as a function of the config, kind, std scale)
# kind: "normal" (std 0.02 times the scale), "ones" or "zeros"


def leaf_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    L, D, F, V = (cfg["n_layers"], cfg["d_model"], cfg["d_ff"],
                  cfg["vocab_size"])
    out_scale = 1.0 / (2 * L) ** 0.5
    return [
        ("embed/table", (V, D), "normal", 1.0),
        ("blocks/ln1/scale", (L, D), "ones", 0.0),
        ("blocks/ln1/bias", (L, D), "zeros", 0.0),
        ("blocks/attn_qkv/kernel", (L, D, 3 * D), "normal", 1.0),
        ("blocks/attn_qkv/bias", (L, 3 * D), "zeros", 0.0),
        ("blocks/attn_out/kernel", (L, D, D), "normal", out_scale),
        ("blocks/attn_out/bias", (L, D), "zeros", 0.0),
        ("blocks/ln2/scale", (L, D), "ones", 0.0),
        ("blocks/ln2/bias", (L, D), "zeros", 0.0),
        ("blocks/mlp_up/kernel", (L, D, F), "normal", 1.0),
        ("blocks/mlp_up/bias", (L, F), "zeros", 0.0),
        ("blocks/mlp_down/kernel", (L, F, D), "normal", out_scale),
        ("blocks/mlp_down/bias", (L, D), "zeros", 0.0),
        ("final_norm/scale", (D,), "ones", 0.0),
        ("final_norm/bias", (D,), "zeros", 0.0),
    ]


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit seed for leaf ``index`` of run ``seed`` (any size of int)."""
    return int(np.random.SeedSequence([seed, 7, index])
               .generate_state(1, np.uint64)[0]) >> 1


def make_leaf(cfg: dict, seed: int, index: int, device,
              dtype=torch.float32) -> torch.Tensor:
    path, shape, kind, scale = leaf_specs(cfg)[index]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    t.mul_(cfg.get("init_std", 0.02) * scale)
    return t.to(dtype)


def make_params(cfg: dict, seed: int, device) -> Dict:
    """The whole tree, nested as the port's ``gpt.init`` nests it."""
    tree: Dict = {}
    for i, (path, *_rest) in enumerate(leaf_specs(cfg)):
        t = make_leaf(cfg, seed, i, device)
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t
    return tree


def flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a/b/c": tensor}`` of a nested dict, in insertion order."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "/"))
        else:
            out[key] = v
    return out
