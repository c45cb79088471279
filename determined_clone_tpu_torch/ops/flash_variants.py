"""Variants of the flash kernel, built and timed against each other on one
card: an instrument for kernel work, on no path of the port.

    python3 -m determined_clone_tpu_torch.ops.flash_variants [name ...]

A variant is ``csrc/flash_attn_fwd.cu`` with text substitutions
(:data:`VARIANTS`): parameter changes, and ablations that drop a part of
the work to show what that part costs (their outputs are wrong, and the
error is printed beside the time). All variants build at once, one
``nvcc`` each, into ``_build/variants/``, and load into one process; each
case is timed by CUDA-graph replay (device time) with the variants in
turns, after the clocks are warmed. Prints one line per case and variant,
the card's name and power limit, and writes ``smoke_out/
flash_variants.json``.
"""
from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
from typing import Dict, List, Tuple

from determined_clone_tpu_torch.ops import _build

_NO_PV = ("    math.pv(o, s, st + E, lane);\n", "")
_NO_SOFTMAX = (
    "    for (int mt = 0; mt < MT; ++mt)\n"
    "      online_softmax<D / 8>(s[mt], m[mt], l[mt], o[mt], a.scale_log2, "
    "mask,\n"
    "                            row0 + mt * 16, k0 + 2 * t, a.Tk, causal);\n",
    "    l[0][0] += s[0][0][0];  // keeps the product alive\n")
_NO_QK = ("    math.qk(s, st, lane);\n", "")
_NO_P_LO = (("          mma_bf16(o[mt][d], plo[mt], vf[0], vf[1]);\n", ""),
            ("          mma_bf16(o[mt][d + 1], plo[mt], vf[2], vf[3]);\n", ""))

VARIANTS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "kernel": (),
    "one_m_tile": (("MT = D <= 64 ? 2 : 1;", "MT = 1;"),),
    "three_stages": (("constexpr int STAGES = 2;",
                      "constexpr int STAGES = 3;"),),
    "no_p_lo": _NO_P_LO,
    "no_pv": (_NO_PV,),
    "loads_qk": (_NO_PV, _NO_SOFTMAX),
    "loads": (_NO_PV, _NO_SOFTMAX, _NO_QK),
}

# (name, B, T, H, D, dtype, causal)
CASES = [("gpt_width_bf16_causal", 4, 1024, 12, 64, "bfloat16", True),
         ("gpt_width_fp32_causal", 4, 1024, 12, 64, "float32", True),
         ("gpt_width_bf16_noncausal", 4, 1024, 12, 64, "bfloat16", False)]


def variant_source(name: str) -> str:
    """The kernel source with ``name``'s substitutions; each must match the
    source exactly once."""
    src = (_build.CSRC / _build.KERNELS["flash_attn_fwd"][0]).read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} matches "
                             f"{src.count(old)} times")
        src = src.replace(old, new)
    return src


def build(names: List[str]) -> Dict[str, ctypes.CDLL]:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for n in names:
        src = out_dir / f"{n}.cu"
        src.write_text(variant_source(n))
        procs[n] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(out_dir / f"{n}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for n, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {n}: nvcc exited "
                               f"{proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{n}.so"))
        for fn, (restype, argtypes) in _build.KERNELS["flash_attn_fwd"][1]\
                .items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        libs[n] = lib
    return libs


def main(argv: List[str]) -> int:
    import torch

    from determined_clone_tpu_torch.ops.flash_attention import (
        flash_attention_reference,
        run_kernel,
    )
    from determined_clone_tpu_torch.timing import device_ms, warm_clocks

    if not torch.cuda.is_available():
        print("flash_variants: CUDA is not available", file=sys.stderr)
        return 1
    names = argv or list(VARIANTS)
    libs = build(names)
    warm_clocks()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for case, B, T, H, D, dt, causal in CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, T, H, D), generator=gen, device="cuda",
                        dtype=dtype)
        kv = torch.randn((B, T, 2 * H * D), generator=gen, device="cuda",
                         dtype=dtype)
        k = kv[..., :H * D].reshape(B, T, H, D)
        v = kv[..., H * D:].reshape(B, T, H, D)
        ref = flash_attention_reference(q, k, v, causal=causal).float()
        times: Dict[str, list] = {n: [] for n in names}
        for rnd in range(4):  # the variants in turns, the order alternating
            for n in (names if rnd % 2 == 0 else names[::-1]):
                times[n].append(device_ms(
                    lambda: run_kernel(libs[n], q, k, v, causal)))
        for n in names:
            err = (run_kernel(libs[n], q, k, v, causal).float()
                   - ref).abs().max().item()
            ms = statistics.median(times[n])
            rows.append({"case": case, "variant": n, "ms": ms,
                         "max_abs_err": err, "runs_ms": times[n]})
            print(f"{case:26s} {n:13s} {ms:.4f} ms  max abs err {err:.3g}",
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    out = _build._PKG.parent / "smoke_out"
    os.makedirs(out, exist_ok=True)
    with open(out / "flash_variants.json", "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
