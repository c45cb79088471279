"""PyTorch/CUDA port of ``determined_clone_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; every module here
mirrors the module path of its JAX counterpart so a reader finds each
pair. The port imports ``torch`` and ``numpy`` only — never JAX and
never the JAX package, not even its pure-Python modules (it keeps its
own copy of what it needs).

Entry points default to ``device="cuda"`` and raise when CUDA is absent
unless the caller asks for the CPU explicitly, so a run that meant to
use the card can never quietly land on the host. The one hand-written
kernel is the flash-attention forward (``csrc/flash_attn_fwd.cu``,
wrapped by ``ops/flash_attention.py``); the serving engine captures its
paged forward in CUDA graphs (``serving/engine.py``).
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # lazy, so that a module that needs no tensor (the NTSC task server,
    # the agent, the CLI's master commands) starts without importing torch
    if name == "resolve_device":
        from determined_clone_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
