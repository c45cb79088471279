"""Command line of the port: ``python -m determined_clone_tpu_torch.cli``
(the command tree is ``cli.py``, the port's copy of the JAX package's)."""
from determined_clone_tpu_torch.cli.cli import build_parser, main

__all__ = ["build_parser", "main"]
