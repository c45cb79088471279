"""Lazy build and ctypes binding of the port's CUDA kernels.

Each kernel source under ``csrc/`` has a plain C interface; ``nvcc``
compiles it for Hopper (``sm_90a``) into a shared library that
``ctypes`` loads. That route builds in seconds, where a source that
includes PyTorch's headers (``torch.utils.cpp_extension.load``) takes
minutes — and every run on a fresh machine builds from nothing.

Nothing builds at import time: the first call of :func:`library` (or
:func:`build_all`) compiles. Libraries go to ``_build/`` inside the
package (ignored by git), named by a hash of the source and the flags,
so an edited source never loads a stale library. :func:`build_all`
starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler", "-fPIC",
    # conversions between bf16 and float only through the intrinsics
    "-D__CUDA_NO_BFLOAT16_CONVERSIONS__",
    "-Xptxas=-v",
)

_c = ctypes
# kernel name -> (source file, {C function: (restype, argtypes)})
KERNELS: Dict[str, tuple] = {
    "flash_attn_fwd": ("flash_attn_fwd.cu", {
        # dtype, head_dim, q, k, v, o, B, H, Tq, Tk, strides[12], scale,
        # causal, stream
        "flash_attn_fwd": (_c.c_int, [
            _c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p,
            _c.c_void_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
            _c.POINTER(_c.c_longlong), _c.c_float, _c.c_int, _c.c_void_p]),
        "flash_attn_error_string": (_c.c_char_p, [_c.c_int]),
    }),
}


@dataclasses.dataclass
class BuildRecord:
    name: str
    path: Path
    seconds: float          # nvcc wall time; 0.0 when already built
    ptxas: str              # nvcc's -Xptxas=-v report (registers, spills)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_records: Dict[str, BuildRecord] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def _target(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> List[BuildRecord]:
    """Compile every named kernel (default: all) that is not built yet,
    one ``nvcc`` process per source, all started together. Raises with
    the compiler's output if any build fails."""
    names = list(KERNELS if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _records]
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = None
            procs = {}
            t0 = time.monotonic()
            for n in todo:
                out = _target(n)
                if out.exists():
                    _records[n] = BuildRecord(n, out, 0.0, "")
                    continue
                nvcc = nvcc or _nvcc()
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                       str(CSRC / KERNELS[n][0])]
                procs[n] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            failures = []
            for n, (proc, tmp, out) in procs.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    failures.append(f"{n}: nvcc exited {proc.returncode}\n"
                                    f"{log}")
                    continue
                os.replace(tmp, out)  # atomic: no half-written library
                _records[n] = BuildRecord(n, out, time.monotonic() - t0,
                                          log)
            if failures:
                raise RuntimeError("kernel build failed:\n"
                                   + "\n".join(failures))
        return [_records[n] for n in names]


def built() -> List[str]:
    """The kernels built (or found built) in this process, sorted."""
    with _lock:
        return sorted(_records)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` with its C functions'
    signatures declared; builds it on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    (record,) = build_all([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(record.path))
            for fn, (restype, argtypes) in KERNELS[name][1].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
        return _libs[name]
