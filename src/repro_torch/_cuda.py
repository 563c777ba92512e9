"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point
(it may include the shared ``csrc/*.cuh`` headers).  It is compiled by
``nvcc`` for ``sm_90a`` into a shared library at first use and loaded
with ``ctypes``.  The library lands in ``build/repro_torch/`` beside
``src/`` (or ``$REPRO_TORCH_BUILD_DIR``), named by a hash of the source,
the headers and the flags, so an edited source is rebuilt and an
unchanged one is reused.

A missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

__all__ = ["NVCC_FLAGS", "BUILD_LOG", "build", "load", "nvcc_path"]

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(
    os.environ.get("REPRO_TORCH_BUILD_DIR")
    or Path(__file__).resolve().parents[2] / "build" / "repro_torch"
)

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: kernel name -> nvcc's output (ptxas register / spill report) of the
#: build made by this process
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$NVCC``, ``nvcc`` on ``PATH``, else the
    toolkit under ``$CUDA_HOME`` or its standard prefix."""
    cands = [
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the port's CUDA kernels "
        "are built from source at first use"
    )


def _target(name: str) -> Tuple[Path, Path]:
    src = _SRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(_SRC_DIR.glob("*.cuh")))
    key = hashlib.sha1(
        src.read_bytes() + headers + "\0".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, _BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; returns name -> library path."""
    out: Dict[str, Path] = {}
    procs = []
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent builder sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, Tuple[object, list]]) -> ctypes.CDLL:
    """Build (if needed) and load kernel ``name``, declaring each entry
    point's ``(restype, argtypes)`` so ctypes never truncates a
    pointer."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, (restype, argtypes) in signatures.items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _LIBS[name] = lib
    return lib
