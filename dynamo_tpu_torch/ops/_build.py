"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point (no PyTorch headers),
so ``nvcc`` compiles it in seconds into ``_build/<name>-<hash>.so``; the
hash covers the source text and the flags, so an edited source rebuilds
and an unchanged one is reused. ``_build/`` is git-ignored.

Importing this module runs nothing: the compiler is looked up and started
only when a kernel is first needed on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()  # guards the two dicts below
_libs: dict[str, ctypes.CDLL] = {}
_source_locks: dict[str, threading.Lock] = {}  # one build of a source at a time


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ at first use"
    )


def build(src: Path, out: Path, extra_flags: tuple[str, ...] = (),
          prefix: tuple[str, ...] = ()) -> str:
    """Compile one source into the shared library ``out`` (``extra_flags``
    after the port's, e.g. ``-Xptxas -v`` for the compiler's register
    report; nvcc run under ``prefix``, e.g. ``("nice", "-n", "10")``) and
    return the compiler's output; raises with it if nvcc fails. The
    library appears under its name only once complete, so a concurrent
    process never loads half a file."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [*prefix, nvcc_path(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use. Two
    sources build at once from two threads; one source builds once."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        source_lock = _source_locks.setdefault(name, threading.Lock())
    with source_lock:
        with _lock:
            lib = _libs.get(name)
        if lib is None:
            src = CSRC_DIR / f"{name}.cu"
            digest = hashlib.sha256(
                src.read_bytes() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            path = BUILD_DIR / f"{name}-{digest}.so"
            if not path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                build(src, path)
            lib = ctypes.CDLL(str(path))
            with _lock:
                _libs[name] = lib
        return lib
