"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  Builds happen at first use, into ``build/kernels/`` beside the
package (git-ignored); the library name carries a hash of every file under
``csrc/`` (the sources and the headers they include) and of the flags, so
an edited source or header is rebuilt and a stale library is never
loaded.  Nothing is compiled at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_attention.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME")


def library_path(source: str) -> Path:
    digest = hashlib.sha256(source.encode() + b"\0")
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        digest.update(path.relative_to(CSRC).as_posix().encode() + b"\0")
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(source: str) -> Path:
    """Compile ``source`` unless its library exists; returns the library.
    Raises :class:`KernelBuildError` with nvcc's output on a failure."""
    final = library_path(source)
    if final.exists():
        return final
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                        str(CSRC / source)], check=True,
                       capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise KernelBuildError(f"nvcc failed on {source} (rc {e.returncode})"
                               f":\n{e.stdout}{e.stderr}") from None
    os.replace(tmp, final)         # atomic: a reader sees all or nothing
    return final


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``source``, built first if needed."""
    return ctypes.CDLL(str(build(source)))
