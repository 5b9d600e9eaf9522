"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``.  The runtime's own CUDA sources (``nativeops/csrc/weight_arena.cu``, host
code on the driver API, linked with ``-lcuda``) build the same way from
their own ``csrc`` directory.  Builds happen at first use, into
``build/kernels/`` beside the
package (git-ignored), or into the directory :func:`set_build_dir` names
(the serving fleet's compile cache points it at a per-model namespace, so a
respawned worker loads the library instead of running ``nvcc`` again); the
library name carries a hash of every file under ``csrc/`` (the sources and
the headers they include) and of the flags, so an edited source or header
is rebuilt and a stale library is never loaded.  Nothing is compiled at
import.  Each :func:`build` counts in the compile watch as
``kernels.build``: a compile when ``nvcc`` runs, a cache hit when the
library is already there.
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
from typing import Optional, Union

from ..monitor import jit_watch as _jit_watch

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = ("flash_attention.cu", "adam_update.cu")
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


def set_build_dir(path: Optional[Union[str, Path]]) -> Path:
    """Build into (and load from) ``path``; ``None`` restores the default
    ``build/kernels/``.  Libraries already loaded stay loaded.  Returns
    the directory now in use."""
    global BUILD_DIR
    BUILD_DIR = DEFAULT_BUILD_DIR if path is None else Path(path)
    return BUILD_DIR


def _link_flags(link) -> list:
    """``-l`` flags for ``link``; the driver library links against the
    toolkit's stub (the process loads the real one with the driver)."""
    if not link:
        return []
    flags = []
    stubs = Path(nvcc_path()).resolve().parents[1] / "lib64" / "stubs"
    if stubs.is_dir():
        flags.append(f"-L{stubs}")
    return flags + [f"-l{name}" for name in link]


def library_path(source: str, csrc: Optional[Path] = None,
                 link=()) -> Path:
    csrc = CSRC if csrc is None else csrc
    digest = hashlib.sha256(source.encode() + b"\0")
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        digest.update(path.relative_to(csrc).as_posix().encode() + b"\0")
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS + tuple(link)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build(source: str, csrc: Optional[Path] = None, link=()) -> Path:
    """Compile ``source`` (a file under ``csrc``, default the kernels'
    ``csrc/``, linked with the libraries ``link`` names) unless its
    library exists; returns the library.  Raises
    :class:`KernelBuildError` with nvcc's output on a failure."""
    csrc = CSRC if csrc is None else csrc
    final = library_path(source, csrc, link)
    if final.exists():
        _jit_watch.cache_hit("kernels.build")
        return final
    with _jit_watch.compiling("kernels.build", signature=final.name):
        final.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=final.parent)
        os.close(fd)
        try:
            subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                            str(csrc / source), *_link_flags(link)],
                           check=True,
                           capture_output=True, text=True)
        except subprocess.CalledProcessError as e:
            os.unlink(tmp)
            raise KernelBuildError(
                f"nvcc failed on {source} (rc {e.returncode}):\n"
                f"{e.stdout}{e.stderr}") from None
        os.replace(tmp, final)     # atomic: a reader sees all or nothing
    return final


@functools.cache
def load(source: str, csrc: Optional[Path] = None,
         link=()) -> ctypes.CDLL:
    """The loaded library for ``source``, built first if needed."""
    return ctypes.CDLL(str(build(source, csrc, link)))
