"""Builds the port's CUDA sources into shared libraries, at first use.

Each kernel is one ``.cu`` file under `repro_torch/csrc/` with a plain C
interface (no PyTorch headers, so it compiles in seconds), which may
include headers of its own from the same directory. `build_library` runs
`nvcc` for ``sm_90a`` into a build directory next to the checkout's `src/`
(listed in `.gitignore`), keyed by a hash of the source, the headers it
includes and the flags, and `load_library` opens the result with
`ctypes`. Nothing here runs at import: the machine that imports the
package for the CPU tests has no `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        candidate = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        candidate = candidate / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc was not found on PATH or under CUDA_HOME: the CUDA "
            "kernels of repro_torch cannot be built on this machine")
    return nvcc


def local_includes(source: Path) -> list[Path]:
    """`source` and every file it includes with ``#include "..."``,
    directly or through another, resolved beside the including file (as
    nvcc resolves them), in the order first met."""
    seen = [source]
    for path in seen:
        for name in INCLUDE.findall(path.read_text()):
            header = Path(os.path.normpath(path.parent / name))
            if header not in seen:
                seen.append(header)
    return seen


def library_path(source: Path, flags=NVCC_FLAGS) -> Path:
    """The library's path, keyed by the bytes of `source`, of the headers
    it includes (`local_includes`) and by `flags`."""
    h = hashlib.sha256()
    for path in local_includes(source):
        h.update(path.read_bytes() + b"\0")
    h.update("\0".join(flags).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_library(name: str, flags=NVCC_FLAGS) -> Path:
    """Compile ``csrc/<name>.cu`` with `flags` unless an up-to-date library
    exists.

    nvcc's output (ptxas reports each kernel's registers and spills) is
    kept beside the library as ``<library>.log``. Raises RuntimeError
    carrying that output when the build fails."""
    source = CSRC_DIR / f"{name}.cu"
    out = library_path(source, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [find_nvcc(), *flags, "-o", str(tmp), str(source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library(name: str, flags=NVCC_FLAGS) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name, flags)))
