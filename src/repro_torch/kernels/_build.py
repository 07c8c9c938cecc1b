"""Build the port's CUDA sources into plain-C shared libraries and load them.

Each kernel's sources are compiled with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
The build runs at first use, into ``build/repro_torch/`` at the root of the
checkout, keyed by a hash of the sources and flags: a library built from
other sources is never reused, and a second call in one process loads the
cached handle.  The compiler's output (``-Xptxas -v``: registers, shared
memory, spills per kernel) is kept beside the library as ``<name>.log``;
:func:`sass` disassembles a built library with the toolkit's ``cuobjdump``
and :func:`tensor_core_ops` counts the tensor-core instructions of its
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def build_library(name: str, sources) -> Path:
    """Compile ``sources`` into ``build/repro_torch/lib<name>-<hash>.so``
    (skipped when that file exists) and return its path."""
    sources = [Path(s) for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    out.with_name(f"{name}.log").write_text(log)
    os.replace(tmp, out)          # atomic: a reader never sees a partial .so
    return out


def load_library(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load the library; cached per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_library(name, sources)))
        _LOADED[name] = lib
    return lib


def build_log(name: str) -> str:
    """The compiler's output from the last build of ``name`` ("" if none)."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def sass(name: str, sources) -> str:
    """The SASS of the library built from ``sources`` (``cuobjdump -sass``
    from the toolkit beside nvcc)."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "-sass",
                           str(build_library(name, sources))],
                          capture_output=True, text=True, check=True)
    return proc.stdout


def tensor_core_ops(sass_text: str, function: str) -> dict:
    """{kernel: tensor-core instructions} for every kernel in ``sass_text``
    (the output of :func:`sass`) whose mangled name contains ``function``:
    the lines whose opcode is HMMA (``mma.sync``) or HGMMA (``wgmma``), with
    any modifiers and predicate."""
    op = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?HG?MMA\b")
    counts, current = {}, None
    for line in sass_text.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            current = head.group(1) if function in head.group(1) else None
            if current:
                counts[current] = 0
        elif current and op.match(line):
            counts[current] += 1
    return counts
