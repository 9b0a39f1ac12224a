"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each kernel source under `csrc/` is compiled on first use into
`trafficbotsv15_tpu_torch/build/lib<name>-<hash>.so` (a directory git
ignores). The hash covers the source, the `csrc/` headers it includes and
every nvcc flag, so a change to any of them gives a fresh build and a stale
library is never loaded. The sources expose a
plain C interface, so no PyTorch header is compiled and a build takes
seconds. Nothing here runs at import time.

    python -m trafficbotsv15_tpu_torch.utils.build knarpe_bwd.cu [knn.cu ...]

compiles each named source once more with `-Xptxas -v` (into a scratch file
under `build/`) and prints what ptxas reports for each kernel: registers,
shared memory, spills.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
_LOCAL_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on a machine with the CUDA toolkit")


def source_files(source: str) -> List[Path]:
    """csrc/<source> and every csrc/ header it includes with `#include "..."`, directly or
    through another header, in the order first met."""
    found, todo = [], [CSRC_DIR / source]
    while todo:
        path = todo.pop(0)
        if path not in found:
            found.append(path)
            todo += [CSRC_DIR / n for n in _LOCAL_INCLUDE.findall(path.read_text()) if (CSRC_DIR / n).is_file()]
    return found


def library_path(name: str, source: str, extra_flags: Sequence[str] = ()) -> Path:
    """build/lib<name>-<hash>.so, the hash taken over the source, the headers it includes and the nvcc flags."""
    flags = (*ARCH_FLAGS, *BASE_FLAGS, *extra_flags)
    text = b"".join(p.read_bytes() for p in source_files(source))
    digest = hashlib.sha256(text + "\0".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, source: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile csrc/<source> into library_path(...) unless that file exists."""
    src = CSRC_DIR / source
    out = library_path(name, source, extra_flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, source: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build if needed and load the library once per process."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, source, extra_flags)))
        _LOADED[name] = lib
    return lib


def ptxas_report(source: str, extra_flags: Sequence[str] = ()) -> str:
    """What `nvcc -Xptxas -v` says for csrc/<source>, built with the library's flags."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"ptxas-{os.getpid()}.so"
    cmd = [nvcc_path(), *ARCH_FLAGS, *BASE_FLAGS, *extra_flags, "-Xptxas", "-v", "-o", str(out), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} (rc {proc.returncode}):\n{proc.stderr}")
    return proc.stderr


if __name__ == "__main__":
    for name in sys.argv[1:]:
        print(f"== {name}\n{ptxas_report(name)}", flush=True)
