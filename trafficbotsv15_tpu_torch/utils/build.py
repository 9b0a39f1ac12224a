"""Build the port's native sources and load them with ctypes.

Each kernel source under `csrc/` is compiled with nvcc on first use into
`trafficbotsv15_tpu_torch/build/lib<name>-<hash>.so` (a directory git
ignores); the host-only tbcache reader (`csrc/tbcache.cc`) likewise with g++
(`load_host`). The hash covers the source, the `csrc/` headers it includes and
every compiler flag, so a change to any of them gives a fresh build and a stale
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
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
HOST_LIBS = ("-lpthread",)
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


def _library_path(name: str, source: str, flags: Sequence[str]) -> Path:
    text = b"".join(p.read_bytes() for p in source_files(source))
    digest = hashlib.sha256(text + "\0".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def library_path(name: str, source: str, extra_flags: Sequence[str] = ()) -> Path:
    """build/lib<name>-<hash>.so, the hash taken over the source, the headers it includes and the nvcc flags."""
    return _library_path(name, source, (*ARCH_FLAGS, *BASE_FLAGS, *extra_flags))


def host_library_path(name: str, source: str) -> Path:
    """build/lib<name>-<hash>.so of a host source, the hash taken over the source and the g++ flags."""
    return _library_path(name, source, ("g++", *HOST_FLAGS, *HOST_LIBS))


def _compile(compiler_path, flags: Sequence[str], libs: Sequence[str], source: str, out: Path) -> Path:
    """Compile csrc/<source> into out unless that file exists (written whole: a temporary file, then a
    rename); compiler_path() finds the compiler, or raises, only when a build is needed."""
    if out.exists():
        return out
    compiler = compiler_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(CSRC_DIR / source), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(compiler).name} failed for {source} (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build(name: str, source: str, extra_flags: Sequence[str] = ()) -> Path:
    """Compile csrc/<source> with nvcc into library_path(...) unless that file exists."""
    return _compile(nvcc_path, (*ARCH_FLAGS, *BASE_FLAGS, *extra_flags), (), source,
                    library_path(name, source, extra_flags))


def build_host(name: str, source: str) -> Path:
    """Compile csrc/<source> with g++ into host_library_path(...) unless that file exists."""
    def gxx_path() -> str:
        found = shutil.which("g++")
        if found is None:
            raise RuntimeError(f"g++ not found: csrc/{source} is built with g++ on first use")
        return found

    return _compile(gxx_path, HOST_FLAGS, HOST_LIBS, source, host_library_path(name, source))


def _load(name: str, build_fn) -> ctypes.CDLL:
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_fn()))
        _LOADED[name] = lib
    return lib


def load(name: str, source: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Build with nvcc if needed and load the library once per process."""
    return _load(name, lambda: build(name, source, extra_flags))


def load_host(name: str, source: str) -> ctypes.CDLL:
    """Build with g++ if needed and load the library once per process."""
    return _load(name, lambda: build_host(name, source))


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
