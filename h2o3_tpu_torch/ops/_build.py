"""Build the port's CUDA sources with nvcc, and the repository's host C++
sources with the host compiler, and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `ops/build/lib<name>-<hash>.so` (git-ignored), for sm_90a:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

`load_host(name)` builds `native/<name>.cpp` (TreeSHAP) the same way with
`native/Makefile`'s flags:

    c++ -O3 -fPIC -std=c++17 -Wall -shared -o build/lib<name>-<hash>.so \
        native/<name>.cpp

The file name carries a hash of the source and flags, so an edited source
is rebuilt and a stale library is never loaded. A failed build raises
BuildError. Nothing here runs when the module is imported; the CPU tests
reach only the host build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NATIVE = Path(__file__).resolve().parents[2] / "native"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v"]
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]


class BuildError(RuntimeError):
    """A compiler failed or is missing."""


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's usual prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _target(name: str, src: Path, flags) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def library_path(name: str) -> Path:
    """Where csrc/<name>.cu builds to (the name hashes source and flags)."""
    return _target(name, CSRC / f"{name}.cu", NVCC_FLAGS)


def _spawn(out: Path, cmd_head, src: Path):
    """Start one compile into a temporary beside `out`; returns (target,
    (process, temporary)), or (target, None) when it is built already."""
    if out.exists():
        return out, None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.Popen([*cmd_head, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise BuildError(f"cannot run {cmd_head[0]}: {e}") from e
    return out, (proc, tmp)


def _start(name: str):
    """Start nvcc for one source; returns (target, process or None)."""
    return _spawn(library_path(name), [nvcc_path(), *NVCC_FLAGS],
                  CSRC / f"{name}.cu")


def _finish(name: str, out: Path, pending) -> str:
    if pending is None:
        return ""
    proc, tmp = pending
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"build of {name} failed:\n{log}")
    os.replace(tmp, out)         # atomic: concurrent builders never see half
    return log


_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def build_all() -> dict[str, str]:
    """Compile every source in parallel (one nvcc each, all started
    together). Returns {name: nvcc output} for the sources built now."""
    with _LOCK:
        started = {n: _start(n) for n in sources()}
        for n, (out, pending) in started.items():
            BUILD_LOGS[n] = _finish(n, out, pending)
    return {n: BUILD_LOGS[n] for n in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            out, pending = _start(name)
            BUILD_LOGS[name] = _finish(name, out, pending)
            lib = _LIBS[name] = ctypes.CDLL(str(out))
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for native/<name>.cpp, built first if needed with
    the host C++ compiler ($CXX, else c++) and native/Makefile's flags."""
    key = f"host:{name}"
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            src = NATIVE / f"{name}.cpp"
            if not src.is_file():
                raise BuildError(f"{src} not found")
            out, pending = _spawn(_target(name, src, HOST_FLAGS),
                                  [os.environ.get("CXX") or "c++",
                                   *HOST_FLAGS], src)
            BUILD_LOGS[key] = _finish(name, out, pending)
            lib = _LIBS[key] = ctypes.CDLL(str(out))
    return lib
