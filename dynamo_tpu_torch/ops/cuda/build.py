"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` (with the ``csrc/*.cuh`` headers it includes) is
compiled by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers: a build takes seconds, not minutes)
inside ``dynamo_tpu_torch/_build/``, which git ignores. The library's file
name carries a hash of its source and flags, so an edited source rebuilds
and an unchanged one is loaded from the previous build. ``build_host``
does the same for a host-only C++ source that calls into libtorch_cpu,
with the host's C++ compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    lib: ctypes.CDLL
    ptxas: List[str]  # the compiler's per-kernel register/spill lines


_locks_guard = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, Built] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def build(name: str, directory: Path = CSRC) -> Built:
    """Compile ``<directory>/<name>.cu`` (``csrc/`` by default; a source
    elsewhere may include the ``csrc/*.cuh`` headers) if needed and load it
    (once per process; different sources build concurrently)."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = Path(directory) / f"{name}.cu"
        # The shared headers are hashed too: an edited header rebuilds.
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        log = BUILD_DIR / f"lib{name}-{digest}.log"
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            log.write_text(proc.stderr)
            os.replace(tmp, out)
        ptxas = [
            line for line in (log.read_text().splitlines() if log.exists() else [])
            if "Used" in line or "Compiling" in line or "spill" in line
        ]
        built = Built(lib=ctypes.CDLL(str(out)), ptxas=ptxas)
        _loaded[name] = built
        return built


def build_host(src: Path) -> ctypes.CDLL:
    """Compile the C++ source ``src`` (no PyTorch headers; it declares the
    libtorch_cpu functions it calls) with ``$CXX`` (``g++`` by default),
    linked against this process's libtorch_cpu, if needed, and load it
    (once per process)."""
    import torch

    src = Path(src)
    key = str(src)
    with _locks_guard:
        lock = _locks.setdefault(key, threading.Lock())
    with lock:
        if key in _loaded:
            return _loaded[key].lib
        torch_lib = Path(torch.__file__).parent / "lib"
        flags = ["-O2", "-std=c++17", "-shared", "-fPIC", "-fno-sized-deallocation",
                 f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
        libs = ["-L", str(torch_lib), "-ltorch_cpu", f"-Wl,-rpath,{torch_lib}"]
        cxx = os.environ.get("CXX", "g++")
        digest = hashlib.sha256(
            src.read_bytes() + " ".join([cxx, torch.__version__, *flags, *libs]).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(src), *libs],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {src} (exit {proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        built = Built(lib=ctypes.CDLL(str(out)), ptxas=[])
        _loaded[key] = built
        return built.lib
