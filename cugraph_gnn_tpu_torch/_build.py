"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``_build/lib<name>-<digest>.so``, where the digest covers the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt
and an unchanged one is reused.  Sources
are compiled at first use; :func:`build` starts one nvcc per source, all at
once.  ``torch.utils.cpp_extension`` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C one seconds.
:func:`host_library` builds host C++ (``cpp/``) the same way, with g++.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# sm_90a (not sm_90) admits wgmma/setmaxnreg for later kernels.  No
# --use_fast_math: the sampler's positions must match XLA's f32 multiply.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_FUNCTIONS: Dict[str, Callable[..., int]] = {}


@dataclass(frozen=True)
class Built:
    """One compiled source: the library, the seconds nvcc took (0.0 when an
    up-to-date library was reused) and nvcc's output, which holds ptxas's
    register and shared-memory lines."""

    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin or on PATH; the port's "
            "kernels are built on the machine with the card")
    return found


def _digest(sources: Sequence[Path], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    # the digest covers the shared headers too, so editing one rebuilds
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    return BUILD_DIR / f"lib{name}-{_digest(sources, NVCC_FLAGS)}.so"


def host_library(name: str, sources: Sequence[Path], flags: Sequence[str]) -> Path:
    """``_build/lib<name>-<digest>.so`` compiled from the C++ ``sources`` by
    the host compiler (g++) with ``flags``, reused while sources and flags
    are unchanged.  Raises FileNotFoundError when there is no g++, and
    RuntimeError with the compiler's output when the build fails."""
    lib = BUILD_DIR / f"lib{name}-{_digest(sources, flags)}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), *map(str, sources)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def build(names: Sequence[str]) -> Dict[str, Built]:
    """Compile every named source whose library is missing, one nvcc process
    each, all started together.  Raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    running = {}
    out: Dict[str, Built] = {}
    for name in names:
        lib = library_path(name)
        log_path = lib.with_suffix(".log")
        if lib.exists():
            log = log_path.read_text() if log_path.exists() else ""
            out[name] = Built(lib, 0.0, log)
            continue
        compiler = compiler or nvcc()
        # a private temporary name, renamed into place, so that processes
        # building the same source at once never load a half-written file
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib, time.perf_counter())
    failed = []
    for name, (proc, tmp, lib, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        lib.with_suffix(".log").write_text(log)
        out[name] = Built(lib, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def function(name: str, argtypes, symbol: str = "") -> Callable[..., int]:
    """The C entry ``symbol`` (default ``name``: each source exports an entry
    named after its file) of ``csrc/<name>.cu``, built and loaded at first
    use, with ``argtypes`` declared and an int (cudaError_t) result."""
    symbol = symbol or name
    fn = _FUNCTIONS.get(symbol)
    if fn is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[symbol] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")
