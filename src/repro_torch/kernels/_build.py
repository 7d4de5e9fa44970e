"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled for Hopper (``sm_90a``) at first use into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``). The file name carries a hash of the source and the flags, so
an edited source is rebuilt and a stale library is never loaded. The sources
in the repo are the only input: no PyTorch headers, no library of finished
kernels.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when it is not 0 (``check``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("flash_attention", "paged_attention")

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Returns seconds per source
    built (0.0 where the library already existed)."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    seconds: Dict[str, float] = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)          # atomic: a reader never sees half a file
    if failures:
        raise KernelBuildError("\n".join(failures))
    return seconds


def load(name: str, signatures: Dict[str, Tuple[list, object]]
         ) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``argtypes``/``restype`` set from ``signatures`` ({function: (argtypes,
    restype)}). Pointers and the stream must be ``c_void_p``: ctypes would
    pass a bare Python int as a 32-bit int and cut the address."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.cuda_error_string = getattr(lib, f"{name}_error_string")
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode(errors="replace")
        raise KernelLaunchError(f"{what}: CUDA error {err} ({msg})")
