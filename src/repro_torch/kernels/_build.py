"""Build and load the hand-written CUDA kernels (route: nvcc -> .so ->
ctypes, with a plain C interface).

Every ``*.cu`` file under ``csrc/`` becomes its own shared library,
compiled for ``sm_90a`` at first CUDA use from the repository's sources
alone. All sources build at once (one ``nvcc`` process each, started
together). The output lands in ``build/repro_torch/<hash>/`` at the root
of the checkout, keyed by a hash of every file in ``csrc/`` and of the
compiler flags, so an edited source rebuilds and an unchanged one loads.

Nothing here runs at import time: the CPU tests import every module of
the package on a machine with no ``nvcc`` and no card.
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
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILT: list = []  # the libraries the last build_all() compiled


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "are built at first CUDA use and need the CUDA "
                       "toolkit")


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def build_all() -> dict:
    """Compile every source that has no library yet, all in parallel.
    Returns {name: path of the .so}. Raises with the compiler's output if
    any build fails."""
    with _LOCK:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src in sources():
            so = out / f"lib{src.stem}.so"
            if so.exists():
                continue
            tmp = out / f"lib{src.stem}.{os.getpid()}.tmp.so"
            log = open(out / f"{src.stem}.log", "w")
            procs[src.stem] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(src)], stdout=log, stderr=subprocess.STDOUT),
                tmp, so, log)
        failed = []
        for name, (proc, tmp, so, log) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
                continue
            os.replace(tmp, so)
        BUILT[:] = sorted(procs)
        if failed:
            msgs = "\n".join((out / f"{n}.log").read_text()[-4000:]
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
        return {src.stem: out / f"lib{src.stem}.so" for src in sources()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    call)."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        if name not in paths:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        lib = ctypes.CDLL(str(paths[name]))
        _LIBS[name] = lib
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {rc}")


def ptr_array(tensors) -> ctypes.Array:
    """A host array of device pointers, for entry points taking many
    operands at once."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
