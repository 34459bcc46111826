"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so \\
         csrc/<name>.cu

The file name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. nvcc's output (``-Xptxas
-v``: each kernel's registers and spills) is kept beside the library and
read by :func:`resource_usage`. All sources build at once,
one nvcc process each, started together. The build directory sits beside
this file and is listed in ``.gitignore``; nothing else is written.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..obs.jit import trace_sentinel

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("siggen", "hamming", "sw", "spgemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple, object] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> float:
    """Compile every kernel library that is missing; returns the seconds
    spent. Raises with nvcc's output if a source does not compile."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}.cu:\n{out.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            _target(name).with_suffix(".log").write_bytes(out)
            os.replace(tmp, _target(name))   # atomic: no torn library
    if errors:
        raise RuntimeError("nvcc failed\n" + "\n".join(errors))
    return time.perf_counter() - t0


def resource_usage(name: str) -> dict[str, dict[str, int]]:
    """Per kernel of ``csrc/<name>.cu`` (mangled entry name), what ptxas
    reported when it was built: registers, stack frame and spill bytes."""
    log = _target(name).with_suffix(".log")
    if not log.exists():
        return {}
    usage: dict[str, dict[str, int]] = {}
    entry = None
    for line in log.read_text(errors="replace").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = usage.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return usage


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed
    and loaded once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = _load(name)
        return lib


@trace_sentinel("kernel_library")
def _load(name: str) -> ctypes.CDLL:
    build_all()
    return ctypes.CDLL(str(_target(name)))


def function(lib_name: str, fn_name: str, argtypes: list):
    """A C entry point with its argument types declared (pointers and the
    stream as ``c_void_p``, ints as ``c_int``); it returns a cudaError_t."""
    key = (lib_name, fn_name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def launch(fn, device: torch.device, *args) -> None:
    """Call a kernel's C entry point on ``device``'s current stream (the
    stream goes last) and raise if the launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
