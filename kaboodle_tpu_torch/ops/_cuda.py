"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by one
``nvcc`` call into its own shared library for Hopper (``sm_90a``), loaded
with ``ctypes``. Nothing includes PyTorch's headers, so a build takes
seconds. The libraries go to ``kaboodle_tpu_torch/_build/`` under a name
that carries a digest of the sources and flags, so an edited source is
never served by a stale library. A build that fails raises with nvcc's
output; nothing falls back to a plain version.

``launches`` counts the launches of each kernel since ``reset_launches``:
a wrapper adds one exactly where it launches its kernel. ``cost_unit``
makes a wrapper one unit of an open costscope counter
(``costscope/extract.py``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("fused_fp", "fused_suspicion", "fused_oldest_k")
KERNELS = ("fused_fp_idv", "fused_fp_hash", "fused_suspicion", "fused_oldest_k")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

launches: dict[str, int] = {k: 0 for k in KERNELS}
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output of each build this process ran (ptxas registers and spills).
build_logs: dict[str, str] = {}


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


# The costscope counter that is open in this process, or None.
counter = None


def cost_unit(flops):
    """Decorator: the wrapper is one unit of an open costscope counter.

    The unit counts the wrapper's tensor arguments and outputs and
    ``flops(*args, **kwargs)`` operations, and nothing that runs inside it
    (the kernel launch, or on the CPU its plain version), so a record is
    the same on either device. With no counter open the wrapper runs as
    it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def unit(*args, **kwargs):
            if counter is None:
                return fn(*args, **kwargs)
            return counter.unit(fn, args, kwargs, int(flops(*args, **kwargs)))
        return unit
    return wrap


def cell_flops(state, *args, **kwargs) -> int:
    """A kernel's operations for costscope: one a cell of the plane it scans."""
    return state.numel()


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``; raises if none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        cands.append(Path(shutil.which("nvcc")))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile the missing libraries of ``names``, one nvcc each, all at once.

    Returns ``{name: library path}``; raises with nvcc's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in names}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, p in todo.items():
        tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        build_logs[name] = out + err
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str, **signatures) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each entry point to its ctypes ``argtypes``; every
    entry point returns the launch's ``cudaError_t`` as an int."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        lib.kb_error_string.argtypes = [ctypes.c_int]
        lib.kb_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if rc != 0:
        msg = lib.kb_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def vec_ok(n: int, *tensors) -> int:
    """1 where every row starts 16-byte aligned, so rows load in 16-byte words."""
    return int(n % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


def stream_handle(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, for a kernel launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)
