"""Build, load and call the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, under
``build/repro_torch_kernels/`` at the repository root, and loaded with
``ctypes``.  The library's file name carries a hash of its sources, so an
edited source is rebuilt and a stale library is never loaded.  Pointers
and the CUDA stream cross the boundary as ``c_void_p``; every entry
returns ``cudaGetLastError()`` and :func:`check` raises if it is not 0.

Kernels read dense arrays: :func:`dense` hands a wrapper its input itself
when it is contiguous and 16-byte aligned, else a contiguous, aligned copy
made on the card, counted on the wrapper's ``copies`` beside its
``launches``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "ARCH", "nvcc_command", "build", "bind",
           "check", "on_card", "dtype_code", "dense", "is_dense",
           "stream_ptr", "sm_count"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = "arch=compute_90a,code=sm_90a"

# Element-type codes of csrc/common.cuh (ReproDType).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# Alignment of the data every kernel reads (16-byte vectors, TMA).
ALIGN = 16

_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def nvcc_command(source: Path, output: Path) -> list[str]:
    """The nvcc line that builds one kernel library."""
    return [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(output),
            str(source)]


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    sources (the kernel's own file plus every shared header)."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: list[str], seconds: dict | None = None) -> dict[str, str]:
    """Compile every named kernel whose library is missing, all nvcc
    processes started together; returns each built kernel's compiler log
    (ptxas register and shared-memory report), and puts each one's nvcc
    wall seconds in ``seconds`` where given.  Raises on a failed build."""
    with _LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            log = open(lib.with_suffix(f".{os.getpid()}.log"), "w+")
            procs[name] = (lib, tmp, log, subprocess.Popen(
                nvcc_command(CSRC / f"{name}.cu", tmp),
                stdout=log, stderr=subprocess.STDOUT))
        logs, failed = {}, []
        while procs:
            for name, (lib, tmp, log, proc) in list(procs.items()):
                if proc.poll() is None:
                    continue
                del procs[name]
                if seconds is not None:
                    seconds[name] = time.perf_counter() - t0
                log.seek(0)
                logs[name] = out = log.read()
                log.close()
                Path(log.name).unlink()
                if proc.returncode != 0:
                    failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, lib)
            if procs:
                time.sleep(0.05)
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return logs


@functools.cache
def _load(name: str) -> ctypes.CDLL:
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def bind(name: str, symbol: str, argtypes: list, restype=ctypes.c_int):
    """One exported C function of kernel ``name``, built and loaded on
    first use, with its argument types declared."""
    fn = getattr(_load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


def check(name: str, err: int) -> None:
    """Raise if a kernel entry reported a CUDA error."""
    if err != 0:
        text = _load(name).repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({text})")


def on_card(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device (launch the kernel),
    False when all lie on the CPU (run the plain version); raises on mixed
    or other devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {dev}")


def dtype_code(*tensors: torch.Tensor) -> int:
    """The kernel's element-type code; raises unless all tensors share one
    dtype the kernels take (float32, bfloat16 or float16)."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPE_CODES:
        raise ValueError(
            f"kernel takes one dtype of {list(DTYPE_CODES)}, got {dtypes} "
            f"(other dtypes: ROADMAP.md, queue 2)")
    return DTYPE_CODES[dtypes.pop()]


def is_dense(t: torch.Tensor) -> bool:
    """Whether a kernel may read ``t`` as it lies: contiguous and 16-byte
    aligned."""
    return t.is_contiguous() and t.data_ptr() % ALIGN == 0


def dense(t: torch.Tensor, owner=None) -> torch.Tensor:
    """``t`` itself when it is contiguous and 16-byte aligned, else a
    contiguous, aligned copy of it on its own device (a strided, expanded
    or sliced view, or a contiguous one that starts off 16 bytes), counted
    on ``owner.copies`` (the wrapper that launches on it) where given."""
    if is_dense(t):
        return t
    # the caching allocator's blocks are 512-byte aligned
    out = t.clone(memory_format=torch.contiguous_format)
    if owner is not None:
        owner.copies += 1
    return out


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an integer."""
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """Streaming multiprocessors of the CUDA device ``t`` lies on."""
    return _sms(t.device.index if t.device.index is not None
                else torch.cuda.current_device())
