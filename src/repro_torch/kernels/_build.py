"""Build and load the port's CUDA kernels (nvcc + ctypes).

The sources in ``csrc/`` have a plain C interface: each exports an
``extern "C" int <name>_launch(...)`` that launches on the given stream
and returns ``cudaGetLastError()``. At first use every source is compiled
by its own nvcc process, all started together, for ``sm_90a``; the
objects are linked into one shared library and loaded with ctypes. The
library lives in ``build/repro_torch_kernels/<hash>/`` at the root of
the checkout, named by a hash of the sources and flags, so an unchanged
checkout builds once. A failed build raises with nvcc's stderr; nothing
falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("pack_bits.cu", "am_search_packed.cu", "encode_pack.cu",
           "am_search.cu", "qail_update.cu")
HEADERS = ("sims_argmax.cuh",)  # included by sources; part of the hash
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every exported launcher: pointers and the stream as void*,
# so ctypes never narrows a 64-bit address to a 32-bit int.
SIGNATURES = {
    "pack_bits_launch": (_P, _P, _I64, _P),
    "am_search_packed_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _P),
    "encode_pack_launch": (_P, _P, _P, _I, _I, _I, _P),
    "am_search_launch": (_P, _P, _I64, _I64, _P, _P, _P, _P, _I, _I, _I,
                         _P),
    "qail_update_launch": (_P, _P, _P, _I64, _I64, _P, _P, _P, _F, _P, _P,
                           _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
build_log = ""  # ptxas register / shared-memory report of the last build


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return (_repo_root() / "build" / "repro_torch_kernels" / source_hash()
            / "librepro_torch_kernels.so")


def build() -> Path:
    """Compile the sources (one nvcc each, in parallel) and link them into
    one shared library, unless the library for these sources exists."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], []
        for name, obj, p in procs:
            stdout, stderr = p.communicate()
            logs.append(f"== {name}\n{stdout}{stderr}")
            if p.returncode != 0:
                failed.append(f"nvcc {name} exited {p.returncode}:\n"
                              f"{stderr}")
        build_log = "".join(logs)
        if failed:
            raise RuntimeError("CUDA kernel build failed\n"
                               + "\n".join(failed))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
             *(str(obj) for _, obj, _ in procs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"CUDA kernel link failed:\n{link.stderr}")
        os.replace(tmp_so, out)  # atomic: concurrent builds agree
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with "
                           f"cudaError_t {err}")


def check_operand(t, name: str, dtype, ndim: int, *,
                  contiguous: bool = True) -> None:
    """Validate a CUDA kernel operand: dtype, rank, contiguity (unless the
    launcher takes element strides), and a size that fits the launchers'
    32-bit int arguments."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if any(s >= 2 ** 31 for s in t.shape):
        raise ValueError(f"{name}: dimension too large for the kernel: "
                         f"{tuple(t.shape)}")


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device, as an int for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream
