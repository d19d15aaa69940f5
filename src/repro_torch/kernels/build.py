"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each source in ``csrc/`` compiles, at first use, into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). All stale sources compile at once, one ``nvcc`` process each.
Libraries land in ``kernels/build/`` (git-ignored) under a name that
hashes the source and the flags, so an edited source never loads an old
binary.

Wrappers call :func:`launch`, which passes raw device pointers and the
current PyTorch stream, raises on a non-zero ``cudaGetLastError()`` and
counts the launch in :data:`launch_counts`.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("fused_adam", "onebit")

# -fmad=false: no FMA contraction beyond the __fmaf_rn written in the
# sources (the fused step's bit parity depends on it); never fast-math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I64, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
# C entry point -> (source, argtypes); every entry point returns int
_ENTRY_POINTS = {
    "fused_local_step_f32": ("fused_adam",
                             [_P] * 5 + [_I64] + [_F32] * 4 + [_P]),
    "fused_local_step_sgd_f32": ("fused_adam",
                                 [_P] * 4 + [_I64] + [_F32] * 3 + [_P]),
    "abs_rowsum_f32": ("onebit", [_P] * 6 + [_I64] * 5 + [_P]),
    "ef_quantize_f32": ("onebit", [_P] * 6 + [_I64] * 6 + [_P]),
    "ef_compress_f32": ("onebit", [_P] * 6 + [_I64] * 5 + [_P]),
    "decompress_f32": ("onebit", [_P] * 3 + [_I64] * 4 + [_P]),
}

# kernel name -> number of launches; chip_smoke.py clears it before the
# main-path run and reads it after
launch_counts: collections.Counter = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only where the CUDA toolkit is")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every stale source, all in parallel; returns name -> .so.

    ptxas's register/spill report of each fresh build is kept in
    :data:`build_logs`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    stale = [n for n, p in paths.items() if not p.exists()]
    procs = {}
    for name in stale:
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _library(source: str) -> ctypes.CDLL:
    if source not in _libs:
        path = build_all()[source]
        lib = ctypes.CDLL(str(path))
        for fn, (src, argtypes) in _ENTRY_POINTS.items():
            if src == source:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[source] = lib
    return _libs[source]


def current_raw_stream(card: int) -> int:
    """The current stream of ``card`` as a raw pointer. torch's private
    getter skips the Stream object that torch.cuda.current_stream() builds
    (several microseconds of host time a launch, PERF.md); where a torch
    lacks it, the public call gives the same stream."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(card).cuda_stream
    return raw(card)


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream; raise
    if the launch was refused, else count it under ``kernel``."""
    fn = getattr(_library(_ENTRY_POINTS[entry][0]), entry)
    current = torch.cuda.current_device()
    card = current if device.index is None else device.index
    stream = current_raw_stream(card)
    if card == current:          # the launch goes to the current card
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(card):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc} "
                           f"(cudaGetLastError)")
    launch_counts[kernel] += 1


def check_operand(kernel: str, name: str, t: torch.Tensor, dtype, shape,
                  device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what the C entry points assume)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{kernel}: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"{kernel}: {name} has dtype {t.dtype}, expected "
                        f"{dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def on_card(kernel: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (use the plain version) and for a ``meta`` one (the plain version
    then only derives shapes and dtypes: the audit's declared manifests);
    any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{kernel}: no kernel or plain version for device "
                     f"{t.device}")
