"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` into ``lib<name>-<hash>.so`` under ``build/repro_torch/`` at
the repo root (listed in ``.gitignore``); the hash covers the source and
the flags, so an edited source rebuilds and an unchanged one is reused.
Sources build at first use, all missing ones at once (one ``nvcc`` each,
started together).  Every pointer and the stream cross as
``ctypes.c_void_p``; every launch entry returns ``cudaGetLastError()``.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "library", "check", "launch_device"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> {C symbol: (argtypes, restype)}
_SIGNATURES = {
    "serve_path": {
        "fused_serve_pool": ([_P] * 11 + [_I] * 8 + [_P], _I),
        "serve_path_error_string": ([_I], ctypes.c_char_p),
    },
    "dot_interaction": {
        "dot_interaction": ([_P, _P, _I, _I, _I, _I, _P], _I),
        "dot_interaction_error_string": ([_I], ctypes.c_char_p),
    },
    "qr_gather": {
        "qr_gather": ([_P] * 5 + [_I] * 4 + [_P], _I),
        "qr_gather_quant": ([_P] * 9 + [_I] * 3 + [_P], _I),
        "qr_gather_error_string": ([_I], ctypes.c_char_p),
    },
    "embedding_bag": {
        "qr_embedding_bag": ([_P] * 6 + [_I] * 5 + [_P], _I),
        "embedding_bag_error_string": ([_I], ctypes.c_char_p),
    },
}
SOURCES = tuple(_SIGNATURES)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (PATH, CUDA_HOME or /usr/local/cuda)")


def _target(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` whose library is missing, all
    ``nvcc`` processes at once; returns each build's compiler output
    (``-Xptxas -v`` register and shared-memory report), empty for a
    library that was already built.  Raises on any failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc() if any(not _target(n).exists() for n in names) else None
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, target)
    logs = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent build of the same source sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed,
    with ``argtypes``/``restype`` declared for every entry."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for sym, (argtypes, restype) in _SIGNATURES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded[name] = lib
        return lib


def check(name: str, code: int, what: str) -> None:
    """Raise when a launch entry returned a CUDA error code."""
    if code != 0:
        msg = getattr(library(name), f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch_device(*tensors):
    """``None`` when every tensor lies on the CPU (the caller takes the
    plain version), else the one CUDA device they all share.  Raises on a
    mix of devices or on a device that is neither."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return None
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"kernel operands must share one CUDA device, got {sorted(map(str, devices))}")
    return next(iter(devices))
