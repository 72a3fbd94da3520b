"""Device selection and the hand-written CUDA kernel library.

``resolve_device`` is the one place an entry point picks its device: the
card unless the caller asks for the CPU, and an error when the card is
asked for (or defaulted to) but absent — never a quiet CPU run.

``load_kernels`` builds every ``csrc/*.cu`` source with ``nvcc`` for
``sm_90a`` into one shared library per source under ``build/kernels/`` at
the repository root (listed in ``.gitignore``), all compilers started
together, rebuilding a library only when it is missing or older than its
source. The libraries expose plain C entry points that take raw device
pointers and a stream, loaded through ctypes; the build is timed and
logged as set-up.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

from .log import logger

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# the anchor tables' leading arguments: small, its rows, text_words, n, k,
# j0, cmax, pos_base, bm_bases (host int32[16])
_ANCHOR_TABLES = [_P, _LL, _P] + [_I] * 5 + [_P]
# C signatures of the entry points (every pointer and the stream as
# c_void_p, or ctypes would pass them as 32-bit ints)
SIGNATURES = {
    "anchor": {
        "svdss_anchor_batch": _ANCHOR_TABLES + [_P] * 3 + [_I] * 5
                              + [_P] * 8,
        "svdss_anchor_pool": _ANCHOR_TABLES + [_P] * 3 + [_I] * 5
                             + [_P] * 7,
    },
    "anchor_wide": {
        "svdss_anchor_wide": [_P] * 4 + [_I] * 7 + [_P] * 6,
    },
    "jump": {
        "svdss_jump_level": [_P] * 3 + [_I] + [_P] * 2,
    },
    "pingpong": {
        "svdss_pingpong_fm": [_P] * 5 + [_I] * 8 + [_P] * 9,
    },
    "wavefront": {
        "svdss_wavefront_dp": [_P] * 4 + [_I] * 9 + [_P] * 4,
        "svdss_wavefront_scratch_words": [_I],
    },
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
build_info: Dict[str, object] = {}


def resolve_device(device: Optional[str | torch.device] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises when CUDA is wanted but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the device path's plain PyTorch version on the CPU, or "
            "--no-device for the host engines")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale(name: str) -> bool:
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    return (not os.path.exists(lib)
            or os.path.getmtime(os.path.join(CSRC_DIR, f"{name}.cu"))
            > os.path.getmtime(lib))


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Build (when stale) and load every kernel library; returns
    {source name: CDLL}. Raises with nvcc's output if a build fails."""
    with _LOCK:
        if _LIBS:
            return _LIBS
        os.makedirs(BUILD_DIR, exist_ok=True)
        todo = [n for n in SIGNATURES if _stale(n)]
        t0 = time.time()
        if todo:
            nvcc = _nvcc()
            procs = {}
            for name in todo:
                out = os.path.join(BUILD_DIR, f"lib{name}.so.tmp{os.getpid()}")
                procs[name] = (out, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", out,
                     os.path.join(CSRC_DIR, f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            logs, failed = {}, []
            for name, (out, proc) in procs.items():
                logs[name] = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(name)
                else:
                    os.replace(out, os.path.join(BUILD_DIR, f"lib{name}.so"))
            if failed:
                raise RuntimeError("nvcc failed for " + ", ".join(
                    f"{n}.cu:\n{logs[n]}" for n in failed))
            build_info["ptxas"] = logs
        build_info["built"] = todo
        build_info["seconds"] = time.time() - t0
        logger.info("kernels: %s in %.1fs (%s)",
                    "built " + ", ".join(todo) if todo else "up to date",
                    build_info["seconds"], BUILD_DIR)
        for name, funcs in SIGNATURES.items():
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            for fn, argtypes in funcs.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return _LIBS


def check_launch(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
