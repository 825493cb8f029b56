"""Build the CUDA sources in ``ops/csrc`` with nvcc and bind them with ctypes.

Each ``.cu`` file becomes its own shared library with a plain C interface,
built at first use into ``ops/_build/`` (git-ignored) under a name keyed by
a hash of its source and flags, so an edit rebuilds it and a rerun reuses
it. All sources compile in parallel, one nvcc process each. Nothing here
runs at import time: the CPU tests import every module on a host with no
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from kbe_torch.utils.logging import count, span

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"

_COMMON_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                 "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# source -> (extra nvcc flags, {C entry: (argtypes, restype)})
SOURCES = {
    "splat": (["-fmad=false"], {
        "kbe_splat_front": ([_P] * 3 + [_I] * 3 + [_P] * 4, _I),
        "kbe_splat_route": ([_P] * 4 + [_I] * 3 + [_P] * 3, _I),
        "kbe_splat_sum": ([_P] * 5 + [_I] * 4 + [_P] * 2, _I),
        "kbe_splat_grad": ([_P] * 6 + [_I] * 4 + [_P] * 2, _I),
    }),
    "discfill": ([], {
        "kbe_discfill_set_tables": ([_P], _I),
        "kbe_discfill_max_steps": ([], _I),
        "kbe_discfill": ([_P, _P] + [_I] * 8 + [_P, _P, _P], _I),
    }),
    "nms": (["-fmad=false"], {
        "kbe_nms_max_cap": ([], _I),
        "kbe_nms": ([_P, _P, _I, _I, _F, _P, _P], _I),
    }),
    "finish": (["-fmad=false"], {
        "kbe_finish": ([_P, _I, _I, _P, _I, _P, _I, _P, _P] + [_I] * 4
                       + [_P, _P], _I),
    }),
    "pconv": (["-fmad=false"], {
        "kbe_pconv": ([_P, _I, _I, _P, _P] + [_I] * 12 + [_P] * 3, _I),
    }),
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: Dict[str, str] = {}  # source -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of kbe_torch are "
                       "built from source at first use and need the CUDA "
                       "toolkit")


def _target(name: str) -> Path:
    flags, _ = SOURCES[name]
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(_COMMON_FLAGS + flags).encode())
    return _BUILD / f"{name}-{key.hexdigest()[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SOURCES[name][1].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def build_all() -> float:
    """Build (or reuse) every library and load it, in the span
    ``kbe/build``, counting each nvcc build in ``kernel_builds``; returns
    the seconds spent. Raises with nvcc's output if a build fails."""
    t0 = time.perf_counter()
    with _LOCK, span("build"):
        todo = [n for n in SOURCES if n not in _LIBS]
        if not todo:
            return 0.0
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ([_nvcc()] + _COMMON_FLAGS + SOURCES[name][0]
                   + ["-o", str(tmp), str(_CSRC / f"{name}.cu")])
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
            count("kernel_builds", 1)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _LIBS[name] = _bind(name, _target(name))
    return time.perf_counter() - t0


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def check(status: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} failed: CUDA error {status}")
