"""Build and bind the hand-written Hopper kernels in ``../csrc``.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build runs at first use,
into ``chestxray_vit_tpu_torch/_build/`` (git-ignored), under a file name
keyed by a hash of the sources (``*.cu`` and the ``*.cuh`` they include)
and flags, so an edited source rebuilds and an unchanged one loads the
cached library. ``CXR_NVCC_FLAGS`` in the environment adds flags (for a
measurement build such as ``-DCXR_NO_TILE_SKIP``; see ``csrc/common.cuh``).

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc`` and no card. A missing ``nvcc`` or a
failed build raises; there is no fallback.
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
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# C signatures of the entry points (see the ``extern "C"`` functions in
# csrc/). Pointers and the stream are c_void_p so that ctypes does not cut
# them to 32 bits.
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_U = ctypes.c_uint32
_SIGNATURES = {
    "cxr_attention_fwd_inf": [_P, _P, _P, _P, _I, _I, _I, _I,
                              _LL, _LL, _LL, _LL, _LL, _LL,
                              _LL, _LL, _LL, _LL, _LL, _LL,
                              _F, _I, _I, _P],
    "cxr_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _LL, _LL, _LL, _LL, _LL, _LL,
                          _LL, _LL, _LL, _LL, _LL, _LL,
                          _F, _I, _I, _P],
    "cxr_attention_fwd_dropout": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _LL, _LL, _LL, _LL, _LL, _LL,
                                  _LL, _LL, _LL, _LL, _LL, _LL,
                                  _F, _U, _U, _I, _I, _U, _I, _I, _F,
                                  _I, _I, _P],
    "cxr_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _P, _F, _I, _I, _P],
    "cxr_attention_bwd_dropout": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _P, _F, _U, _U, _I, _I,
                                  _U, _I, _I, _F, _I, _I, _P],
    "cxr_attention_fwd_seg": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _LL, _LL, _LL, _LL, _LL, _LL,
                              _LL, _LL, _LL, _LL, _LL, _LL,
                              _F, _I, _I, _P],
    "cxr_attention_fwd_seg_dropout": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                      _I, _LL, _LL, _LL, _LL, _LL, _LL,
                                      _LL, _LL, _LL, _LL, _LL, _LL,
                                      _F, _U, _U, _I, _I, _U, _I, _I, _F,
                                      _I, _I, _P],
    "cxr_attention_bwd_seg": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _P, _F, _I, _I, _P],
    "cxr_attention_bwd_seg_dropout": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _P, _P, _I, _I, _I, _I, _P, _F, _U,
                                      _U, _I, _I, _U, _I, _I, _F, _I, _I,
                                      _P],
    "cxr_layer_norm_fwd": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _P],
    "cxr_layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _LL, _I, _F, _I,
                           _I, _I, _I, _P],
    "cxr_layer_norm_bwd_wave": [_I, _I, _I, _I, _P],
    "cxr_int8_matmul_fused": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _P],
    "cxr_tile_mma_selftest": [_P, _P, _P, _I, _I, _I, _P],
    "cxr_hidden_dropout": [_P, _P, _LL, _LL, _U, _U, _U, _F, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds from the start of this process's last build to the end of each
# source's nvcc (they run at once: the largest is the build's critical
# path), the slowest first; empty where the library was found built
BUILD_SECONDS: dict = {}


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list:
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of chestxray_vit_tpu_torch cannot be built")


def _flags() -> tuple:
    return (*NVCC_FLAGS, *os.environ.get("CXR_NVCC_FLAGS", "").split())


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcxr_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the keyed library unless it exists already:
    one ``nvcc -c`` per source, all running at once, then one link. The
    compilers' output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) and each source's seconds (``BUILD_SECONDS``) are kept
    beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *_flags(), "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = {}

    def finish(src, p):
        text, _ = p.communicate()
        logs[src.name] = (text, time.perf_counter() - t0)

    waiters = [threading.Thread(target=finish, args=pair)
               for pair in zip(_sources(), procs)]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    BUILD_SECONDS.clear()
    BUILD_SECONDS.update((name, round(s, 1)) for name, (_, s) in
                         sorted(logs.items(), key=lambda kv: -kv[1][1]))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    failed = [src.name for src, p in zip(_sources(), procs) if p.returncode]
    report = "".join(f"== {name} ({logs[name][1]:.1f} s)\n{logs[name][0]}"
                     for name in sorted(logs))
    if not failed:
        link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        report += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode:
            failed = ["link"]
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(report)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{report[-4000:]}")
    os.replace(tmp, out)          # atomic: a reader never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
