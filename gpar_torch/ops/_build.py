"""Build and load the hand-written CUDA kernels of gpar_torch.

Each source under ``gpar_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
through ``ctypes``.  The build happens on first use, into ``build/gpar_torch/``
beside the package (git-ignored); a library's file name carries a hash of
its source and flags, so an edited source is rebuilt and a cached one is
reused.

Nothing here runs at import: the CPU tests import every module, and this
host needs no CUDA toolkit to do so.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["SOURCES", "build", "load_library", "build_dir", "build_info"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"

#: Library name -> source file under ``csrc/``.
SOURCES = {"gram": "gram.cu"}

NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_libs = {}
#: Library name -> {"seconds": build wall-clock (0 when cached),
#: "log": nvcc's output (ptxas register/shared-memory report), "path": ...}.
build_info = {}


def build_dir():
    return _PKG.parent / "build" / "gpar_torch"


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "gpar_torch: nvcc not found (looked in $CUDA_HOME/bin and PATH); "
            "the CUDA kernels cannot be built."
        )
    return found


def build(name="gram"):
    """Compile library ``name`` unless it is cached; returns its
    ``build_info`` entry.  Raises on a failed compile with the compiler's
    output."""
    src = _CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return build_info.setdefault(name, {"seconds": 0.0, "log": "", "path": str(lib)})
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"gpar_torch: nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, lib)
    build_info[name] = {"seconds": time.perf_counter() - t0, "log": proc.stdout, "path": str(lib)}
    return build_info[name]


def _declare(lib):
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    for fn in ("gpar_gram_f32", "gpar_gram_f64"):
        f = getattr(lib, fn)
        f.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, cl, cl, cl, ci, ip, ip, ip, vp]
        f.restype = ci
    for fn in ("gpar_gram_bwd_f32", "gpar_gram_bwd_f64"):
        f = getattr(lib, fn)
        f.argtypes = [vp] * 10 + [ci, ci, ci, ci, cl, cl, cl, ci, ip, ip, ip, ci, ci, ci, ci, vp]
        f.restype = ci
    lib.gpar_gram_max_terms.argtypes = []
    lib.gpar_gram_max_terms.restype = ci
    lib.gpar_gram_init.argtypes = []
    lib.gpar_gram_init.restype = ci
    lib.gpar_cuda_error_string.argtypes = [ci]
    lib.gpar_cuda_error_string.restype = ctypes.c_char_p


def load_library(name="gram"):
    """The loaded ``ctypes`` library ``name``, building it on first use.
    Checks that the library's term limit is the wrapper's ``MAX_TERMS`` and
    makes the backward kernel's opt-in to more than 48 KB of shared memory
    (``gpar_gram_init``), so that no launch sets a function attribute."""
    lib = _libs.get(name)
    if lib is None:
        from .gram_kernel import MAX_TERMS

        lib = ctypes.CDLL(build(name)["path"])
        _declare(lib)
        if lib.gpar_gram_max_terms() != MAX_TERMS:
            raise RuntimeError(
                f"gpar_torch: {SOURCES[name]} takes {lib.gpar_gram_max_terms()} "
                f"terms per launch, the wrapper assumes {MAX_TERMS}"
            )
        rc = lib.gpar_gram_init()
        if rc != 0:
            raise RuntimeError(f"gpar_torch: gpar_gram_init failed ({rc}): "
                               f"{lib.gpar_cuda_error_string(rc).decode()}")
        _libs[name] = lib
    return lib
