"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files (with the ``*.cuh`` headers they share) compile
with ``nvcc`` into ONE shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so the build takes seconds).  The build runs at first use, reads only the
package's own sources, and writes to ``bauklank_tpu_torch/_build/``
(listed in ``.gitignore``).  The library's file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused.

``--fmad=false`` is deliberate: every kernel has an exactness contract
against its plain PyTorch version, and contracting a multiply and an add
into one FMA changes the rounding.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["NVCC_FLAGS", "build_dir", "find_nvcc", "build", "library", "check"]

PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures: every function returns cudaGetLastError() as an int and
# takes the CUDA stream as its last argument
SIGNATURES = {
    "bk_frames_windowed": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "bk_comp_cumsum": (_P, _P, _P, _I, _I, _I, _P),
    "bk_frac_gather": (_P, _P, _P, _I, _I, _I, _I, _P),
    "bk_pallas_gather": (_P, _P, _P, _I, _I, _I, _I, _P),
    "bk_chainfetch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "bk_band_chain": (_P, _P, _P, _I, _I, _I, _I, _P),
    "bk_banded_interp": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_dir() -> pathlib.Path:
    return PKG / "_build"


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _headers() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cuh"))


def build() -> pathlib.Path:
    """Compile the kernels (if this source set is not built yet) and return
    the library's path.  The compiler's output, including ``ptxas``'s
    register and spill report, is kept beside it as ``.log``."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + _headers():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = build_dir() / f"libbauklank_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = out.with_suffix(".log")
    log.write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error (refused or invalid)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
