"""Build the native runtime shared library (g++, cached by source hash).

Copied from ``bauklank_tpu/runtime/build.py``; the library goes to the
package's ``_build/`` beside the CUDA kernels' (listed in ``.gitignore``)
and is written under a temporary name first, so a second process that
finds it there never loads a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess

__all__ = ["build", "lib_path"]

_SRC = pathlib.Path(__file__).with_name("wavio.cpp")
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"


def lib_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libbauklank_rt_{digest}.so"


def build(verbose: bool = False) -> pathlib.Path | None:
    """Compile if needed; returns the .so path or None when no toolchain."""
    out = lib_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        if verbose:
            print(res.stderr)
        return None
    os.replace(tmp, out)
    return out
