"""PyTorch port, package rules: no JAX anywhere in it, no kernel launch
from a CPU call, and wrappers that refuse what their kernel does not take."""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest

import torch

import bauklank_tpu_torch
from bauklank_tpu_torch import kernels
from bauklank_tpu_torch.engine import fidelity, spectral
from bauklank_tpu_torch.kernels import build
from bauklank_tpu_torch.kernels.bandchain import band_chain
from bauklank_tpu_torch.kernels.compsum import comp_cumsum
from bauklank_tpu_torch.kernels.frames import frames_windowed
from bauklank_tpu_torch.kernels.gather import frac_gather
from bauklank_tpu_torch.ops import mdft

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = pathlib.Path(bauklank_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "bauklank_tpu")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_kernel_sources_and_flags():
    names = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert names == ["bandchain.cu", "compsum.cu", "frac_gather.cu", "frames.cu"]
    for p in (PKG / "csrc").glob("*.cu"):
        head = p.read_text()[:2000]
        assert "Replaces the TPU kernel bauklank_tpu/ops/pallas/" in head, p.name
        assert "What bounds it on the H100" in head, p.name
        assert "Design:" in head, p.name
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.SIGNATURES) == {f"bk_{k}" for k in kernels.LAUNCHES}


def _step():
    cfg = fidelity.SpectralConfig(2, 1024, 256)
    state = fidelity.init_batched_fidelity_state(cfg, 2, "cpu")
    audio = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 2, 8000)).astype(np.float32))
    ends = torch.tensor([[2000, 2300], [3000, 3100]])
    one = torch.ones(2)
    _, emit = fidelity.batched_fidelity_chunk(
        cfg, state, audio, ends, one, torch.tensor([1.0, 1.5]), one * 0.1, one)
    return emit


def test_cpu_step_launches_no_kernel():
    kernels.reset_launches()
    emit = _step()
    assert emit.shape == (2, 2, 512) and torch.isfinite(emit).all()
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_step_builds_its_constant_tables_once():
    """The window, rotations, MDFT twiddles and MINSTD powers go to the
    device once per geometry and device, not on every step (a blocking
    host-to-device copy would wait for the whole stream)."""
    caches = (fidelity._consts, mdft._twiddles, spectral._rotation, spectral._minstd_tables)
    _step()
    misses = [c.cache_info().misses for c in caches]
    _step()
    assert [c.cache_info().misses for c in caches] == misses


def test_wrappers_refuse_bad_operands():
    f32 = torch.zeros
    with pytest.raises(ValueError, match="float32"):
        frames_windowed(f32(1, 2, 10, dtype=torch.float64), f32(1, 3, dtype=torch.int32), f32(4))
    with pytest.raises(ValueError, match="int32"):
        frames_windowed(f32(1, 2, 10), f32(1, 3, dtype=torch.int64), f32(4))
    with pytest.raises(ValueError, match="expects"):
        frames_windowed(f32(2, 10), f32(1, 3, dtype=torch.int32), f32(4))
    with pytest.raises(ValueError, match="disagree"):
        frames_windowed(f32(2, 2, 10), f32(1, 3, dtype=torch.int32), f32(4))
    with pytest.raises(ValueError, match="float32"):
        comp_cumsum(f32(3, 8, 4, dtype=torch.float16))
    with pytest.raises(ValueError, match="expects"):
        comp_cumsum(f32(8, 4))
    with pytest.raises(ValueError, match="float32"):
        frac_gather(f32(2, 8, 4), f32(2, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="disagree"):
        frac_gather(f32(2, 8, 4), f32(3, 5))
    with pytest.raises(ValueError, match="expects"):
        band_chain(f32(8, 16, 4), f32(2, 6, 16, 4), 2)
    with pytest.raises(ValueError, match="matching"):
        band_chain(f32(9, 16, 4), f32(2, 6, 15, 4), 2)
    with pytest.raises(ValueError, match="long_step"):
        band_chain(f32(9, 16, 4), f32(2, 6, 16, 4), 17)
    with pytest.raises(ValueError, match="long_step"):
        band_chain(f32(9, 16, 4), f32(2, 6, 16, 4), 0)
    with pytest.raises(ValueError, match="device"):
        frac_gather(f32(2, 8, 4), f32(2, 5, device="meta"))


def test_nvcc_lookup_fails_loudly_without_a_toolchain(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            build.find_nvcc()
    else:
        assert build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
