"""PyTorch port, package rules: no JAX anywhere in it, no kernel launch
from a CPU call, constant tables built once, wrappers that refuse what
their kernel does not take, and entry points that run on the card unless
the caller passes ``device="cpu"``."""

from __future__ import annotations

import ast
import pathlib

import numpy as np
import pytest

import torch

import bauklank_tpu_torch
from bauklank_tpu_torch import kernels
from bauklank_tpu_torch.engine import core, fidelity, spectral
from bauklank_tpu_torch.engine.batched import init_batched_state
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.engine.offline import frame_ends_for, stretch_offline
from bauklank_tpu_torch.engine.params import StretchParams
from bauklank_tpu_torch.kernels import build
from bauklank_tpu_torch.kernels.bandchain import band_chain
from bauklank_tpu_torch.kernels.chainfetch import chainfetch
from bauklank_tpu_torch.kernels.compsum import comp_cumsum
from bauklank_tpu_torch.kernels.frames import frames_windowed
from bauklank_tpu_torch.kernels.gather import frac_gather, pallas_gather
from bauklank_tpu_torch.kernels.interp import banded_interp
from bauklank_tpu_torch.ops import mdft
from bauklank_tpu_torch.engine.live import init_live_state
from bauklank_tpu_torch.node import StretchNode
from bauklank_tpu_torch.serve.livepool import LivePool
from bauklank_tpu_torch.serve.pool import StreamPool
from bauklank_tpu_torch.serve.unified import UnifiedPool

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


def test_front_page_exports_what_the_jax_package_exports():
    import bauklank_tpu

    assert sorted(bauklank_tpu_torch.__all__) == sorted(bauklank_tpu.__all__)
    for name in bauklank_tpu_torch.__all__:
        assert getattr(bauklank_tpu_torch, name) is not None


@pytest.mark.parametrize("sub", ["engine", "serve", "models", "runtime", "parallel"])
def test_subpackages_export_what_the_jax_subpackages_export(sub):
    import importlib

    jax_mod = importlib.import_module(f"bauklank_tpu.{sub}")
    mod = importlib.import_module(f"bauklank_tpu_torch.{sub}")
    assert list(mod.__all__) == list(jax_mod.__all__)
    for name in mod.__all__:
        assert getattr(mod, name) is not None


def test_native_sources_are_package_data():
    """Every file a native build reads (the ``.cu`` sources, the headers
    they include, the runtime's C++) matches a package-data glob of
    ``pyproject.toml``, so an installed copy can build its kernels."""
    import tomllib

    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]["bauklank_tpu_torch"]
    shipped = {p for g in globs for p in PKG.glob(g)}
    native = {p for ext in ("*.cu", "*.cuh", "*.cpp", "*.c", "*.h", "*.hpp")
              for p in PKG.rglob(ext) if "_build" not in p.parts}
    assert native and native <= shipped, sorted(map(str, native - shipped))
    for src in native:
        for line in src.read_text().splitlines():
            if line.lstrip().startswith("#include \""):
                header = src.parent / line.split('"')[1]
                assert header in shipped, f"{src.name} includes {header.name}, not shipped"


def test_kernel_sources_and_flags():
    names = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert names == ["bandchain.cu", "chainfetch.cu", "compsum.cu", "frac_gather.cu",
                     "frames.cu", "interp.cu", "smooth.cu"]
    for p in (PKG / "csrc").glob("*.cu"):
        head = p.read_text()[:2000]
        # kernel 8 stands where the JAX package has lax.associative_scan
        assert ("Replaces no TPU kernel" in head if p.name == "smooth.cu" else
                "Replaces the TPU kernel bauklank_tpu/ops/pallas/" in head), p.name
        assert "What bounds it on the H100" in head, p.name
        assert "Design:" in head, p.name
    assert "--fmad=false" in build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    # one C function per kernel, the interleaved-complex entry point of
    # kernel 5, which counts under banded_interp, and the band chain's two
    # card-side checks (its branch-free root against the library's rounding,
    # its step's cycle count), which launch no kernel of any path
    assert set(build.SIGNATURES) == ({f"bk_{k}" for k in kernels.LAUNCHES}
                                     | {"bk_banded_interp_c", "bk_root_ratio_check",
                                        "bk_band_step_cycles"})
    assert set(kernels.LAUNCHES) == {
        "frames_windowed", "comp_cumsum", "frac_gather", "band_chain", "banded_interp",
        "pallas_gather", "chainfetch", "smooth_pair"}
    # the two sequential kernels stage their operands through one header, and
    # neither divides by a run-time value on its walk
    for name in ("bandchain.cu", "compsum.cu"):
        text = (PKG / "csrc" / name).read_text()
        assert '#include "band_stage.cuh"' in text and "bk::stage_rows<" in text
        assert "% long_step" not in text
    # one device function serves kernels 3 and 6; the fused fetch shares its taps
    gather = (PKG / "csrc" / "frac_gather.cu").read_text()
    assert "bk_frac_gather" in gather and "bk_pallas_gather" in gather
    # P known at compile time, P = 1 four bands a thread, and the scalar form
    assert gather.count("__global__") == 3 and "template <int P" in gather
    assert "bauklank_tpu/ops/pallas/selection.py" in gather[:2000]
    for name in ("frac_gather.cu", "chainfetch.cu"):
        text = (PKG / "csrc" / name).read_text()
        assert '#include "frac_tap.cuh"' in text
        # the row movers live in the shared header only
        assert "bk::load_row<" in text or "bk::mix_row<" in text
        assert "void load_row(" not in text and "void store_row(" not in text
    interp = (PKG / "csrc" / "interp.cu").read_text()
    assert "bk_banded_interp(" in interp and "bk_banded_interp_c(" in interp
    assert interp.count("__global__") == 1
    # a shared header is part of the library's hash: editing it rebuilds
    assert PKG / "csrc" / "frac_tap.cuh" in build._headers()


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


def test_cpu_fused_step_launches_no_kernel(monkeypatch):
    """The fused route on CPU tensors takes kernel 7's plain version."""
    monkeypatch.setenv("BAUKLANK_CHAINFETCH", "1")
    routed = []
    fetch = spectral.chainfetch
    monkeypatch.setattr(spectral, "chainfetch", lambda *a: (routed.append(1), fetch(*a))[1])
    kernels.reset_launches()
    emit = _step()
    assert routed == [1] and torch.isfinite(emit).all()
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


def _fast_step():
    """One chunk of the fast engine over two streams, formants on."""
    cfg = StretchConfig(channels=2, block=1024, interval=256)
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(rng.standard_normal((2, 2, 8000)).astype(np.float32))
    ends = torch.from_numpy(np.stack([frame_ends_for(cfg, 0, 4, r) for r in (0.7, 1.4)])
                            .astype(np.int32))
    params = StretchParams.stack([
        StretchParams.make(rate=0.7, semitones=5.0, device="cpu"),
        StretchParams.make(rate=1.4, semitones=-3.0, formant_semitones=2.0, device="cpu")])
    _, emit = core.process_chunk(cfg, init_batched_state(cfg, 2, device="cpu"), audio, ends,
                                 params)
    return emit


def test_cpu_fast_step_launches_no_kernel():
    kernels.reset_launches()
    emit = _fast_step()
    assert emit.shape == (2, 2, 4 * 256) and torch.isfinite(emit).all()
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_fast_step_builds_its_constant_tables_once():
    """The fast engine's window, band centres, centre phase, lobe width and
    MDFT twiddles are built once per geometry and device."""
    caches = (core._window_consts, core._center_phase, core._lobe_alpha, mdft._twiddles)
    _fast_step()
    misses = [c.cache_info().misses for c in caches]
    _fast_step()
    assert [c.cache_info().misses for c in caches] == misses


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """With no CUDA device and no ``device`` given, every entry point
    raises instead of carrying on quietly on the CPU; the meshes too,
    with a process group of one gloo rank to build them on."""
    import datetime

    import torch.distributed as dist

    from bauklank_tpu_torch.parallel import stream_mesh
    from bauklank_tpu_torch.parallel.seqpar import stream_seq_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = StretchConfig(channels=1, block=1024, interval=256)
    audio = np.zeros((1, 4000), np.float32)
    calls = [
        lambda: StreamPool(),
        lambda: StreamPool(capacity=1, max_track_sec=1.0, engine="fidelity"),
        lambda: fidelity.render_fidelity(audio, 44100.0, 2000),
        lambda: stretch_offline(audio, 1.0, cfg),
        lambda: core.init_state(cfg),
        lambda: init_batched_state(cfg, 2),
        lambda: StretchParams.make(),
        lambda: LivePool(capacity=1),
        lambda: UnifiedPool(),
        lambda: StretchNode(),
        lambda: init_live_state(cfg),
    ]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        for call in calls + [lambda: stream_mesh(), lambda: stream_seq_mesh(1, 1)]:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert stream_mesh(device_type="cpu").mesh_dim_names == ("stream",)
    finally:
        dist.destroy_process_group()
    assert StreamPool(capacity=1, max_track_sec=1.0, device="cpu").device.type == "cpu"


def test_banded_interp_refuses_bad_operands():
    f32 = torch.zeros
    with pytest.raises(ValueError, match="multiple of 128"):
        banded_interp(f32(1, 2, 256), f32(1, 100))
    with pytest.raises(ValueError, match="float32"):
        banded_interp(f32(1, 2, 256, dtype=torch.float64), f32(1, 128))
    with pytest.raises(ValueError, match="expects"):
        banded_interp(f32(2, 256), f32(1, 128))
    with pytest.raises(ValueError, match="disagree"):
        banded_interp(f32(2, 2, 256), f32(1, 128))
    with pytest.raises(ValueError, match="device"):
        banded_interp(f32(1, 2, 256), f32(1, 128, device="meta"))


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
    # any long_step >= 1 and any channel count on the CPU, as the Pallas kernel
    assert band_chain(f32(9, 16, 4), f32(9, 6, 16, 4), 40).shape == (9, 2, 16, 4)
    with pytest.raises(ValueError, match="long_step"):
        band_chain(f32(9, 16, 4), f32(2, 6, 16, 4), 0)
    with pytest.raises(ValueError, match="device"):
        frac_gather(f32(2, 8, 4), f32(2, 5, device="meta"))
    with pytest.raises(ValueError, match="pallas_gather: planes and pos disagree"):
        pallas_gather(f32(2, 8, 4), f32(3, 5))
    with pytest.raises(ValueError, match="pallas_gather: .*float32"):
        pallas_gather(f32(2, 8, 4), f32(2, 5, dtype=torch.float64))
    fetch = lambda **kw: chainfetch(*({
        "spec": f32(2, 8, 4), "prev": f32(2, 8, 4), "energy": f32(2, 8, 2), "ib": f32(2, 8),
        "us": f32(2, 8), "ul": f32(2, 8), "step": f32(2), "long_step": 2} | kw).values())
    assert [tuple(x.shape) for x in fetch()] == [(2, 40, 4), (2, 8, 6)]
    with pytest.raises(ValueError, match="float32"):
        fetch(ib=f32(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="disagree"):
        fetch(prev=f32(2, 8, 2))
    with pytest.raises(ValueError, match="disagree"):
        fetch(step=f32(3))
    with pytest.raises(ValueError, match="expects"):
        fetch(energy=f32(2, 8))
    with pytest.raises(ValueError, match="long_step"):
        fetch(long_step=0)
    with pytest.raises(ValueError, match="device"):
        fetch(us=f32(2, 8, device="meta"))


def test_nvcc_lookup_fails_loudly_without_a_toolchain(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if not pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            build.find_nvcc()
    else:
        assert build.find_nvcc() == "/usr/local/cuda/bin/nvcc"
