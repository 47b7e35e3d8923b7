"""The port's server on the card.  Marked ``cuda``: each test skips unless
a CUDA device and ``nvcc`` are present.

A ``ControlServer``'s render loop steps its pool in worker threads
(``asyncio.to_thread``); its masters must equal, bit for bit, those of a
twin pool stepped directly in the test's thread.  ``analyze`` runs in
other worker threads while steps run: every analysis it returns must be
that of a finished step (equal to the twin's analysis after one of its
steps), and every worker thread must see the device's one default
stream.  The pools (of either engine) replay their step graphs
(``serve/graphs.py``) after the first step, and the served masters equal
those of the eager chain too.  The proof at the serving size is
``chip_smoke.py`` phase 9.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json

import numpy as np
import pytest
import torch

from bauklank_tpu_torch import kernels
from bauklank_tpu_torch.kernels import build
from bauklank_tpu_torch.serve.pool import StreamPool
from bauklank_tpu_torch.serve.server import ControlServer
# tests/util.py, imported by its directory: an installed package named
# ``tests`` would hide ``tests.util``
from util import without_graphs

pytestmark = pytest.mark.cuda

SR = 44100.0
STEPS = 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("no nvcc")
    return torch.device("cuda")


def _tone(freq: float, n: int) -> np.ndarray:
    return np.sin(2 * np.pi * freq / SR * np.arange(n) + 0.3).astype(np.float32)


def _pool(dev, engine="fidelity") -> StreamPool:
    pool = StreamPool(capacity=2, names=["A", "B"], engine=engine, max_track_sec=4.0,
                      device=dev)
    x = _tone(440.0, int(3 * SR))
    pool.load_track("A", [x, x])
    pool.load_track("B", [np.roll(x, 977), x])
    pool.start("A", when=0.0, offset=0.0, rate=0.001, semitones=-5)
    pool.start("B", when=0.0, offset=0.0, rate=0.5, semitones=7)
    return pool


def _render(served) -> list:
    """At least ``STEPS`` masters of a ``ControlServer``'s render loop
    over ``served``."""
    masters = []

    async def scenario():
        srv = ControlServer(pool=served, engine_slots=["A", "B"], audio_sink=masters.append,
                            render_ahead_sec=10.0, scan_hardware=False)
        task = asyncio.create_task(srv.render_loop_task())
        for _ in range(1500):
            if len(masters) >= STEPS:
                break
            await asyncio.sleep(0.02)
        srv.stop()
        await asyncio.wait_for(task, 30)

    asyncio.run(scenario())
    assert len(masters) >= STEPS
    return masters


def test_render_loop_masters_equal_a_direct_pool(dev):
    twin = _pool(dev)
    direct = [twin.step(fetch=True)[0] for _ in range(STEPS)]
    kernels.reset_launches()
    masters = _render(_pool(dev))
    for want, got in zip(direct, masters):
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)
    # the first hops are silent (the engine's output latency), not all of them
    assert np.abs(np.concatenate(masters[:STEPS], axis=1)).max() > 0
    for k in ("frames_windowed", "smooth_pair", "comp_cumsum", "frac_gather", "band_chain"):
        assert kernels.LAUNCHES[k] > 0, k


@pytest.mark.parametrize("engine", ["fidelity", "fast"])
def test_render_loop_with_graphs_equals_the_eager_step(dev, engine):
    """The served pool replays its step graphs from the loop's worker
    threads; its masters equal those of a twin without graphs, stepped in
    this thread."""
    twin = without_graphs(_pool(dev, engine))
    direct = [twin.step(fetch=True)[0] for _ in range(STEPS)]
    served = _pool(dev, engine)
    masters = _render(served)
    m = served.metrics()
    assert m["graph_captures"] == 1 and m["graph_replays"] == m["steps"] - 1 >= STEPS - 1
    for want, got in zip(direct, masters):
        np.testing.assert_array_equal(got, want)


def test_concurrent_analyze_reads_a_finished_step(dev):
    twin = _pool(dev)
    finished = []
    for _ in range(STEPS):
        twin.step(fetch=True)
        finished.append(json.dumps(twin.analyze("B"), sort_keys=True))
    pool = _pool(dev)
    srv = ControlServer(pool=pool, engine_slots=["A", "B"], scan_hardware=False)
    main_stream = torch.cuda.current_stream(dev).cuda_stream
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        streams = list(ex.map(lambda _: torch.cuda.current_stream(dev).cuda_stream, range(8)))
        steps = [ex.submit(srv._locked_step) for _ in range(STEPS)]
        reads = [ex.submit(srv._locked_analyze, "B") for _ in range(4 * STEPS)]
        for f in steps:
            f.result(timeout=120)
        seen = [r.result(timeout=120) for r in reads]
    assert set(streams) == {main_stream}
    assert pool.metrics()["graph_replays"] == STEPS - 1
    got = [json.dumps(a, sort_keys=True) for a in seen if a is not None]
    assert got, "no analysis ran after a step"
    for a in got:
        assert a in finished
