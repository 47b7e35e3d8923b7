"""PyTorch port, the server front door: ``serve/server.py`` with its slots,
serial bridge, status page and client, against the JAX package's.

The parity case drives one script through the JAX ``ControlServer`` over
a JAX ``StreamPool(engine="fast", capacity=2)`` and through the port's
over the port's pool on the CPU: controller turns from a
``FakeController`` and ``set`` frames from a WebSocket client, each
answered by its broadcast before the next is sent, then render-loop
masters.  The broadcasts must be equal in order and content, each slot's
controls equal, and the masters >= 60 dB apart at most (the bound of
``tests/test_torch_pool.py``: the JAX step is one jitted graph, whose
fused arithmetic rounds otherwise than the port's eager form).

The server-only cases of ``tests/test_serve.py`` follow, run against the
port.  Every pool is built with ``device="cpu"``; every WebSocket server
is up for under 2 s.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import websockets

from tests.util import snr_db, tone

from bauklank_tpu.serve import serial as jserial
from bauklank_tpu.serve import server as jserver
from bauklank_tpu.serve import slots as jslots
from bauklank_tpu.serve import statuspage as jstatuspage
from bauklank_tpu.serve.pool import StreamPool as JStreamPool
from bauklank_tpu_torch.engine.config import StretchConfig
from bauklank_tpu_torch.serve import serial, server, slots, statuspage
from bauklank_tpu_torch.serve.client import ControlClient
from bauklank_tpu_torch.serve.pool import StreamPool
from bauklank_tpu_torch.serve.serial import FakeController
from bauklank_tpu_torch.serve.server import ControlServer

SR = 44100.0
N_MASTERS = 6
TURNS = [("A", "rate", 0.25), ("B", "tone", 3), ("A", "volume", 40.4), ("B", "rate", "0.75")]
WS_SETS = [
    {"type": "set", "channel": "A", "key": "tone", "value": -7},
    {"type": "set", "channel": "B", "key": "pan", "value": -0.5},
    {"type": "set", "channel": "A", "key": "rate", "value": float("nan")},  # dropped
    {"type": "set", "engine": "B", "channel": "A", "key": "volume", "value": 55},
    {"type": "set", "channel": "A", "key": "formantSemitones", "value": 0.0},
]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _connect(port: int, seconds: float = 10.0):
    """A WebSocket client of the server on ``port``, once it listens: the
    server binds its port some time after its task starts, later on a
    loaded machine."""
    deadline = time.monotonic() + seconds
    while True:
        try:
            return await websockets.connect(f"ws://127.0.0.1:{port}")
        except ConnectionRefusedError:
            if time.monotonic() > deadline:
                raise
            await asyncio.sleep(0.05)


async def _end(server, *tasks) -> None:
    server.stop()
    for task in tasks:
        task.cancel()
        try:
            await task
        except (asyncio.CancelledError, Exception):
            pass


async def _next_set(ws) -> dict:
    while True:
        m = json.loads(await asyncio.wait_for(ws.recv(), 3))
        if m["type"] == "set":
            return m


def _load_kiosk(pool) -> None:
    """A at the kiosk's rate 0.001 and -5 st, B at rate 0.5 and +7 st."""
    x = tone(440.0, int(SR), SR)
    pool.load_track("A", [x, x])
    pool.load_track("B", [np.roll(x, 977), x])
    pool.start("A", when=0.0, offset=0.0, rate=0.001, semitones=-5)
    pool.start("B", when=0.0, offset=0.0, rate=0.5, semitones=7)


async def _script(server_mod, serial_mod, pool):
    """The controller turns and the WS sets, one broadcast at a time, then
    ``N_MASTERS`` masters of the render loop."""
    port = _free_port()
    srv = server_mod.ControlServer(pool=pool, engine_slots=["A", "B"], ws_host="127.0.0.1",
                                   ws_port=port, scan_hardware=False, time_push_sec=0)
    fc = serial_mod.FakeController("enc-parity")
    srv.add_transport(fc)
    task = asyncio.create_task(srv.run())
    await asyncio.sleep(0.1)
    sets = []
    try:
        async with await _connect(port) as ws:
            beacons = [json.loads(await asyncio.wait_for(ws.recv(), 2))["type"]
                       for _ in range(3)]
            for ch, key, value in TURNS:
                fc.turn(ch, key, value)
                sets.append(await _next_set(ws))
            for frame in WS_SETS:
                await ws.send(json.dumps(frame))
                if not (isinstance(frame["value"], float) and np.isnan(frame["value"])):
                    sets.append(await _next_set(ws))
            status = srv.controller_status()
            await ws.send(json.dumps({"type": "analyze", "slot": "B"}))
            reply = json.loads(await asyncio.wait_for(ws.recv(), 5))
            while reply["type"] != "analysis":
                reply = json.loads(await asyncio.wait_for(ws.recv(), 5))
    finally:
        await _end(srv, task)
    masters = []
    render = server_mod.ControlServer(pool=pool, engine_slots=["A", "B"],
                                      audio_sink=masters.append, render_ahead_sec=1.0,
                                      scan_hardware=False)
    rtask = asyncio.create_task(render.render_loop_task())
    for _ in range(400):
        if len(masters) >= N_MASTERS:
            break
        await asyncio.sleep(0.02)
    await _end(render, rtask)
    del status["encoders"]  # ages in milliseconds: wall-clock dependent
    analysis = (sorted(reply), reply["slot"], len(reply["spectrum"]), len(reply["scope"]))
    return beacons, sets, status, [np.asarray(m) for m in masters[:N_MASTERS]], analysis


def _controls(pool) -> list:
    return [([dataclasses.asdict(seg) for seg in s.timemap.segments], s.volume, s.pan)
            for s in pool.slots]


def test_server_matches_the_jax_server():
    jpool = JStreamPool(capacity=2, names=["A", "B"], engine="fast", max_track_sec=2.0)
    tpool = StreamPool(capacity=2, names=["A", "B"], engine="fast", max_track_sec=2.0,
                       device="cpu")
    _load_kiosk(jpool)
    _load_kiosk(tpool)
    jpool.step(fetch=True)  # compile outside the server's session
    tpool.step(fetch=True)
    j = asyncio.run(_script(jserver, jserial, jpool))
    t = asyncio.run(_script(server, serial, tpool))
    assert t[0] == j[0] == ["serverVersion", "machineStatus", "controllerStatus"]
    assert t[1] == j[1]
    assert len(t[1]) == len(TURNS) + len(WS_SETS) - 1
    assert t[2] == j[2] and t[2]["connected"] and t[2]["deviceId"] == "enc-parity"
    assert _controls(tpool) == _controls(jpool)
    # the analyze reply: the JAX server's keys and sizes (chip_smoke.py
    # phase 9 holds the card's reply to the same keys)
    import chip_smoke

    assert t[4] == j[4] and t[4][1] == "B"
    assert set(t[4][0]) == chip_smoke.ANALYSIS_KEYS
    assert tpool.slots[1].volume == 0.55 and tpool.slots[0].volume == 0.4
    assert len(t[3]) == len(j[3]) == N_MASTERS
    for jm, tm in zip(j[3], t[3]):
        assert tm.shape == jm.shape == (2, tpool.config.interval)
        assert np.abs(tm).max() > 1e-3
        assert snr_db(jm, tm) >= 60.0


# ------------------------------------------------ the jax-free pieces, equal
def test_slot_allocator_matches_jax():
    def drive(mod):
        a = mod.SlotAllocator(["A", "B"], pinned={"dev2": "B", "dev4": "B"})
        ops = [("assign", "dev1"), ("assign", "dev2"), ("assign", "dev3"), ("assign", "dev1"),
               ("release", "dev1"), ("assign", "dev4"), ("release", "dev2"),
               ("assign", "dev4"), ("release", "nobody")]
        out = [getattr(a, op)(dev) for op, dev in ops]
        return out, a.free_slots(), a.slot_of("dev4")

    assert drive(slots) == drive(jslots)


def test_encoder_liveness_matches_jax():
    def drive(mod):
        lv = mod.EncoderLiveness(["A", "B"], timeout_sec=10.0)
        lv.saw_rate("A", now=100.0)
        lv.saw_rate("B", now=104.5)
        out = [lv.ages_ms(now=t) for t in (101.0, 109.0, 115.0)]
        out += [[lv.online(c, now=t) for c in "AB"] for t in (105.0, 111.0, 115.0)]
        lv.clear()
        return out, lv.ages_ms(now=120.0)

    assert drive(serial) == drive(jserial)


def test_probe_transport_and_session_match_jax():
    def drive(mod):
        fc = mod.FakeController("enc-7", fw="2.0")
        hello = mod.probe_transport(fc)
        got = []
        sess = mod.SerialSession(fc, hello, ["A", "B"], got.append)
        fc.send_garbage()
        fc.turn("A", "rate", "0.25")
        fc.turn("A", "volume", 17.6)
        fc.turn("C", "rate", 1.0)
        fc.turn("B", "tone", -5.4)
        n = sess.pump()
        silent = mod.FakeController("x")
        silent.write = lambda data: None  # answers no whoareyou
        return hello, n, got, dict(sess.counters), mod.probe_transport(silent, attempts=2)

    assert drive(serial) == drive(jserial)


@pytest.mark.parametrize("slot_names", [["A"], ["A", "B"]])
def test_render_page_matches_jax(slot_names):
    assert (statuspage.render_page("0.1.0+gabc", slot_names)
            == jstatuspage.render_page("0.1.0+gabc", slot_names))


# --------------------------------------- the server-only cases, on the port
def _pool(capacity=2, engine="fast"):
    cfg = StretchConfig(channels=2, block=512, interval=128)
    return StreamPool(capacity=capacity, sample_rate=SR, config=cfg, max_track_sec=2.0,
                      names=["A", "B"][:capacity], engine=engine, device="cpu")


def test_server_survives_malformed_frames():
    async def scenario():
        port = _free_port()
        srv = ControlServer(pool=_pool(), engine_slots=["A"], ws_host="127.0.0.1",
                            ws_port=port, scan_hardware=False)
        task = asyncio.create_task(srv.run())
        await asyncio.sleep(0.1)
        try:
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                for _ in range(3):
                    await asyncio.wait_for(ws.recv(), 2)
                for frame in (
                    "not json", "{broken", "[1,2,3]", '{"type": 42}', '{"type":"set"}',
                    '{"type":"set","channel":"Z","key":"rate","value":1}',
                    '{"type":"set","channel":"A","key":7,"value":1}',
                    '{"type":"set","channel":"A","key":"bogus","value":1}',
                ):
                    await ws.send(frame)
                await ws.send(json.dumps({"type": "set", "channel": "A", "key": "rate",
                                          "value": 0.25}))
                while True:
                    m = await _next_set(ws)
                    if m["key"] == "rate":
                        assert m["value"] == 0.25
                        break
                    assert m["key"] == "bogus"  # forwarded; receivers ignore it
            assert srv.pool.slots[0].timemap.segments[-1].rate == 0.25
        finally:
            await _end(srv, task)

    asyncio.run(scenario())


def test_task_supervision_restarts_crashed_task():
    async def scenario():
        srv = ControlServer(engine_slots=["A"])
        calls = []

        async def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("boom")
            srv.stop()

        task = asyncio.create_task(srv._supervise(flaky, "flaky"))
        await asyncio.wait_for(task, 10)
        assert len(calls) == 3  # crashed twice, restarted, then a clean exit

    asyncio.run(scenario())


def test_http_status_surface_and_analyze():
    """'/status' JSON with the engine, '/' the page, 404 elsewhere,
    '/status?analyze=' a voice's analysis, and the WS upgrade on the same
    port."""
    async def scenario():
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)
        for _ in range(4):
            pool.step()
        port = _free_port()
        srv = ControlServer(pool=pool, engine_slots=["A", "B"], ws_host="127.0.0.1",
                            ws_port=port, scan_hardware=False)
        task = asyncio.create_task(srv.run())
        await asyncio.sleep(0.1)

        def get(path):
            return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5).read()

        try:
            payload = json.loads(await asyncio.to_thread(get, "/status"))
            assert payload["server"]["type"] == "serverVersion"
            assert payload["controller"]["connected"] is False
            assert payload["engine"] == "fast" and payload["pool"] is not None
            body = (await asyncio.to_thread(get, "/")).decode()
            assert "bauklank_tpu control plane" in body and '["A", "B"]' in body
            with pytest.raises(urllib.error.HTTPError) as e:
                await asyncio.to_thread(get, "/nope")
            e.value.close()  # an open response would hold the server's shutdown
            assert e.value.code == 404
            http_analysis = json.loads(await asyncio.to_thread(get, "/status?analyze=A"))
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                for _ in range(3):
                    await asyncio.wait_for(ws.recv(), 2)
                await ws.send(json.dumps({"type": "analyze", "slot": "A"}))
                msg = json.loads(await asyncio.wait_for(ws.recv(), 5))
                while msg.get("type") != "analysis":
                    msg = json.loads(await asyncio.wait_for(ws.recv(), 5))
        finally:
            await _end(srv, task)
        assert msg["slot"] == "A" == http_analysis["slot"]
        assert {k: v for k, v in msg.items() if k != "type"} == http_analysis
        assert len(msg["scope"]) > 0 and all(a <= b for a, b in msg["scope"])
        spec = np.asarray(msg["spectrum"])
        peak_hz = int(np.argmax(spec)) * msg["spectrumHzPerBin"]
        assert abs(peak_hz - 440.0) < 2.5 * msg["spectrumHzPerBin"], peak_hz
        assert msg["levels"]["rms"][0] > 0.0

    asyncio.run(scenario())


def test_controller_status_topology_decoration():
    from bauklank_tpu_torch.models import TimePitchTopology

    async def scenario():
        topo = TimePitchTopology({"enc-top": {"A": "enc-time", "B": "enc-pitch"}})
        srv = ControlServer(engine_slots=["A", "B"], topology=topo)
        srv.add_transport(FakeController("enc-top"))
        task = asyncio.create_task(srv.serial_manager_task())
        await asyncio.sleep(0.15)
        st = srv.controller_status()
        await _end(srv, task)
        assert st["connected"] is True
        assert st["encoders"]["channels"]["A"]["deviceId"] == "enc-time"
        assert st["encoders"]["channels"]["B"]["deviceId"] == "enc-pitch"

    asyncio.run(scenario())


def test_hardware_scan_path(monkeypatch):
    """The scan loop probes pyserial-discovered ports (faked here) and skips
    the excluded ones."""
    async def scenario():
        opened = []
        devices = {"/dev/ttyUSB0": FakeController("hw-enc"),
                   "/dev/ttyEXCL": FakeController("nope")}
        monkeypatch.setattr(serial, "list_pyserial_ports",
                            lambda exclude=(): [p for p in devices if p not in set(exclude)])
        monkeypatch.setattr(serial, "open_pyserial",
                            lambda port, baud=115200, timeout=0.5: (opened.append(port),
                                                                    devices[port])[1])
        srv = ControlServer(engine_slots=["A"], serial_exclude=["/dev/ttyEXCL"])
        task = asyncio.create_task(srv.serial_manager_task())
        for _ in range(60):
            if srv.session is not None:
                break
            await asyncio.sleep(0.05)
        await _end(srv, task)
        assert srv.session.hello["deviceId"] == "hw-enc"
        assert "/dev/ttyEXCL" not in opened

    asyncio.run(scenario())


def test_control_client_end_to_end_and_reconnect():
    """ControlClient tracks beacons, dispatches sets, reaches the pool, asks
    for an analysis, and reconnects to a fresh server on the same port."""
    async def scenario():
        port = _free_port()
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)
        for _ in range(2):
            pool.step()
        srv = ControlServer(pool=pool, engine_slots=["A", "B"], ws_host="127.0.0.1",
                            ws_port=port, scan_hardware=False)
        fc = FakeController("enc-cli")
        srv.add_transport(fc)
        stask = asyncio.create_task(srv.run())
        await asyncio.sleep(0.1)
        sets = []
        client = ControlClient(f"ws://127.0.0.1:{port}", ["A", "B"], on_set=sets.append,
                               reconnect="backoff")
        ctask = asyncio.create_task(client.run())
        for _ in range(50):
            if client.server_version and client.controller_status:
                break
            await asyncio.sleep(0.02)
        assert client.machine_status["type"] == "machineStatus"
        fc.turn("A", "rate", 0.5)
        for _ in range(50):
            if sets:
                break
            await asyncio.sleep(0.02)
        assert sets[0]["key"] == "rate" and sets[0]["value"] == 0.5
        await client.send_set("B", "tone", 3)
        for _ in range(50):
            if pool.slots[1].timemap.segments[-1].semitones == 3.0:
                break
            await asyncio.sleep(0.02)
        assert pool.slots[1].timemap.segments[-1].semitones == 3.0
        msg = await client.request_analysis("A")
        assert msg["slot"] == "A" and len(msg["spectrum"]) > 0
        await _end(srv, stask)
        for _ in range(100):
            if not client.connected:
                break
            await asyncio.sleep(0.02)
        assert not client.connected
        srv2 = ControlServer(pool=pool, engine_slots=["A", "B"], ws_host="127.0.0.1",
                             ws_port=port, scan_hardware=False)
        stask2 = asyncio.create_task(srv2.run())
        for _ in range(200):
            if client.connected:
                break
            await asyncio.sleep(0.02)
        assert client.connected
        client.stop()
        await _end(srv2, stask2, ctask)

    asyncio.run(scenario())


def test_time_push_progresses_at_extreme_rate():
    """``{"type": "time"}`` pushes progress at the kiosk's rate 0.001 while
    the render loop steps the pool."""
    async def scenario():
        port = _free_port()
        pool = _pool()
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=0.001)
        pool.step(fetch=True)
        srv = ControlServer(pool=pool, engine_slots=["A", "B"], ws_host="127.0.0.1",
                            ws_port=port, scan_hardware=False, audio_sink=lambda m: None,
                            render_ahead_sec=0.05, time_push_sec=0.05)
        task = asyncio.create_task(srv.run())
        await asyncio.sleep(0.1)
        times = []
        try:
            async with websockets.connect(f"ws://127.0.0.1:{port}") as ws:
                end = asyncio.get_running_loop().time() + 1.5
                while asyncio.get_running_loop().time() < end and len(times) < 8:
                    try:
                        m = json.loads(await asyncio.wait_for(ws.recv(), 0.5))
                    except asyncio.TimeoutError:
                        continue
                    if m.get("type") == "time" and m.get("slot") == "A":
                        assert m["engine"] == "A"
                        times.append(m["inputTime"])
        finally:
            await _end(srv, task)
        assert len(times) >= 3, times
        assert all(b >= a for a, b in zip(times, times[1:])), times
        assert times[-1] > times[0] > 0.0, times
        assert times[-1] < 0.1

    asyncio.run(scenario())


def test_render_loop_steps_off_the_event_loop():
    """A fidelity pool's render loop with a slow sink leaves the event
    loop's ticks short: steps and the sink run in worker threads."""
    import time

    async def scenario():
        pool = _pool(engine="fidelity")
        pool.load_track("A", [tone(440.0, int(SR), SR)] * 2)
        pool.start("A", when=0.0, offset=0.0, rate=1.0)
        pool.step(fetch=True)
        srv = ControlServer(pool=pool, engine_slots=["A", "B"],
                            audio_sink=lambda m: time.sleep(0.4), render_ahead_sec=1.0,
                            scan_hardware=False)
        task = asyncio.create_task(srv.render_loop_task())
        gaps, t_prev = [], time.monotonic()
        end = t_prev + 1.2
        while time.monotonic() < end:
            await asyncio.sleep(0.01)
            now = time.monotonic()
            gaps.append(now - t_prev)
            t_prev = now
        await _end(srv, task)
        assert pool.out_pos > pool.config.interval
        assert max(gaps) < 0.3, max(gaps)

    asyncio.run(scenario())
