"""asyncio WebSocket control-plane server.

Port of ``bauklank_tpu/serve/server.py``: the same server over the
port's pools, so the system's front door runs on the card.  The module's
structure and its task set are the JAX module's, unchanged.  What differs:
the pools are the port's :class:`~bauklank_tpu_torch.serve.pool.StreamPool`
and :class:`~bauklank_tpu_torch.serve.unified.UnifiedPool`, and the
command line takes ``--device`` (default ``cuda``), the port's form of
``JAX_PLATFORMS``: every pool is made on that device, and without a card
and without ``--device cpu`` :func:`build_server` raises before any port
is bound.  ``--pool-capacity 0`` (control plane only) touches no device.

The equivalent of the reference's serial<->WebSocket bridge (reference:
server-multi.py): one asyncio process running

- a WebSocket JSON hub broadcasting ``serverVersion`` / ``machineStatus`` /
  ``controllerStatus`` / ``set`` to every client, with dead-socket reaping
  (reference :441-455) and on-connect status beacons (:474-485);
- a controller-scan task that probes transports every 2 s with the
  whoareyou/hello handshake (:888-915), detaching on read errors
  (:863-885).  Unlike the deployed reference (one controller max), N
  controllers attach CONCURRENTLY — the semantics of the reference's
  shelved multi-controller server (server-multi-for-2-controllers_OLD.py:
  468-495, 642-698): pinned device->slot mapping first, then first-free
  slot, conflict detection, per-controller line pumps, detach/reattach
  preserving assignments via the pin map;
- encoder-liveness and machine-status refresh tasks (:458-471, :680-719)
  and a 60 s heartbeat log line (:664-677).

One deliberate difference: the reference browser runs the DSP, so its
server only forwards control messages.  Here the server *owns* a pool —
every ``set`` is both broadcast to UI clients and applied to the batched
voices on the device, and WS clients may send ``set`` messages themselves
(the reference only logs inbound frames, :488-489).

Pool steps, ``apply_set``, ``analyze`` and the playback-time reads run in
worker threads (``asyncio.to_thread``) under one lock.  Those threads set
no CUDA stream, so every one of them queues its work on the device's
default stream, in the order the lock admits them; a step's master is
copied to the host (which waits for its kernels) before the lock is
released.

Log style follows the reference's greppable taxonomy (🔎 scan, 🧪 probe,
📟 serial, 💓 heartbeat, 📡 status) with HH:MM:SS.mmm timestamps and a
startup-vs-run log-level switch (:186-209, :927-947).

``/status`` and the heartbeat publish the pool's ``metrics()``: beside
the rolling step p50/p99 and aggregate real-time factor, counters since
the pool was built.  ``steps``; ``late``, steps that took longer than
the audio they render (hops x interval / sample rate: an underrun where
the output plays as it renders); ``minstd_steps``, fidelity steps with a
voice past time factor 2 (rate under 0.5: the MINSTD regime, slower);
``formant_steps``, steps that ran the formant chain; ``audio_uploads``,
copies of every track to the card (one after each batch of track
changes); ``table_builds``, constant tables built in the whole process,
which should stop rising after a pool's first steps; ``graph_captures``
and ``graph_replays``, a pool's step graphs on the card (either engine)
captured and replayed (``serve/graphs.py``).  A ``UnifiedPool``
reports its own quanta's ``steps`` and ``late``, its ``buckets``, their
counters summed under ``bucket_counters``, and ``table_builds``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import math
import threading
import time
from typing import Iterable

from bauklank_tpu_torch.engine.config import block_interval
from bauklank_tpu_torch.serve import protocol
from bauklank_tpu_torch.serve.pool import StreamPool
from bauklank_tpu_torch.serve.serial import (
    EncoderLiveness,
    SerialSession,
    Transport,
    probe_transport,
)
from bauklank_tpu_torch.serve.slots import SlotAllocator
from bauklank_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["ControlServer", "build_parser", "build_server", "main"]

log = logging.getLogger("bauklank.serve")

SERIAL_SCAN_SEC = 2.0       # reference: server-multi.py:83
MACHINE_STATUS_SEC = 5.0    # :471
HEARTBEAT_SEC = 60.0        # :171
ENCODER_REFRESH_SEC = 5.0   # :698


def _setup_logging(level: str) -> None:
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s.%(msecs)03d | %(levelname)s | %(message)s",
        datefmt="%H:%M:%S",
        force=True,
    )


class ControlServer:
    def __init__(
        self,
        pool: StreamPool | None = None,
        engine_slots: list[str] | None = None,
        transports: Iterable[Transport] | None = None,
        ws_host: str = "0.0.0.0",
        ws_port: int = 8765,  # reference: server-multi.py:80
        audio_sink=None,
        render_ahead_sec: float = 0.25,
        serial_log: str = "digest",  # "full" | "digest" (reference :163-168)
        topology=None,
        serial_exclude: Iterable[str] = (),
        scan_hardware: bool = True,
        controller_mode: str = "channel",
        pinned_slots: dict[str, str] | None = None,
        max_controllers: int | None = None,
        time_push_sec: float = 0.2,
    ) -> None:
        # controller_mode:
        #   "channel" — the deployed reference semantics: ONE controller
        #     whose serial `channel` field addresses the engine slots
        #     directly (server-multi.py: CONTROLLER drives channels A+B).
        #   "slot" — the shelved N-controller semantics: each attached
        #     controller is allocated ONE engine slot (pinned_slots mapping
        #     first — the reference's DEVICE_ID_TO_ENGINE — then first
        #     free); all its messages route to that slot
        #     (server-multi-for-2-controllers_OLD.py:468-495,642-698).
        if controller_mode not in ("channel", "slot"):
            raise ValueError(f"unknown controller_mode {controller_mode!r}")
        self.controller_mode = controller_mode
        if max_controllers is None:
            max_controllers = 1 if controller_mode == "channel" else len(engine_slots or ["A"])
        self.max_controllers = max_controllers
        # hardware scan: when no in-memory transports are registered and
        # pyserial is available, candidate ports are probed every scan tick
        # (reference: server-multi.py:581-583, 888-915 with
        # SERIAL_PORT_EXCLUDE at :90-93)
        self.serial_exclude = set(serial_exclude)
        self.scan_hardware = scan_hardware
        self.serial_log = serial_log
        self._digest_last = 0.0
        self._digest_base: dict[str, int] = {}
        # installation topology SSOT decorates controllerStatus with the
        # per-channel encoder deviceIds (reference: server-multi.py:26-31,
        # 643-649 importing time_pitch_mapping)
        self.topology = topology
        self.engine_slots = engine_slots or ["A"]
        self.pool = pool
        # audio_sink(master [2, n] float32) is the DAC boundary — the role
        # the HiFiBerry plays in the reference deployment.  When set (and a
        # pool exists), render_loop_task paces pool steps to real time,
        # staying render_ahead_sec ahead of the wall clock.
        self.audio_sink = audio_sink
        self.render_ahead_sec = render_ahead_sec
        self.ws_host = ws_host
        self.ws_port = ws_port
        self.clients: set = set()
        self.allocator = SlotAllocator(self.engine_slots, pinned=pinned_slots)
        self.liveness = EncoderLiveness(self.engine_slots)
        self.sessions: dict[str, SerialSession] = {}  # device_id -> session
        self._transports = list(transports or [])
        self._last_controller_status: dict | None = None
        self._msg_count = 0
        self._inflight: set = set()
        self._stop = asyncio.Event()
        # playback-position push cadence — the reference playback slider
        # refreshes at 5 Hz (app/multi/app.mjs:740-753); 0 disables
        self.time_push_sec = time_push_sec
        # pool steps run off the event loop (asyncio.to_thread) so a slow
        # (fidelity-mode) device step cannot stall WS/serial handling; this
        # lock serializes the stepping thread against control mutations —
        # the role the reference's render-thread message queue plays
        # (app/SignalsmithStretch.mjs:746-777)
        self._pool_lock = threading.Lock()
        # last analysis per slot: the sync HTTP path serves from this when
        # the lock is held (a fidelity-mode step can hold it for tens of ms
        # and process_request runs ON the event loop)
        self._analysis_cache: dict[str, dict] = {}

    # ------------------------------------------------------------ transport
    def add_transport(self, t: Transport) -> None:
        """Make a candidate device visible to the scan loop (tests plug
        FakeController instances in here; hardware integration lists
        pyserial ports instead)."""
        self._transports.append(t)

    # ----------------------------------------------------- locked pool access
    def _locked_apply_set(self, slot: str, key: str, value) -> bool:
        with self._pool_lock:
            return self.pool.apply_set(slot, key, value)

    def _locked_step(self):
        with self._pool_lock:
            return self.pool.step(fetch=True)

    def _locked_analyze(self, slot: str):
        if self.pool is None:
            return None
        with self._pool_lock:
            result = self.pool.analyze(slot)
        if result is not None:
            self._analysis_cache[slot] = result
        return result

    def _locked_time_status(self) -> list[tuple[str, float]]:
        """(slot, input_time) for every actively-playing voice, read under
        the pool lock: ``input_time_at`` advances the TimeMap (segment pops,
        loop wraps) on the same objects the stepping thread mutates, so
        lock-free reads could double-apply a loop wrap or drop a scheduled
        segment."""
        with self._pool_lock:
            return [
                (slot, self.pool.input_time(slot))
                for slot in self.engine_slots
                if getattr(self.pool, "is_playing", lambda s: False)(slot)
            ]

    # ------------------------------------------------------------ broadcast
    async def broadcast(self, msg: dict) -> None:
        dead = []
        data = json.dumps(msg)
        # snapshot: clients connecting/reaping during the awaits would
        # mutate the live set mid-iteration
        for ws in list(self.clients):
            try:
                await ws.send(data)
            except Exception:
                dead.append(ws)
        for ws in dead:  # reap like the reference (:448-455)
            self.clients.discard(ws)

    @property
    def session(self) -> SerialSession | None:
        """First attached session (single-controller compatibility view)."""
        return next(iter(self.sessions.values()), None)

    def controller_status(self) -> dict:
        first = self.session
        attached = first is not None
        device_id = first.hello.get("deviceId") if attached else None
        encoder_ids = None
        if self.topology is not None and device_id is not None:
            encoder_ids = self.topology.channel_encoder_ids(device_id)
        msg = protocol.controller_status_msg(
            connected=attached,
            port=getattr(first.transport, "device_id", "mem") if attached else None,
            device_id=device_id,
            fw=first.hello.get("fw") if attached else None,
            engines=self.engine_slots,
            encoder_ages_ms=self.liveness.ages_ms(),
            encoder_device_ids=encoder_ids,
        )
        # multi-controller extension (the reference wire shape keeps the
        # single-controller fields above for its UI; the shelved OLD server
        # logged per-controller state — here every attachment is reported)
        msg["controllers"] = [
            {
                "deviceId": dev,
                "fw": s.hello.get("fw"),
                "slot": self.allocator.slot_of(dev),
            }
            for dev, s in self.sessions.items()
        ]
        return msg

    # ------------------------------------------------------------- handlers
    async def ws_handler(self, websocket) -> None:
        self.clients.add(websocket)
        try:
            await websocket.send(json.dumps(protocol.server_version_msg()))
            await websocket.send(json.dumps(protocol.machine_status_msg()))
            await websocket.send(json.dumps(self.controller_status()))
            async for raw in websocket:
                self._msg_count += 1
                msg = protocol.parse_line(raw)
                if not msg:
                    continue
                if msg.get("type") == "hello":
                    log.info("📡 client hello: %s", msg.get("engineSlots"))
                elif msg.get("type") == "set":
                    await self._handle_set(msg, from_ws=True)
                elif msg.get("type") == "analyze":
                    # monitoring request (the servable Scope, C13): reply to
                    # the requesting client only — not broadcast
                    result = await asyncio.to_thread(
                        self._locked_analyze, str(msg.get("slot", ""))
                    )
                    await websocket.send(json.dumps(
                        {"type": "analysis", **(result or {"slot": msg.get("slot"), "error": "unavailable"})}
                    ))
        finally:
            self.clients.discard(websocket)

    async def _handle_set(self, msg: dict, from_ws: bool = False) -> None:
        # prefer the engine tag: serial routing may map a controller's local
        # channel onto a different slot (the app layer likewise dispatches
        # on `engine` — reference app/multi/app.mjs:850-886)
        channel = msg.get("engine") or msg.get("channel")
        key = msg.get("key")
        value = msg.get("value")
        if channel not in self.engine_slots or not isinstance(key, str):
            return
        # json.loads accepts NaN/Infinity tokens; don't re-broadcast them
        # (json.dumps would emit invalid JSON for strict client parsers)
        if isinstance(value, float) and not math.isfinite(value):
            log.warning("📟 dropping non-finite set %s=%r on %s", key, value, channel)
            return
        if self.pool is not None:
            pool_key = {"tone": "semitones", "volume": "volumePercent"}.get(key, key)
            await asyncio.to_thread(self._locked_apply_set, channel, pool_key, value)
        out = protocol.set_msg(msg.get("channel") or channel, key, value, engine=channel)
        await self.broadcast(out)

    def _forward_from_serial(self, msg: dict) -> None:
        # called synchronously from the pump; schedule async fan-out.
        # Hold a reference until done: the loop keeps only weak refs, so a
        # fire-and-forget task can be GC'd mid-flight under load.
        if self.serial_log == "full":
            log.info("📟 %s", msg)
        task = asyncio.get_running_loop().create_task(self._handle_set(msg))
        self._inflight.add(task)
        task.add_done_callback(self._inflight.discard)

    def _log_serial_digest(self) -> None:
        """Per-key message-count deltas, the reference's digest mode
        (server-multi.py:774-804)."""
        if not self.sessions or self.serial_log != "digest":
            return
        now = time.monotonic()
        if now - self._digest_last < 10.0:
            return
        counters: dict[str, int] = {}
        for s in self.sessions.values():
            for k, v in s.counters.items():
                counters[k] = counters.get(k, 0) + v
        deltas = {
            k: v - self._digest_base.get(k, 0)
            for k, v in counters.items()
            if v - self._digest_base.get(k, 0)
        }
        if deltas:
            log.info("📟 serial digest (10s): %s", deltas)
        self._digest_base = counters
        self._digest_last = now

    # --------------------------------------------------------------- tasks
    def _candidate_transports(self) -> list:
        """Registered in-memory transports (minus already-attached ones —
        the OLD multi-controller server probes only unattached ports,
        :642-698) plus freshly-opened hardware ports (pyserial-gated)."""
        attached = {id(s.transport) for s in self.sessions.values()}
        candidates = [t for t in self._transports if id(t) not in attached]
        if self.scan_hardware and not self._transports:
            from bauklank_tpu_torch.serve.serial import list_pyserial_ports, open_pyserial

            open_ports = {
                getattr(s.transport, "port", None) for s in self.sessions.values()
            }
            for port in list_pyserial_ports(exclude=self.serial_exclude):
                if port in open_ports:
                    continue
                try:
                    candidates.append(open_pyserial(port))
                except Exception:
                    log.debug("🧪 could not open %s", port)
        return candidates

    def _attach(self, transport, hello: dict) -> bool:
        dev = hello.get("deviceId", "?")
        slot = self.allocator.assign(dev)
        if self.controller_mode == "slot" and slot is None:
            log.warning("📟 controller %s rejected: no free slot", dev)
            return False
        engine_map = None
        if self.controller_mode == "slot":
            # every local channel of this controller drives its one slot
            engine_map = {ch: slot for ch in ("A", "B", *self.engine_slots)}
        self.sessions[dev] = SerialSession(
            transport, hello, self.engine_slots, self._forward_from_serial,
            self.liveness, engine_map=engine_map,
        )
        log.info("📟 controller attached: %s fw=%s slot=%s", dev, hello.get("fw"), slot)
        return True

    def _detach(self, dev: str) -> None:
        s = self.sessions.pop(dev, None)
        if s is None:
            return
        log.warning("📟 controller detached: %s", dev)
        self.allocator.release(dev)
        try:
            s.transport.close()
        except Exception:
            pass
        if not self.sessions:
            self.liveness.clear()

    async def serial_manager_task(self) -> None:
        """Probe/attach loop (reference :888-915) + line pumps.  N
        controllers run concurrently (the shelved OLD server's semantics:
        one serial task per attached controller — here one cooperative pump
        per session on the single loop)."""
        last_scan = -1e30
        while not self._stop.is_set():
            now = time.monotonic()
            if len(self.sessions) < self.max_controllers and (
                now - last_scan >= SERIAL_SCAN_SEC or not self.sessions
            ):
                last_scan = now
                changed = False
                for t in self._candidate_transports():
                    if len(self.sessions) >= self.max_controllers:
                        break
                    log.debug("🧪 probing %r", t)
                    try:
                        hello = probe_transport(t)
                    except OSError:
                        # a dead registered transport: prune it for good
                        if t in self._transports:
                            self._transports.remove(t)
                        continue
                    if hello and hello.get("deviceId", "?") not in self.sessions:
                        attached = self._attach(t, hello)
                        changed = changed or attached
                if changed:
                    await self._push_controller_status(force=True)
                if not self.sessions:
                    log.debug("🔎 scan: no controller")
                    await asyncio.sleep(SERIAL_SCAN_SEC)
                    continue
            total = 0
            dead = []
            for dev, s in list(self.sessions.items()):
                try:
                    total += s.pump()
                except OSError:
                    dead.append(dev)
            for dev in dead:
                self._detach(dev)
            if dead:
                await self._push_controller_status(force=True)
            self._log_serial_digest()
            await asyncio.sleep(0.01 if total else 0.05)

    async def _push_controller_status(self, force: bool = False) -> None:
        msg = self.controller_status()
        key = json.dumps(
            {**msg, "encoders": {c: v["online"] for c, v in msg["encoders"]["channels"].items()}},
            sort_keys=True,
        )
        if force or key != self._last_controller_status:
            self._last_controller_status = key
            await self.broadcast(msg)
            log.info("📡 controllerStatus: connected=%s", msg["connected"])

    async def encoder_status_task(self) -> None:
        """Flip detection at ~1 Hz + periodic refresh (reference :680-719)."""
        last_refresh = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            await self._push_controller_status(force=(now - last_refresh) >= ENCODER_REFRESH_SEC)
            if (now - last_refresh) >= ENCODER_REFRESH_SEC:
                last_refresh = now
            await asyncio.sleep(1.0)

    async def machine_status_task(self) -> None:
        while not self._stop.is_set():
            await self.broadcast(protocol.machine_status_msg())
            await asyncio.sleep(MACHINE_STATUS_SEC)

    async def render_loop_task(self) -> None:
        """Real-time paced rendering: keep the sink render_ahead_sec ahead.

        The reference's real-time loop is the browser audio thread pulling
        128-frame quanta; here the pool renders interval-sized chunks and
        the loop sleeps whenever it is far enough ahead (BASELINE config 4's
        serving cadence)."""
        if self.pool is None or self.audio_sink is None:
            return
        sr = self.pool.sample_rate
        t0 = time.monotonic()
        while not self._stop.is_set():
            ahead = self.pool.out_pos / sr - (time.monotonic() - t0)
            if ahead >= self.render_ahead_sec:
                await asyncio.sleep(min(0.05, ahead - self.render_ahead_sec + 1e-3))
                continue
            # off-loop: a fidelity-mode step (tens of ms of device time)
            # and a laggy sink must not stall WS/serial handling on the
            # event loop; the sink is therefore invoked from a worker
            # thread — sinks must be thread-safe
            master, _ = await asyncio.to_thread(self._locked_step)
            await asyncio.to_thread(self.audio_sink, master)

    async def time_status_task(self) -> None:
        """Playback-position push: per-voice ``{"type":"time",slot,
        inputTime}`` at the reference playback-UI cadence (the worklet's
        throttled ``['time', inputTime]`` post, app/SignalsmithStretch.mjs:
        938-942, consumed by the 5 Hz slider, app/multi/app.mjs:740-753).
        Only actively-playing voices report, like the reference's
        file-playback branch."""
        if self.pool is None or self.time_push_sec <= 0:
            return
        while not self._stop.is_set():
            for slot, t_in in await asyncio.to_thread(self._locked_time_status):
                await self.broadcast(protocol.time_msg(slot, t_in))
            await asyncio.sleep(self.time_push_sec)

    async def heartbeat_task(self) -> None:
        while not self._stop.is_set():
            await asyncio.sleep(HEARTBEAT_SEC)
            pool_stats = self.pool.metrics() if self.pool is not None else {}
            log.info(
                "💓 heartbeat: clients=%d controller=%s msgs=%d pool=%s",
                len(self.clients), self.session is not None, self._msg_count,
                pool_stats,
            )

    # ----------------------------------------------------------------- run
    async def _supervise(self, factory, name: str) -> None:
        """Keep a task alive: log crashes and restart after a short pause
        (the in-process analog of the reference deployment's
        Restart=on-failure systemd policy)."""
        while not self._stop.is_set():
            try:
                await factory()
                return  # clean exit
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("task %s crashed; restarting in 1s", name)
                try:
                    await asyncio.wait_for(self._stop.wait(), timeout=1.0)
                    return
                except asyncio.TimeoutError:
                    pass

    # --------------------------------------------------------- http surface
    def _process_request(self, connection, request):
        """Serve a status page / JSON on the WS port for plain HTTP GETs —
        the headless stand-in for the reference UI's status bar
        (app/multi/index.html:46-55: server version, machine, ws + msg/s)."""
        import http

        if request.headers.get("Upgrade", "").lower() == "websocket":
            return None  # proceed with the WS handshake
        if request.path.startswith("/status?analyze="):
            slot = request.path.split("=", 1)[1]
            # process_request is synchronous and runs on the event loop:
            # never WAIT for the pool lock here (a fidelity step holds it
            # for tens of ms).  Fresh result if the lock is free, else the
            # cached last analysis, else 503.
            if self.pool is not None and self._pool_lock.acquire(blocking=False):
                try:
                    result = self.pool.analyze(slot)
                finally:
                    self._pool_lock.release()
                if result is not None:
                    self._analysis_cache[slot] = result
            else:
                result = self._analysis_cache.get(slot)
                if result is None:
                    return connection.respond(
                        http.HTTPStatus.SERVICE_UNAVAILABLE, "pool busy\n"
                    )
            body = json.dumps(result or {"slot": slot, "error": "unavailable"})
            return connection.respond(http.HTTPStatus.OK, body + "\n")
        if request.path == "/status":
            body = json.dumps(
                {
                    "server": protocol.server_version_msg(),
                    "machine": protocol.machine_status_msg(),
                    "controller": self.controller_status(),
                    "clients": len(self.clients),
                    "engine": getattr(self.pool, "engine", None),
                    "pool": self.pool.metrics() if self.pool is not None else None,
                }
            )
            return connection.respond(http.HTTPStatus.OK, body + "\n")
        if request.path == "/":
            from bauklank_tpu_torch.serve.statuspage import render_page

            ver = protocol.server_version_msg()["version"]
            html = render_page(ver, self.engine_slots)
            response = connection.respond(http.HTTPStatus.OK, html)
            response.headers["Content-Type"] = "text/html; charset=utf-8"
            return response
        return connection.respond(http.HTTPStatus.NOT_FOUND, "not found\n")

    async def run(self) -> None:
        import websockets

        async with websockets.serve(
            self.ws_handler, self.ws_host, self.ws_port,
            process_request=self._process_request,
        ):
            log.info("serving ws://%s:%d (slots=%s)", self.ws_host, self.ws_port, self.engine_slots)
            await asyncio.gather(
                self._supervise(self.serial_manager_task, "serial"),
                self._supervise(self.machine_status_task, "machine-status"),
                self._supervise(self.encoder_status_task, "encoder-status"),
                self._supervise(self.heartbeat_task, "heartbeat"),
                self._supervise(self.render_loop_task, "render-loop"),
                self._supervise(self.time_status_task, "time-status"),
            )

    def stop(self) -> None:
        self._stop.set()


def build_parser() -> argparse.ArgumentParser:
    """CLI mirrors the reference flags (server-multi.py:101-148), plus
    ``--device``, and ``--block-ms`` and ``--overlap`` (a ``--pool
    stream`` pool's own geometry; ``_parse_args`` refuses them elsewhere).

    Exposed (rather than inlined in ``_parse_args``) so tests can assert
    the outer ``bauklank_tpu_torch.cli`` serve subparser accepts the same
    flag set — the inner/outer parser divergence bug class."""
    ap = argparse.ArgumentParser(description="bauklank_tpu_torch control-plane server")
    ap.add_argument("--engine-count", type=int, default=1, choices=(1, 2))
    ap.add_argument("--slot", default="A", choices=("A", "B"))
    ap.add_argument("--ws-host", default="0.0.0.0")
    ap.add_argument("--ws-port", type=int, default=8765)
    ap.add_argument("--startup-log-level", default="info")
    ap.add_argument("--run-log-level", default="info")
    ap.add_argument("--serial-log", default="digest", choices=("full", "digest"))
    ap.add_argument("--serial-exclude", action="append", default=[],
                    help="serial ports to skip during scans (repeatable)")
    ap.add_argument("--no-serial-scan", action="store_true",
                    help="disable hardware port scanning")
    ap.add_argument("--pool-capacity", type=int, default=0,
                    help="batched voice slots; 0 = control-plane only")
    ap.add_argument("--pool", default="stream", choices=("stream", "unified"),
                    help="stream = one shared engine config; unified = "
                         "per-voice config buckets + live-input voices "
                         "(set blockMs/overlap takes effect per voice)")
    ap.add_argument("--engine", default="fast", choices=("fast", "fidelity"),
                    help="fast = hop-parallel core (engine.core); "
                         "fidelity = blob-exact reference algorithm "
                         "(engine.spectral, >=40 dB vs the reference blob)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the device every pool runs on (default cuda; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--block-ms", type=float, default=0.0,
                    help="--pool stream: the block in ms, unrounded for the fidelity "
                         "engine (the kiosk's 200); 0 = the 120/30 ms preset")
    ap.add_argument("--overlap", type=float, default=0.0,
                    help="with --block-ms: block over interval (the kiosk's 1); "
                         "0 = the preset's 4")
    return ap


def _parse_args(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.overlap and not args.block_ms:
        ap.error("--overlap sizes the interval from --block-ms: give both")
    if args.block_ms and args.pool != "stream":
        ap.error("--block-ms sizes a --pool stream pool; a unified pool sizes each "
                 "voice by its own blockMs")
    return args


def build_server(args: argparse.Namespace, **server_kw) -> ControlServer:
    """The pool and the server that ``main`` runs, from parsed arguments;
    ``server_kw`` adds :class:`ControlServer` arguments the command line
    does not set (an ``audio_sink``, ``render_ahead_sec``).  Raises
    without a visible CUDA device unless ``args.device`` is ``cpu``, when
    a pool is asked for."""
    slots = ["A", "B"] if args.engine_count == 2 else [args.slot]
    pool = None
    if args.pool_capacity:
        device = resolve_device(args.device)
        if args.pool == "unified":
            from bauklank_tpu_torch.serve.unified import UnifiedPool

            # pipelined bucket fetches: identical sample stream, the copy
            # to the host hidden behind subsequent dispatches
            pool = UnifiedPool(names=slots[: args.pool_capacity],
                               pipeline_fetch=True, engine=args.engine, device=device)
        else:
            geometry = {}
            if args.block_ms:
                block, interval = block_interval(args.block_ms, args.overlap or 4.0, 44100.0)
                geometry = dict(block=block, interval=interval)
            pool = StreamPool(capacity=args.pool_capacity,
                              names=slots[: args.pool_capacity],
                              engine=args.engine, device=device, **geometry)
    return ControlServer(pool=pool, engine_slots=slots,
                         ws_host=args.ws_host, ws_port=args.ws_port,
                         serial_log=args.serial_log,
                         serial_exclude=args.serial_exclude,
                         scan_hardware=not args.no_serial_scan, **server_kw)


def main(argv=None) -> None:
    args = _parse_args(argv)
    _setup_logging(args.startup_log_level)
    server = build_server(args)
    _setup_logging(args.run_log_level)
    asyncio.run(server.run())


if __name__ == "__main__":
    main()
