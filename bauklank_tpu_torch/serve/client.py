"""WebSocket control client — the browser app's client role, headless.

Mirrors the reference frontend's WS behavior (reference:
app/multi/app.mjs:797-893 and app/app.mjs:408-419): connect, send
``{"type": "hello", "engineSlots": [...]}``, track server/machine/controller
status, meter message rate, dispatch ``set`` messages to a handler, and
reconnect — fixed 1 s like the multi app, or exponential 250 ms -> 8 s like
the single app (both offered).

Useful for monitoring dashboards, remote controllers, and tests that need a
faithful peer for the control plane.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Callable

from bauklank_tpu_torch.utils.metrics import RateMeter

__all__ = ["ControlClient"]

log = logging.getLogger("bauklank.client")


class ControlClient:
    def __init__(
        self,
        url: str,
        engine_slots: list[str] | None = None,
        on_set: Callable[[dict], None] | None = None,
        reconnect: str = "fixed",  # "fixed" (multi app) | "backoff" (single app)
    ) -> None:
        self.url = url
        self.engine_slots = engine_slots or ["A"]
        self.on_set = on_set
        self.reconnect = reconnect
        self.server_version: str | None = None
        self.machine_status: dict | None = None
        self.controller_status: dict | None = None
        self.meter = RateMeter()
        self.connected = False
        self._stop = asyncio.Event()
        self._ws = None
        self._analysis_futs: dict[str, list] = {}

    async def send_set(self, channel: str, key: str, value) -> None:
        if self._ws is None:
            raise ConnectionError("not connected")
        await self._ws.send(json.dumps(
            {"type": "set", "channel": channel, "key": key, "value": value}
        ))

    async def request_analysis(self, slot: str, timeout: float = 5.0) -> dict:
        """Request scope/spectrum/levels for a voice (the servable Scope,
        reference app/Scope.mjs:398-428).  Returns the ``analysis`` reply."""
        if self._ws is None:
            raise ConnectionError("not connected")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._analysis_futs.setdefault(slot, []).append(fut)
        await self._ws.send(json.dumps({"type": "analyze", "slot": slot}))
        return await asyncio.wait_for(fut, timeout)

    def stop(self) -> None:
        self._stop.set()

    async def run(self) -> None:
        import websockets

        delay = 0.25
        while not self._stop.is_set():
            try:
                async with websockets.connect(self.url) as ws:
                    self._ws = ws
                    self.connected = True
                    delay = 0.25
                    await ws.send(json.dumps(
                        {"type": "hello", "engineSlots": self.engine_slots}
                    ))
                    async for raw in ws:
                        if self._stop.is_set():
                            break
                        self.meter.pulse()
                        try:
                            msg = json.loads(raw)
                        except json.JSONDecodeError:
                            continue
                        self._dispatch(msg)
            except Exception as e:  # connection refused / dropped
                log.debug("ws connection ended: %s", e)
            finally:
                self.connected = False
                self._ws = None
            if self._stop.is_set():
                break
            if self.reconnect == "fixed":
                wait = 1.0  # multi app (app/multi/app.mjs:838-843)
            else:
                wait = delay
                delay = min(delay * 2, 8.0)  # single app (app/app.mjs:408-419)
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=wait)
            except asyncio.TimeoutError:
                pass

    def _dispatch(self, msg: dict) -> None:
        t = msg.get("type")
        if t == "serverVersion":
            self.server_version = msg.get("version")
        elif t == "machineStatus":
            self.machine_status = msg
        elif t == "controllerStatus":
            self.controller_status = msg
        elif t == "set" and self.on_set:
            self.on_set(msg)
        elif t == "analysis":
            for fut in self._analysis_futs.pop(msg.get("slot", ""), []):
                if not fut.done():
                    fut.set_result(msg)
        # legacy single-app forms (app/app.mjs:466-488)
        elif t == "state" and self.on_set:
            for k, v in (msg.get("values") or {}).items():
                self.on_set({"type": "set", "channel": self.engine_slots[0],
                             "key": k, "value": v})
        elif t and "value" in msg and self.on_set:
            self.on_set({"type": "set", "channel": self.engine_slots[0],
                         "key": t, "value": msg["value"]})
