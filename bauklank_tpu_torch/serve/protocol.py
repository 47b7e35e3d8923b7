"""Wire protocol: message builders and parsers.

Reproduces the reference server's WebSocket JSON surface (reference:
server-multi.py — serverVersion :360-363, machineStatus :324-357,
controllerStatus :635-661, set forwarding :829-860; summarized in
SURVEY.md §2.3) and the serial JSON handshake (§2.4).
"""

from __future__ import annotations

import getpass
import json
import platform
import socket
import sys
from typing import Any

from bauklank_tpu_torch.utils.version import full_version

__all__ = [
    "server_version_msg",
    "machine_status_msg",
    "controller_status_msg",
    "set_msg",
    "hello_probe",
    "hello_reply",
    "normalize_set_value",
    "parse_line",
]

ENCODER_OFFLINE_TIMEOUT_SEC = 10.0  # reference: server-multi.py:173-181


def server_version_msg(version: str | None = None) -> dict:
    return {"type": "serverVersion", "version": version or full_version()}


def machine_status_msg() -> dict:
    """Host facts pushed to every client (reference: server-multi.py:324-357)."""
    hostname = socket.gethostname()
    try:
        ips = sorted(
            {
                info[4][0]
                for info in socket.getaddrinfo(hostname, None)
                if ":" not in info[4][0]
            }
        )
    except socket.gaierror:
        ips = []
    try:
        user = getpass.getuser()
    except (KeyError, OSError):
        user = "?"
    return {
        "type": "machineStatus",
        "hostname": hostname,
        "user": user,
        "platform": platform.system(),
        "arch": platform.machine(),
        "ip": ips[0] if ips else "",
        "ips": ips,
        "python": sys.version.split()[0],
    }


def controller_status_msg(
    connected: bool,
    port: str | None = None,
    device_id: str | None = None,
    fw: str | None = None,
    engines: list[str] | None = None,
    encoder_ages_ms: dict[str, float | None] | None = None,
    encoder_device_ids: dict[str, str] | None = None,
) -> dict:
    """Controller + per-channel encoder liveness (server-multi.py:635-661)."""
    engines = engines or []
    channels = {}
    for ch in engines:
        age = (encoder_ages_ms or {}).get(ch)
        channels[ch] = {
            "online": age is not None and age < ENCODER_OFFLINE_TIMEOUT_SEC * 1000.0,
            "ageMs": None if age is None else round(age),
            "deviceId": (encoder_device_ids or {}).get(ch),
        }
    msg: dict[str, Any] = {
        "type": "controllerStatus",
        "connected": connected,
        "engines": engines,
        "encoders": {
            "timeoutSec": ENCODER_OFFLINE_TIMEOUT_SEC,
            "channels": channels,
        },
    }
    if connected:
        msg.update({"port": port, "deviceId": device_id, "fw": fw})
    return msg


def time_msg(slot: str, input_time: float) -> dict:
    """Playback-position push: the WS form of the worklet's throttled
    ``['time', inputTime]`` message (app/SignalsmithStretch.mjs:938-942)
    that drives the reference UI's 5 Hz playback slider
    (app/multi/app.mjs:740-753)."""
    return {
        "type": "time",
        "slot": slot,
        "engine": slot,
        "inputTime": round(float(input_time), 6),
    }


def set_msg(channel: str, key: str, value, engine: str | None = None) -> dict:
    """A forwarded control change; the server tags the engine slot
    (server-multi.py:857-858)."""
    return {
        "type": "set",
        "channel": channel,
        "engine": engine if engine is not None else channel,
        "key": key,
        "value": value,
    }


def hello_probe() -> str:
    """Serial probe line (server-multi.py:542-569)."""
    return json.dumps({"type": "whoareyou"}) + "\n"


def hello_reply(device_id: str, fw: str = "fake-1.0") -> str:
    return (
        json.dumps(
            {
                "type": "hello",
                "deviceType": "bauklank-controller",
                "deviceId": device_id,
                "fw": fw,
            }
        )
        + "\n"
    )


def normalize_set_value(key: str, value):
    """int for volume/tone, float for rate (server-multi.py:722-737)."""
    try:
        if key in ("volume", "tone"):
            return int(round(float(value)))
        if key == "rate":
            return float(value)
    except (TypeError, ValueError):
        return None
    return value


def parse_line(line: str | bytes) -> dict | None:
    """Parse one newline-delimited JSON message; non-JSON tolerated as None
    (server-multi.py:524-525)."""
    if isinstance(line, bytes):
        try:
            line = line.decode("utf-8", "replace")
        except Exception:
            return None
    line = line.strip()
    if not line or not line.startswith("{"):
        return None
    try:
        msg = json.loads(line)
    except json.JSONDecodeError:
        return None
    return msg if isinstance(msg, dict) else None
