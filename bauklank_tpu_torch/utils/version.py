"""Version metadata.

The reference keeps its version in version.json and decorates it with the git
short hash + ``-dirty`` (reference: server-multi.py:215-287, version.json).
We reproduce that surface so the WebSocket ``serverVersion`` message matches.
"""

from __future__ import annotations

import json
import pathlib
import subprocess

__version__ = "0.1.0"


def full_version(repo_root: str | pathlib.Path | None = None) -> str:
    """``<version>+g<shorthash>[-dirty]`` like the reference server.

    Falls back to the bare version when git is unavailable.
    """
    root = pathlib.Path(repo_root) if repo_root else pathlib.Path(__file__).resolve().parents[2]
    version = __version__
    vj = root / "version.json"
    if vj.exists():
        try:
            version = str(json.loads(vj.read_text()).get("version", version))
        except (json.JSONDecodeError, OSError):
            pass
    try:
        h = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=5,
        )
        if h.returncode == 0:
            version += "+g" + h.stdout.strip()
            dirty = subprocess.run(
                ["git", "status", "--porcelain"],
                cwd=root, capture_output=True, text=True, timeout=5,
            )
            if dirty.returncode == 0 and dirty.stdout.strip():
                version += "-dirty"
    except (OSError, subprocess.TimeoutExpired):
        pass
    return version
