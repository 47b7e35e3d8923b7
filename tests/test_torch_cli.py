"""PyTorch port, the command line: ``bauklank_tpu_torch.cli`` and the
server's own parser, against the JAX package's.

The outer ``serve`` subparser and the inner ``serve/server.py`` parser
take the same flags, which are the JAX flag set plus ``--device``,
``--block-ms`` and ``--overlap``;
``_cmd_serve`` forwards every one; ``main`` builds the requested pool and
engine on ``--device cpu`` and raises without a card otherwise (before
any port is bound).  ``stretch`` on the CPU is held to the JAX CLI's
output file at >= 80 dB, the fast engine's bound in
``tests/test_torch_fast_engine.py`` (JAX-on-CPU fuses the multiply-adds
that the port rounds one by one), and its dominant frequency to the
pitch shift.  ``topology-header`` is string-equal to JAX's.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.util import REPO_ROOT, dominant_freq, snr_db

from bauklank_tpu import cli as jcli
from bauklank_tpu.runtime import wav_read as j_wav_read
from bauklank_tpu.serve import server as jserver
from bauklank_tpu_torch import cli
from bauklank_tpu_torch.runtime import wav_read, wav_write
from bauklank_tpu_torch.serve import server


def _option_strings(parser) -> set:
    return {opt for action in parser._actions for opt in action.option_strings
            if opt not in ("-h", "--help")}


def _serve_subparser(mod):
    for action in mod.build_parser()._actions:
        if isinstance(getattr(action, "choices", None), dict):
            return action.choices["serve"]
    raise AssertionError("no serve subparser")


def test_serve_parsers_accept_the_jax_flags_and_device():
    inner = _option_strings(server.build_parser())
    outer = _option_strings(_serve_subparser(cli))
    assert inner == outer, (sorted(inner - outer), sorted(outer - inner))
    ours = {"--device", "--block-ms", "--overlap"}
    assert inner == _option_strings(jserver.build_parser()) | ours
    assert _option_strings(_serve_subparser(jcli)) | ours == outer
    assert server.build_parser().parse_args([]).device == "cuda"


def test_stretch_parser_is_the_jax_parser_and_device():
    def stretch(mod):
        for action in mod.build_parser()._actions:
            if isinstance(getattr(action, "choices", None), dict):
                return _option_strings(action.choices["stretch"])

    assert stretch(cli) == stretch(jcli) | {"--device"}


def test_cmd_serve_forwards_every_flag(monkeypatch):
    captured = {}
    monkeypatch.setattr(server, "main", lambda argv: captured.update(argv=argv))
    rc = cli.main([
        "serve", "--engine-count", "2", "--slot", "B", "--ws-host", "127.0.0.1",
        "--ws-port", "9100", "--startup-log-level", "debug", "--run-log-level", "warning",
        "--serial-log", "full", "--serial-exclude", "/dev/ttyX", "--no-serial-scan",
        "--pool-capacity", "2", "--pool", "unified", "--engine", "fidelity",
        "--device", "cpu",
    ])
    assert rc == 0
    args = server._parse_args(captured["argv"])
    assert vars(args) == {
        "engine_count": 2, "slot": "B", "ws_host": "127.0.0.1", "ws_port": 9100,
        "startup_log_level": "debug", "run_log_level": "warning", "serial_log": "full",
        "serial_exclude": ["/dev/ttyX"], "no_serial_scan": True, "pool_capacity": 2,
        "pool": "unified", "engine": "fidelity", "device": "cpu", "block_ms": 0.0,
        "overlap": 0.0}
    # every option that takes one value is forwarded even at its default (a
    # flag and a repeatable option only when given, as above)
    cli.main(["serve"])
    for action in server.build_parser()._actions:
        if action.option_strings and not isinstance(
                action, (argparse._StoreTrueAction, argparse._HelpAction,
                         argparse._AppendAction)):
            assert action.option_strings[0] in captured["argv"], action.option_strings


@pytest.fixture
def runs(monkeypatch):
    """Stub ``ControlServer.run``: record the server it would have served."""
    seen = []

    async def fake_run(self):
        seen.append(self)

    monkeypatch.setattr(server.ControlServer, "run", fake_run)
    return seen


@pytest.mark.parametrize("pool_kind", ["stream", "unified"])
@pytest.mark.parametrize("engine", ["fast", "fidelity"])
def test_serve_main_builds_the_requested_pool_on_the_cpu(runs, pool_kind, engine):
    from bauklank_tpu_torch.serve.pool import StreamPool
    from bauklank_tpu_torch.serve.unified import UnifiedPool

    cli.main(["serve", "--engine-count", "2", "--pool-capacity", "2", "--no-serial-scan",
              "--pool", pool_kind, "--engine", engine, "--device", "cpu"])
    pool = runs[0].pool
    assert isinstance(pool, UnifiedPool if pool_kind == "unified" else StreamPool)
    assert pool.engine == engine and pool.device.type == "cpu"
    assert runs[0].engine_slots == ["A", "B"]
    if pool_kind == "unified":
        assert pool.pipeline_fetch and sorted(pool.voices) == ["A", "B"]
    else:
        assert [s.name for s in pool.slots] == ["A", "B"]


@pytest.mark.parametrize("engine, sizes", [("fidelity", (8820, 8820)), ("fast", (9216, 8820))])
def test_serve_block_ms_and_overlap_give_the_stream_pool_its_geometry(runs, engine, sizes):
    """The kiosk's 200 ms at overlap 1: the fidelity pool runs it raw, the
    fast one rounds the block; ``--block-ms`` alone takes the preset's
    overlap of 4."""
    cli.main(["serve", "--pool-capacity", "1", "--no-serial-scan", "--engine", engine,
              "--device", "cpu", "--block-ms", "200", "--overlap", "1"])
    assert (runs[0].pool.drive.block, runs[0].pool.drive.interval) == sizes
    cli.main(["serve", "--pool-capacity", "1", "--no-serial-scan", "--engine", engine,
              "--device", "cpu", "--block-ms", "200"])
    assert runs[1].pool.drive.interval == 2205


@pytest.mark.parametrize("argv", [["--overlap", "1"],
                                  ["--block-ms", "200", "--pool", "unified"]])
def test_serve_refuses_a_geometry_it_would_not_run(runs, argv, capsys):
    """``--overlap`` without ``--block-ms``, and ``--block-ms`` for a
    unified pool (which sizes each voice by its own blockMs), exit before
    any pool is built."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", "--pool-capacity", "1", "--no-serial-scan", "--device", "cpu",
                  *argv])
    assert exc.value.code == 2 and "--block-ms" in capsys.readouterr().err
    assert runs == []


def test_serve_raises_without_a_card_before_binding(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["serve", "--pool-capacity", "1"],
                 ["serve", "--pool-capacity", "1", "--pool", "unified", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
    assert runs == []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["stretch", "in.wav", "out.wav"])
    # the control plane alone touches no device
    cli.main(["serve", "--pool-capacity", "0", "--no-serial-scan"])
    assert len(runs) == 1 and runs[0].pool is None


def test_stretch_matches_the_jax_cli(tmp_path):
    sr = 44100
    rng = np.random.default_rng(8)
    t = np.arange(int(1.5 * sr)) / sr
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t) + 0.01 * rng.standard_normal(t.shape)
    wav_write(tmp_path / "in.wav", np.stack([x, np.roll(x, 300)]).astype(np.float32), sr)
    argv = ["--rate", "0.5", "--semitones", "-12", "--max-seconds", "2", "--float32"]
    assert jcli.main(["stretch", str(tmp_path / "in.wav"), str(tmp_path / "jax.wav"),
                      *argv]) == 0
    assert cli.main(["stretch", str(tmp_path / "in.wav"), str(tmp_path / "port.wav"),
                     *argv, "--device", "cpu"]) == 0
    ref, sr_j = j_wav_read(tmp_path / "jax.wav")
    got, sr_t = wav_read(tmp_path / "port.wav")
    assert sr_j == sr_t == sr and got.shape == ref.shape == (2, 2 * sr)
    assert snr_db(ref, got) >= 80.0
    assert abs(dominant_freq(got[0, sr:sr + 16384], sr) - 220.0) < 0.02 * 220.0


def test_topology_header_matches_jax(capsys):
    assert jcli.main(["topology-header"]) == 0
    ref = capsys.readouterr().out
    assert cli.main(["topology-header"]) == 0
    assert capsys.readouterr().out == ref
    assert "TIME_PITCH_TOPOLOGY" in ref


def test_python_dash_m_runs_the_port():
    res = subprocess.run([sys.executable, "-m", "bauklank_tpu_torch", "topology-header"],
                         capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
    assert res.returncode == 0, res.stderr
    assert "TIME_PITCH_TOPOLOGY_LEN" in res.stdout
    res = subprocess.run([sys.executable, "-m", "bauklank_tpu_torch", "serve", "--help"],
                         capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
    assert res.returncode == 0 and "--device" in res.stdout
