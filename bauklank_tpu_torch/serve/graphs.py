"""CUDA graphs of the pool step, of either engine: the step's launches
issued by a few graph replays instead of one by one from Python.

A pool step on the card issues some 160 (fast engine) to 300-500
(fidelity engine) small launches, and the host takes longer to issue
them than the card takes to run them.  :class:`StepGraphs` captures the
step once per step key and replays it:

- The step is issued as stages, each a function of no arguments handed
  to ``run(range name or None, stage)`` (``serve.pool._issue_fast`` and
  ``_issue_fidelity``: the unpacking, ``engine.core.fast_stages`` or
  ``engine.fidelity.fidelity_stages``, the mixdown), and
  each stage is captured as its own graph, all of one key in one memory
  pool, so that a replay runs inside the same program range
  (``utils.metrics.span``) as the stage's eager launches: the profiler
  charges the graph's kernels to that range as it charged the launches.
- The first step with a key runs eagerly; the key's graphs are captured
  after it (a capture runs no work), and its later steps copy the packed
  host array into the key's static device buffer and replay.  The other
  operands (the pool's state and tracks) are read from the tensors the
  graphs were captured with: a step handed other tensors drops every
  graph and captures again.
- What a replay computes lands in the graphs' memory, which the next
  replay overwrites: :meth:`StepGraphs.step` returns copies of the master
  and the streams, and the new state in the graphs' memory, for the
  caller to copy into its own state tensors before the next step.  Each
  key keeps its memory pool, about one eager step's working set, until
  the graphs are dropped.
- The constant tables a capture reads (``utils.metrics.tables_read``)
  are held with the key's graphs, so that an eviction from a table's
  cache cannot free memory they read.
- ``kernels.LAUNCHES`` counts the launches that the host issues: a
  capture's, as a step's, and none for a replay.  The kernels a replay
  runs are seen by ``torch.profiler``.

A replay runs the kernels of the eager step on the same operands, so its
results are the eager step's bit for bit (``tests/test_torch_pool_graph_cuda.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from bauklank_tpu_torch.utils.metrics import span, tables_read

__all__ = ["StepGraphs", "eager"]


@dataclasses.dataclass
class _Captured:
    packed: torch.Tensor          # the static device copy of the packed array
    graphs: list                  # (range name or None, CUDAGraph) in step order
    out: tuple                    # the static results: (states, master, streams)
    held: list                    # the constant tables the graphs read


def eager(name, stage) -> None:
    """Run ``stage`` now, inside the range ``name`` (None: no range)."""
    with span(name) if name else contextlib.nullcontext():
        stage()


class StepGraphs:
    """One pool's step graphs, a set per step key.  ``captures`` counts
    the keys captured, ``replays`` the steps replayed."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._sets: dict = {}
        self._operands: tuple = ()    # the tensors every set was captured with
        self.captures = 0
        self.replays = 0

    def step(self, key, packed: torch.Tensor, operands, issue):
        """One step.  ``packed`` is the packed array on the host;
        ``operands`` the tensors the step reads besides it;
        ``issue(run, dev_packed)`` issues the step as ``run(range name or
        None, stage)`` calls in step order and returns (states, master,
        streams) once they have run.  Returns the same: the master and the
        streams never the graphs' own memory, the states the graphs' own
        on a replay."""
        operands = tuple(operands)
        if len(operands) != len(self._operands) or any(
                a is not b for a, b in zip(operands, self._operands)):
            self._sets.clear()
            self._operands = operands
        got = self._sets.get(key)
        if got is None:
            out = issue(eager, packed.to(self.device))
            self._capture(key, packed.shape, issue)
            return out
        got.packed.copy_(packed)
        for name, graph in got.graphs:
            eager(name, graph.replay)
        self.replays += 1
        states, master, streams = got.out
        return states, master.clone(), streams.clone()

    def _capture(self, key, shape, issue) -> None:
        """Capture the key's stages, each as a graph, in step order."""
        packed = torch.empty(shape, dtype=torch.float32, device=self.device)
        mempool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(self.device)    # a side stream of the pool's own card
        graphs, held = [], []

        def capture(name, stage) -> None:
            graph = torch.cuda.CUDAGraph()
            # thread_local: work that another thread puts on the card
            # meanwhile does not break this thread's capture
            with torch.cuda.graph(graph, pool=mempool, stream=stream,
                                  capture_error_mode="thread_local"):
                stage()
            graphs.append((name, graph))

        with tables_read(held):
            out = issue(capture, packed)
        self._sets[key] = _Captured(packed, graphs, out, held)
        self.captures += 1
