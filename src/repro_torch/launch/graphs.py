"""One decode step captured in a CUDA graph and replayed: the port's
counterpart of the reference's ``jax.jit`` + ``lax.scan`` decode loops
(``repro/launch/engine.py:261``, ``_decode_loop``, and
``repro/launch/batch_engine.py:945-968``, ``_chunk_fn``), which make the
whole loop one dispatch.  Here each step is one ``graph.replay()``
instead of some hundred small launches a layer.

``StepGraph(step, state)``:

  * runs ``step`` once eagerly on a side stream.  That warm-up does what
    must not happen under capture: the kernels' build at first use, the
    device properties the B1/B2 split plan reads, the kernels'
    shared-memory attributes, cuBLAS's handles and workspaces;
  * puts back the tensors listed in ``state``: the lengths, positions,
    token buffer and masks, which are all that a step advances.  The
    warm-up's K/V writes land at or past every row's length, and the
    step that follows writes the same bytes there again, since a step
    is a function of that state;
  * captures ``step`` under ``torch.cuda.graph``, in ``pool`` when given
    (the graphs of one engine share one pool);
  * ``replay()`` launches the whole step.

A step must read and write fixed buffers: every state update in
``core/`` and ``models/`` is in place for that reason.  Sampling with a
``torch.Generator`` registers it with the graph, so that each replay
draws fresh numbers; an installed PyTorch without
``CUDAGraph.register_generator_state`` cannot do that, and the capture
raises.  A failed capture raises too: there is no eager fallback.

Launch counters.  Each kernel wrapper counts its launches
(``kernels.*.ops``), but under capture the wrapper runs once and
launches nothing.  The capture's counts are therefore taken back and
added again at each replay, so the counters keep counting kernels that
ran.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from repro_torch.kernels.quant_attention import ops as qa_ops
from repro_torch.kernels.srft_quant import ops as sq_ops

__all__ = ["StepGraph", "launch_counts", "can_register_generator"]

_COUNTERS = ((qa_ops, "launches"), (qa_ops, "paged_launches"),
             (sq_ops, "launches"), (sq_ops, "dequant_launches"))


def launch_counts() -> tuple[int, ...]:
    """The kernels' launch counters: B1, B2, B3, B4."""
    return tuple(getattr(m, a) for m, a in _COUNTERS)


def _add_counts(counts: Sequence[int]) -> None:
    for (m, a), c in zip(_COUNTERS, counts):
        setattr(m, a, getattr(m, a) + c)


def can_register_generator() -> bool:
    """True when the installed PyTorch can register a generator with a
    graph (needed for sampling other than greedy under a graph)."""
    return hasattr(torch.cuda.CUDAGraph, "register_generator_state")


class StepGraph:
    """``step`` captured once; ``replay()`` runs it.  ``out`` is what the
    captured call returned (tensors in the graph's memory, rewritten by
    every replay); ``counts`` the kernel launches of one replay (B1, B2,
    B3, B4); ``capture_s`` the host seconds of warm-up and capture."""

    def __init__(self, step: Callable[[], object],
                 state: Sequence[torch.Tensor], *, pool=None,
                 generator: Optional[torch.Generator] = None):
        if generator is not None and not can_register_generator():
            raise NotImplementedError(
                "sampling under a CUDA graph needs "
                "CUDAGraph.register_generator_state, which this PyTorch "
                f"({torch.__version__}) lacks; decode greedily or with "
                "graph=False")
        t0 = time.perf_counter()
        saved = [t.clone() for t in state]
        rng = None if generator is None else generator.get_state()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            generator.set_state(rng)
            self.graph.register_generator_state(generator)
        before = launch_counts()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = step()
        self.counts = tuple(a - b for a, b in zip(launch_counts(), before))
        _add_counts([-c for c in self.counts])
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        _add_counts(self.counts)
