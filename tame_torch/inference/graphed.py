"""The unsharded fit loops' iterations on the card as CUDA graph replays
(:class:`LoopRunner`).

``cavi.fit_loop`` and ``smoothed.fit_cavi_smoothed`` hand the runner their
step (state -> new state) and their diagnostics (state -> the stacked
``[elbo, mse]``) and keep their own loop: the spans, the readback, the
stopping rule and the histories.  Where the graphs engage
(:func:`engages`: a card, more than one iteration, a step that a capture
can hold) the runner

* runs each function's first call eagerly on a side stream: a real
  iteration, which also creates the libraries' handles and workspaces for
  that stream and loads the kernels, as a capture needs;
* captures the step's second call into a graph that reads the state from
  static buffers and copies the new state back into them as its last
  nodes, and the diagnostics' second call (once the state is static) into
  a graph whose output is a static (2,) tensor;
* replays them for every later call.

A replay runs the captured kernels with the same arguments in the same
order, so a graphed fit gives the eager fit's bits; the host's share of
an iteration becomes one launch of each graph where the eager step
enqueues ~1,300 kernels at n=2000.  Each replayed step counts one
``graphed_iters`` (:mod:`tame_torch.utils.profiling`), and each replay
adds the launches its capture counted to the kernels' ``launches``
counters, and makes again the counts its capture made (``k5_contracts``),
so they count what ran.

Graphs capture into one memory pool per card, kept for the process by a
one-kernel anchor graph and shared by the loops' graphs one fit at a time
(a fit's graphs are dropped when it returns, their blocks back in the
pool for the next fit's capture).  A pool made per fit is given back to
the driver only when the allocator's cache is emptied, so pools would
pile up over a run of fits until a capture, which may not empty the
cache, runs out of memory; and a pool that no live graph holds cannot be
captured into again (the pinned-memory allocator asserts on it in torch
2.11), so a ``torch.cuda.MemPool`` alone does not keep one.  The capture
neither synchronises nor empties the cache (``torch.cuda.graph`` does both
on entry, once per fit).
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from tame_torch.utils import profiling


class _Card(NamedTuple):
    stream: torch.cuda.Stream     # the side stream graphed loops run on
    anchor: torch.cuda.CUDAGraph  # holds the pool their graphs share


_CARDS: Dict[int, _Card] = {}


def engages(device: torch.device, max_iter: int,
            capturable: bool = True) -> bool:
    """Whether a fit loop's iterations run as graph replays: its state is
    on a card, it may run more than one iteration (a graph pays off from
    the second) and a capture can hold its step.  Every update mode's step
    can, masked or not, and the smoothed steps on K4 (none makes a host
    sync; ``tests/test_torch_graphed.py`` runs them under CUDA's sync
    debug mode); the associative-scan smoother's cannot (MAGMA's batched
    Cholesky solve makes a call a capturing stream refuses).  The sharded
    loops (:mod:`tame_torch.parallel`) have their own loops and stay
    eager."""
    return device.type == "cuda" and max_iter > 1 and capturable


def _card(device: torch.device) -> _Card:
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    card = _CARDS.get(index)
    if card is None:
        dev = torch.device("cuda", index)
        stream = torch.cuda.Stream(dev)
        anchor = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            torch.zeros(1, device=dev)  # the fill kernel loaded, then held
            anchor.capture_begin(capture_error_mode="thread_local")
            torch.zeros(1, device=dev)
            anchor.capture_end()
        card = _CARDS[index] = _Card(stream, anchor)
    return card


def _kernels() -> List[Callable]:
    """The kernel wrappers whose ``launches`` the counters read."""
    return [getattr(importlib.import_module(f"tame_torch.ops.{module}"), fn)
            for module, fn in profiling.KERNELS]


class _Graph:
    """One call ``fn(arg)`` (then ``tail(out)``) captured on the current
    stream into ``pool`` and replayed once: its graph, its output and the
    kernel launches and program counts the capture counted."""

    def __init__(self, fn: Callable, arg, pool, tail=None):
        kernels = _kernels()
        before = [k.launches for k in kernels]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            with profiling.counts_made() as self.counts:
                out = fn(arg)
                if tail is not None:
                    tail(out)
                    out = None
        except BaseException:
            with contextlib.suppress(RuntimeError):
                self.graph.capture_end()
            raise
        self.graph.capture_end()
        self.graph.replay()
        self.out = out
        self.launches: List[Tuple[Callable, int]] = [
            (k, k.launches - b) for k, b in zip(kernels, before)
            if k.launches != b]

    def replay(self) -> None:
        """A replay after the first, whose launches the capture counted."""
        self.graph.replay()
        for kernel, k in self.launches:
            kernel.launches += k
        for name, k in self.counts.items():
            profiling.count(name, k)


class LoopRunner:
    """A fit loop's state and its iterations: :meth:`step` advances
    ``state`` by one update, :meth:`diagnostics` returns the stacked
    ``[elbo, mse]`` of ``state`` on the device.  ``graphed=False`` calls
    the functions eagerly on the current stream; ``graphed=True``
    (:func:`engages`) runs them as the module describes.  Use it as a
    context manager: on exit the caller's stream waits for the side
    stream and the fit's graphs are dropped."""

    def __init__(self, step: Callable, diagnostics: Callable, state,
                 graphed: bool):
        self._fns = (step, diagnostics)
        self.state = state
        self._graphs: List[Optional[_Graph]] = [None, None]
        self._calls = [0, 0]
        self._card = _card(state[0].device) if graphed else None
        if self._card is not None:
            self._pool = self._card.anchor.pool()
            self._main = torch.cuda.current_stream(state[0].device)
            self._card.stream.wait_stream(self._main)

    def __enter__(self) -> "LoopRunner":
        return self

    def __exit__(self, *exc) -> bool:
        if self._card is not None:
            self._main.wait_stream(self._card.stream)
            self._graphs = [None, None]
        return False

    def _store(self, new) -> None:
        for static, value in zip(self.state, new):
            static.copy_(value)

    def step(self) -> None:
        step = self._fns[0]
        if self._card is None:
            self.state = step(self.state)
            return
        graph = self._graphs[0]
        with torch.cuda.stream(self._card.stream):
            if graph is not None:
                graph.replay()
            elif self._calls[0] == 0:
                self.state = step(self.state)
            else:
                self.state = type(self.state)(*(t.clone()
                                                for t in self.state))
                self._graphs[0] = _Graph(step, self.state, self._pool,
                                         tail=self._store)
        if self._calls[0] > 0:
            profiling.count(profiling.GRAPHED_ITERS)
        self._calls[0] += 1

    def diagnostics(self) -> torch.Tensor:
        diag = self._fns[1]
        if self._card is None:
            return diag(self.state)
        graph = self._graphs[1]
        with torch.cuda.stream(self._card.stream):
            if graph is not None:
                graph.replay()
                out = graph.out
            elif self._graphs[0] is None or self._calls[1] == 0:
                out = diag(self.state)
            else:
                self._graphs[1] = _Graph(diag, self.state, self._pool)
                out = self._graphs[1].out
        self._calls[1] += 1
        self._main.wait_stream(self._card.stream)
        return out
