"""Asynchronous checkpoint writer for in-fit periodic checkpointing
(counterpart of :mod:`tame.io.async_ckpt`).

The write of a snapshot overlaps the next fit segment: ``save`` copies
every tensor to fresh host memory (the only synchronous part) and the
native-store write runs on a background thread.  At most one write is in
flight: a new ``save`` first joins the previous one, so the checkpoint
directory is never written concurrently and the atomic rename of
:func:`tame_torch.io.save_checkpoint` holds.

Torch tensors are mutable, JAX arrays are not: the engines update their
buffers in place in the next segment, and ``.cpu()`` of a CPU tensor (or
``.numpy()``) is the same memory.  So the snapshot is a copy, made before
``save`` returns.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


class AsyncCheckpointer:
    """Overlapped checkpoint writes through
    :func:`tame_torch.io.save_checkpoint`::

        ckptr = AsyncCheckpointer()
        for segment in ...:
            state = run_segment(...)
            ckptr.save(ckpt_dir, state_dict)   # returns after the copy
        ckptr.wait()                            # join the last write

    Exceptions from the background write re-raise on the next
    ``save``/``wait``.
    """

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    @staticmethod
    def _snapshot(value: Any) -> Any:
        """A host copy of ``value`` that shares no memory with it."""
        if isinstance(value, dict):
            return {k: AsyncCheckpointer._snapshot(v)
                    for k, v in value.items()}
        if isinstance(value, torch.Tensor):
            return value.detach().to("cpu", copy=True).numpy()
        if isinstance(value, np.ndarray):
            return value.copy()
        return value

    def save(self, ckpt_dir, state: Dict[str, Any]) -> None:
        """Queue a checkpoint write; blocks only for a still-running
        previous write and the copy of ``state`` to host memory."""
        from tame_torch.io.checkpoint import save_checkpoint

        self._join()
        snapshot = self._snapshot(state)

        def _write() -> None:
            try:
                save_checkpoint(ckpt_dir, snapshot)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight write (if any) completes."""
        self._join()
