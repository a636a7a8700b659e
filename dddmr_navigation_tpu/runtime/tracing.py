"""Profiling/observability — SURVEY.md §5: the reference's tracing is
ad-hoc gettimeofday blocks + rviz visualization topics; the JAX
equivalents are ``jax.profiler`` traces and host-side debug dumps.

  * :func:`trace` — context manager around a tick window writing a
    TensorBoard-loadable XLA trace.
  * :class:`DebugDumper` — npz dumps of named arrays per tick (the
    "visualization topics as observability" role: dGraph clouds,
    trajectory fans, particle clouds become saved arrays a notebook or
    the rviz bridge can render).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/trace'): step(...)`` → XLA profile in log_dir."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class DebugDumper:
    """Per-tick named-array dumps (ring of ``keep`` files)."""

    def __init__(self, directory: str, keep: int = 32, enabled: bool = True):
        self.directory = directory
        self.keep = keep
        self.enabled = enabled
        self._written: list[str] = []
        if enabled:
            os.makedirs(directory, exist_ok=True)

    def dump(self, tick: int, **arrays) -> str | None:
        if not self.enabled:
            return None
        path = os.path.join(self.directory, f"tick_{tick:08d}.npz")
        np.savez(path, **{k: np.asarray(v) for k, v in arrays.items()})
        self._written.append(path)
        while len(self._written) > self.keep:
            old = self._written.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass
        return path
