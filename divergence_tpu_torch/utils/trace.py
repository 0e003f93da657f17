"""Spans of the port's layers on the profiler's clock.

:class:`span` times a block into a ``RunSummary`` stage of the same name
(through ``summary.stage``, so the labels and their accumulation are the
summary's own) and, while a ``torch.profiler`` is recording, also opens
``torch.profiler.record_function`` under that name: a ``user_annotation``
event in the profiler's chrome trace, on the same clock as the card's
kernels and copies, so that a gap in the card's work carries the name of
the span the host was in.  With no profiler recording a span costs one
check of the profiler's state and no ``record_function``.  Tracing is on
exactly when a profiler runs, as under the CLI's ``--profile``.
"""

from __future__ import annotations

import torch
import torch.profiler


class span:  # noqa: N801  (used as a function: ``with span(name, summary):``)
    """The block as span ``name``: its wall time added to
    ``summary.timings_s[name]`` through ``summary.stage(name)`` where
    ``summary`` is given, and a ``record_function`` range where a profiler
    is recording.  A class, not a generator, so that a span with no
    summary and no profiler costs the guard and two plain calls."""

    __slots__ = ("_name", "_stage", "_record")

    def __init__(self, name: str, summary=None):
        self._name = name
        self._stage = None if summary is None else summary.stage(name)
        self._record = None

    def __enter__(self):
        if self._stage is not None:
            self._stage.__enter__()
        if torch._C._autograd._profiler_enabled():
            self._record = torch.profiler.record_function(self._name)
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._record.__exit__(*exc)
        if self._stage is not None:
            return self._stage.__exit__(*exc)
        return False
