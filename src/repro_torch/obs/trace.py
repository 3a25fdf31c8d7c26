"""Phase tracing: named spans on the profiler's timeline.

``span("ingest")`` wraps ``torch.profiler.record_function``, so under a
``torch.profiler.profile`` capture every host-side service phase shows as
a named range, aligned with the device work it launched.  Pass a
``LatencyHistogram`` (``hist=``) to also time the span into it: one
context manager, both sinks.
"""
from __future__ import annotations

import contextlib

import torch


def trace_annotation(name: str):
    """A named range on the profiler's timeline (``record_function``)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, *, hist=None, key=None):
    """Named phase scope.  With ``hist`` the span is timed into it under
    ``key`` and yields the timing handle (call ``.sync(tensor)`` before the
    scope ends to include the device's work); else it only annotates and
    yields None."""
    if hist is not None:
        with hist.timed(key=key, name=name) as handle:
            yield handle
        return
    with trace_annotation(name):
        yield None
