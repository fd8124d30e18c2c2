"""The display sink of a cell: it takes the frames the runner hands to a
display and records the wall time of each, writing nothing."""

from __future__ import annotations

import time

import torch

__all__ = ["TimingSink"]


class TimingSink:
    """``push`` records ``time.perf_counter()`` while ``recording``; with
    ``span`` each push is a ``sink.push`` span of the trace."""

    def __init__(self, span: bool = False):
        self.span = span
        self.recording = False
        self.times: list = []

    def push(self, framebuffer) -> None:
        if self.span:
            with torch.profiler.record_function("sink.push"):
                self._push()
        else:
            self._push()

    def _push(self) -> None:
        if self.recording:
            self.times.append(time.perf_counter())
