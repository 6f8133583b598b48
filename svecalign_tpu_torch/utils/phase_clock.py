"""The phase timer of the port's profiled paths (the batched aligner,
the kNN search)."""

import os
from time import perf_counter

import torch


class PhaseClock:
    """Adds the wall time since the last mark to ``sink[name]``; off unless
    the environment variable ``env`` is "1" (a mark then synchronises the
    device, so that each phase's device work lands in its own entry)."""

    def __init__(self, device: torch.device, sink: dict, env: str):
        self.on = os.environ.get(env) == "1"
        self.device, self.sink = device, sink
        self.t = perf_counter()

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = perf_counter()
        self.sink[name] = self.sink.get(name, 0.0) + now - self.t
        self.t = now
