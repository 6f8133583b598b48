"""The tests' stand-in for ``torch.cuda.CUDAGraph``: the CPU has no
graphs, so :class:`RerunGraph` plays one behind
``svecalign_tpu_torch.utils.programs.CudaGraph``'s interface. Pass it as
``graph_type`` to a ``Programs``, an encoder or a ``Transcriber``."""

from svecalign_tpu_torch.ops import _build
from svecalign_tpu_torch.utils import trace


class RerunGraph:
    """Capture runs the function into the static output; a replay runs it
    again from the static inputs and writes the same output, as a graph's
    replay overwrites its output, with its launches uncounted and its
    spans unopened as a graph's are."""

    captures = []  # (device, graph) of every capture, in order

    @staticmethod
    def arena(device):
        return None

    @staticmethod
    def arena_bytes(device, arena):
        return 0

    def __init__(self, device, arena):
        self.device = device

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        self.fn = fn
        self.out = fn()
        RerunGraph.captures.append((self.device, self))
        return self.out

    def replay(self):
        # a graph's replay runs no Python: the launches the function counts
        # are the capture's, counted by the program cache, and its spans
        # are not opened
        with _build.holding_launches(), trace.holding():
            self.out.copy_(self.fn())
