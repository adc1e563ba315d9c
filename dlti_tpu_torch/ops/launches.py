"""The kernels' launch counters, and their bookkeeping around CUDA graphs.

Each kernel wrapper adds one to its module's counter where it launches its
kernel. A graph replay launches the captured kernels without running the
wrappers, so whoever captures a graph takes back what the capture counted
(:meth:`GraphLaunches.capturing`) and credits each replay with it
(:meth:`GraphLaunches.credit`): the counters then say how many times each
kernel ran. The serving engine's decode graph and the trainer's step graph
share this.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

from dlti_tpu_torch.ops import flash_attention, paged_attention

COUNTERS = (
    (paged_attention, "launches"), (paged_attention, "launches_int8"),
    (flash_attention, "fwd_launches"), (flash_attention, "dq_launches"),
    (flash_attention, "dkv_launches"),
)


def counts() -> List[int]:
    return [getattr(m, name) for m, name in COUNTERS]


class GraphLaunches:
    """The launches of one captured graph, credited per replay."""

    def __init__(self):
        self.per_replay = [0] * len(COUNTERS)

    @contextlib.contextmanager
    def capturing(self) -> Iterator[None]:
        """Around a capture: afterwards the counters read as before it, and
        what the capture added is what each replay will add."""
        before = counts()
        try:
            yield
        finally:
            after = counts()
            for (module, name), n in zip(COUNTERS, before):
                setattr(module, name, n)
        self.per_replay = [a - b for a, b in zip(after, before)]

    def credit(self, replays: int) -> None:
        for (module, name), n in zip(COUNTERS, self.per_replay):
            setattr(module, name, getattr(module, name) + replays * n)
