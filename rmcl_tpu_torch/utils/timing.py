"""Per-stage timing: the MEASURE_TIMES equivalent.

Counterpart of ``rmcl_tpu.utils.timing.StageTimer`` (the rest of that
module — the relay readback ``sync``, the stopwatch, trace capture and
``timeit_device`` — is not ported). On the card, PyTorch returns before the
device finishes, so a stage that names the tensors it produced ends in
``torch.cuda.synchronize()`` when one of them lies on a CUDA device, and
its time is the device's.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch


def _on_cuda(tree) -> bool:
    """Whether a tensor in ``tree`` (a tensor, a dataclass of tensors or a
    list, tuple or dict of them) lies on a CUDA device."""
    if isinstance(tree, torch.Tensor):
        return tree.device.type == "cuda"
    if isinstance(tree, dict):
        return any(_on_cuda(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_on_cuda(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return any(_on_cuda(getattr(tree, f)) for f in tree.__dataclass_fields__)
    return False


class StageTimer:
    """Named-stage accumulator with an EMA and totals. Pass ``block_on``
    (what the stage produced, or a callable returning it) to time device
    work: the stage then ends in ``torch.cuda.synchronize()`` when that lies
    on the card."""

    def __init__(self, ema_alpha: float = 0.1):
        self.alpha = ema_alpha
        self.ema: Dict[str, float] = {}
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            tree = block_on() if callable(block_on) else block_on
            if tree is not None and _on_cuda(tree):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.total[name] += dt
            self.count[name] += 1
            self.ema[name] = (dt if name not in self.ema
                              else (1 - self.alpha) * self.ema[name] + self.alpha * dt)

    def mean(self, name: str) -> float:
        c = self.count.get(name, 0)
        return self.total[name] / c if c else 0.0

    def report(self) -> str:
        lines = []
        for name in sorted(self.total):
            lines.append(
                f"{name:30s} mean {self.mean(name)*1e3:8.2f} ms  "
                f"ema {self.ema.get(name, 0)*1e3:8.2f} ms  n={self.count[name]}"
            )
        return "\n".join(lines)
