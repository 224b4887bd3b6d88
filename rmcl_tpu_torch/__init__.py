"""rmcl_tpu_torch — the PyTorch / CUDA port of ``rmcl_tpu`` for one NVIDIA H100.

Same module layout and names as the JAX package (``math/se3.py``,
``bvh/bins.py``, ``ops/raycast_binned.py``, ``micp/pipeline.py``, ...), in
PyTorch idiom: frozen dataclasses of tensors instead of pytrees, plain
functions on tensors, and an explicit ``device`` argument (default
``"cuda"``) on every entry point that creates tensors. Pass
``device="cpu"`` to run on the CPU; the hand-written CUDA kernels then fall
to their plain PyTorch versions.

This package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing from ``rmcl_tpu``. Kernels are compiled by ``nvcc`` at their first
use on a CUDA tensor (``rmcl_tpu_torch._build``), never at import.
"""

__version__ = "0.1.0"

from rmcl_tpu_torch.math.se3 import Quaternion, Transform  # noqa: F401
from rmcl_tpu_torch.math.gaussian import CrossStatistics, Gaussian1D  # noqa: F401
