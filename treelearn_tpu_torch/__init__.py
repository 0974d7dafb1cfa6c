"""treelearn_tpu_torch: the PyTorch / CUDA port of treelearn_tpu.

Same module layout as the JAX package (``ops/``, ``model/``, ``pipeline/``,
``io/``, ``data/``, ``config.py``); every Pallas kernel on the segmentation
path is a hand-written CUDA kernel for Hopper (``csrc/``), built at first use
and bound with ctypes (ops/_cuda.py).  Each kernel's plain PyTorch version
sits in the same module and runs for CPU tensors only.

Entry points take a ``device`` argument and default to ``"cuda"``; without a
card they raise unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
