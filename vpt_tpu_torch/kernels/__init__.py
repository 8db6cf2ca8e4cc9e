"""Hand-written CUDA kernels of the port, one module each, with their plain
PyTorch versions and launch counters (``LAUNCHES``).  The CUDA sources are
in ``vpt_tpu_torch/csrc/``; ``_build`` compiles them at first use."""

from . import mcm_event, tf1d, tonemap_kernel  # noqa: F401
