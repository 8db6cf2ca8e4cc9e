"""vpt_tpu_torch: the PyTorch/CUDA port of ``vpt_tpu`` for NVIDIA Hopper.

The first slice is the MCM forward render: ``make_scene`` →
``make_renderer("mcm").render_progressive`` → ``display`` → a tone mapper,
with three hand-written CUDA kernels (``kernels/``): the MCM event machine,
the 1D transfer-function lookup and the tone-map display pass.  The second
is the differentiable MCM fit, ``train.fit_mc`` over
``renderers/diff_mc``, whose volume fetch runs the corner-gather kernel
forward and the corner-scatter kernel backward.  Every kernel has a plain
PyTorch version in the same module, which CPU tensors take.

The package imports ``torch`` and never ``jax``; ``vpt_tpu`` is its
reference in the tests.
"""

__version__ = "0.1.0"

from . import environment, math3d, rng, sampling, scene  # noqa: F401
from . import skipgrid, tonemap, train, transfer, volume  # noqa: F401
from .scene import CameraState, Node, PerspectiveCamera  # noqa: F401
from .scene import Transform, default_camera  # noqa: F401
from .volume import Volume  # noqa: F401
