"""The port's runtime: the rendering context, camera animators,
checkpoints and the render profiler."""

from . import animators, checkpoint, profiler  # noqa: F401
from .animators import CircleAnimator, OrbitCameraAnimator  # noqa: F401
from .context import RenderingContext  # noqa: F401
from .profiler import RenderProfiler  # noqa: F401
