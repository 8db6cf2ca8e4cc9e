from . import base, diff_mc, mcm  # noqa: F401
from .base import Renderer, Scene, make_scene  # noqa: F401
from .factory import MODULES, get_module, make_renderer  # noqa: F401
