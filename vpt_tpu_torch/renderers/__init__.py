from . import base, depth, diff_mc, eam, iso, mcm, mcs, mip  # noqa: F401
from .base import Renderer, Scene, make_scene  # noqa: F401
from .factory import MODULES, get_module, make_renderer  # noqa: F401
