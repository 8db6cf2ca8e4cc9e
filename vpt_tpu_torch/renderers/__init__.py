from . import base, depth, diff_mc, dos, eam, iso, lao, mcm, mcs  # noqa: F401
from . import mip  # noqa: F401
from .base import Renderer, Scene, make_scene  # noqa: F401
from .factory import MODULES, get_module, make_renderer  # noqa: F401
