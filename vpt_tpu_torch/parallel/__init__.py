"""Multi-card rendering and fitting over ``torch.distributed`` (part 1 of
``vpt_tpu/parallel/``: pixel-row data parallelism, sharded volumes between
frames, the bucketed gradient reduction).  ``halo``, ``halo_grad``,
``dos_halo`` and ``resident`` come with their kernels (ROADMAP queue 1
item 16, parts 2 and 3)."""

from .mesh import make_mesh, pixel_sharding, replicated  # noqa: F401
from .shard import (  # noqa: F401
    gather_state, place_state, shard_display, shard_render_frame,
    sharded_scene, volume_sharding,
)
