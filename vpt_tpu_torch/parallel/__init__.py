"""Multi-card rendering and fitting over ``torch.distributed``: pixel-row
data parallelism and sharded volumes between frames (``shard``, ``mesh``,
``distributed``, the bucketed gradient reduction of ``overlap``), and the
spatially sharded volume (``halo``: slabs sampled by ownership masking;
``halo_grad``: their gradient; ``dos_halo``: DOS's occlusion halo).
``resident`` comes with K5's photon-migration entry points (ROADMAP queue
1 item 16, part 3)."""

from .mesh import make_mesh, pixel_sharding, replicated  # noqa: F401
from .shard import (  # noqa: F401
    gather_state, place_state, shard_display, shard_render_frame,
    sharded_scene, volume_sharding,
)
