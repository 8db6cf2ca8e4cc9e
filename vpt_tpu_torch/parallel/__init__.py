"""Multi-card rendering and fitting over ``torch.distributed``: pixel-row
data parallelism and sharded volumes between frames (``shard``, ``mesh``,
``distributed``, the bucketed gradient reduction of ``overlap``), and the
spatially sharded volume (``halo``: slabs sampled by ownership masking;
``halo_grad``: their gradient; ``dos_halo``: DOS's occlusion halo;
``resident``: photons resident on the rank that owns their next sample,
migrating between slab owners through K5's resident instance)."""

from .mesh import make_mesh, pixel_sharding, replicated  # noqa: F401
from .shard import (  # noqa: F401
    gather_state, place_state, shard_display, shard_render_frame,
    sharded_scene, volume_sharding,
)
from .resident import (  # noqa: F401
    assemble, resident_render_frame, resident_reset, shard_volume_cyclic,
    slab_owner,
)
