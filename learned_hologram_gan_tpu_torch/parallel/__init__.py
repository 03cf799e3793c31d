"""Multi-device training and propagation (counterpart of
``learned_hologram_gan_tpu/parallel``): meshes of ranks and the sharding
helpers (``mesh.py``), autograd-aware collectives (``collectives.py``),
the row-sharded pencil FFT (``fft.py``) and a host launcher (``launch.py``).
"""

from .mesh import (
    Mesh,
    batch_sharding,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    pad_batch_to_devices,
    replicate_state,
    shard_batch,
    shard_distance_stack,
)

__all__ = [
    "Mesh",
    "batch_sharding",
    "initialize_distributed",
    "make_hybrid_mesh",
    "make_mesh",
    "pad_batch_to_devices",
    "replicate_state",
    "shard_batch",
    "shard_distance_stack",
]
