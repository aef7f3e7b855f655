"""Rendering over several devices with ``torch.distributed`` (the port's
counterpart of ``metal_raytracing_tpu.parallel``)."""

from .sharding import (  # noqa: F401
    Mesh,
    ShardedRenderer,
    make_mesh,
    render_sample_spp_sharded,
    render_sample_tile_sharded,
)
