"""Sample (spp) and tile sharding over processes, one a device.

The port's counterpart of ``metal_raytracing_tpu.parallel.sharding``, with
its names and semantics.  The JAX package runs one controller over a device
mesh (``shard_map``); the port runs one process a device over the default
``torch.distributed`` process group, which the caller initialises
(``torchrun``, or ``torch.multiprocessing`` with an ``init_method``).  One
Python thread driving several cards would serialise their dispatch, and the
renderer is bound by its host dispatch.

- **spp sharding**: every rank renders the same pixels with another sample
  index (rank ``(i, k)`` renders sample ``frame_index * n_spp + k``); one
  ``all_reduce`` over the spp axis gives the mean of the ``n_spp`` samples.
- **tile sharding**: tile rank ``i`` renders the ``i``-th contiguous slice
  of the row-major pixels through ``render_rays``; the image is put
  together on every rank (``all_gather_into_tensor`` under NCCL; under
  other backends, gloo among them, which takes only ``broadcast`` and
  ``all_reduce`` on CUDA tensors, an ``all_reduce`` of a zero-filled full
  image, which is exact: it adds zeros).

Both compose: a 2-D ``(tile, spp)`` mesh shards pixels along one axis and
samples along the other.  The backend is the caller's; nothing here
switches it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..renderer import (Renderer, graphs_apply, pixel_coords, render_rays,
                        render_sample)
from ..scene import SceneData, SceneSpec
from ..types import RenderConfig

__all__ = [
    "Mesh",
    "make_mesh",
    "render_sample_spp_sharded",
    "render_sample_tile_sharded",
    "ShardedRenderer",
]


class Mesh:
    """A ``(tile, spp)`` grid over the first ``tile * spp`` ranks of the
    default process group, tile-major: rank ``i * spp + k`` sits at
    ``(i, k)``, as ``make_mesh``'s ``reshape(tile, spp)`` lays the JAX
    devices out.  It holds the process groups of the whole mesh, of this
    rank's spp row and of its tile column; a rank past the mesh has
    ``coord`` None and no groups."""

    axis_names = ("tile", "spp")

    def __init__(self, tile: int, spp: int):
        n = tile * spp
        self.shape = {"tile": tile, "spp": spp}
        self.size = n
        self.rank = dist.get_rank()
        self.coord = divmod(self.rank, spp) if self.rank < n else None
        # dist.new_group is collective: every rank makes every group
        self.group = dist.new_group(list(range(n)))
        self.spp_group = self.tile_group = None
        for i in range(tile):
            g = dist.new_group([i * spp + k for k in range(spp)])
            if self.coord is not None and self.coord[0] == i:
                self.spp_group = g
        for k in range(spp):
            g = dist.new_group([i * spp + k for i in range(tile)])
            if self.coord is not None and self.coord[1] == k:
                self.tile_group = g
        if self.coord is None:
            self.group = None

    def check_member(self) -> None:
        if self.coord is None:
            raise ValueError(f"rank {self.rank} is not on this "
                             f"{self.shape['tile']}x{self.shape['spp']} "
                             f"mesh")


def make_mesh(n_devices: Optional[int] = None, tile: int = 1,
              spp: int = 0) -> Mesh:
    """Build a (tile, spp) mesh over the first ``n_devices`` ranks of the
    default process group (all of them by default); ``spp=0`` puts every
    remaining rank on the spp axis.  Every rank of the group must call it,
    in the same order as any other ``new_group``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group: "
                           "call torch.distributed.init_process_group first")
    n = n_devices or dist.get_world_size()
    if n > dist.get_world_size():
        raise ValueError(f"{n} devices asked of a group of "
                         f"{dist.get_world_size()}")
    if spp == 0:
        if n % tile:
            raise ValueError(f"{n} devices not divisible by tile={tile}")
        spp = n // tile
    if tile * spp != n:
        raise ValueError(f"mesh {tile}x{spp} != {n} devices")
    return Mesh(tile, spp)


def _reduce_stats(stats, group) -> dict:
    """Every stat summed over ``group``, in the stats' (deterministic)
    order."""
    for v in stats.values():
        dist.all_reduce(v, group=group)
    return stats


def render_sample_spp_sharded(data: SceneData, spec: SceneSpec,
                              cfg: RenderConfig, offsets: torch.Tensor,
                              frame_index: int, mesh: Mesh,
                              tracer: str = "torch", baked_tables=None):
    """Render ``n_spp`` samples at once: the rank at spp coordinate k renders
    sample ``frame_index * n_spp + k``; returns ((H, W, 3) mean of the
    ``n_spp`` samples, the same on every rank of the spp row; stats summed
    over the row).  ``tracer`` and ``baked_tables`` as ``render_sample``."""
    mesh.check_member()
    n_spp = mesh.shape["spp"]
    img, stats = render_sample(data, spec, cfg, offsets,
                               frame_index * n_spp + mesh.coord[1], tracer,
                               baked_tables=baked_tables)
    img = img.contiguous()
    dist.all_reduce(img, group=mesh.spp_group)
    return img / n_spp, _reduce_stats(stats, mesh.spp_group)


def render_sample_tile_sharded(data: SceneData, spec: SceneSpec,
                               cfg: RenderConfig, offsets: torch.Tensor,
                               frame_index: int, mesh: Mesh,
                               tracer: str = "torch", baked_tables=None):
    """Render one sample with the row-major pixels cut into ``n_tile``
    contiguous slices along the tile axis (and, on a 2-D mesh, ``n_spp``
    samples along the spp axis, averaged); returns ((H, W, 3) image, put
    together on every rank; stats summed over the mesh).  Requires ``H*W``
    divisible by ``n_tile`` and each slice a multiple of
    ``cfg.ray_block``, as the reference does."""
    mesh.check_member()
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    n = cfg.height * cfg.width
    if n % n_tile:
        raise ValueError(f"{n} pixels not divisible by {n_tile} tiles")
    shard = n // n_tile
    if shard % cfg.ray_block:
        raise ValueError(f"pixel shard {shard} not a multiple of ray_block "
                         f"{cfg.ray_block}")
    i, k = mesh.coord
    px, py = pixel_coords(cfg, offsets.device)
    sl = slice(i * shard, (i + 1) * shard)
    radiance, stats = render_rays(data, spec, cfg, px[sl], py[sl],
                                  offsets[sl], frame_index * n_spp + k,
                                  tracer, baked_tables=baked_tables)
    if n_spp > 1:
        radiance = radiance.contiguous()
        dist.all_reduce(radiance, group=mesh.spp_group)
        radiance = radiance / n_spp
    if dist.get_backend(mesh.tile_group) == "nccl":
        full = torch.empty((n, 3), dtype=radiance.dtype,
                           device=radiance.device)
        dist.all_gather_into_tensor(full, radiance.contiguous(),
                                    group=mesh.tile_group)
    else:
        full = torch.zeros((n, 3), dtype=radiance.dtype,
                           device=radiance.device)
        full[sl] = radiance
        dist.all_reduce(full, group=mesh.tile_group)
    return (full.reshape(cfg.height, cfg.width, 3),
            _reduce_stats(stats, mesh.group))


class ShardedRenderer(Renderer):
    """Progressive renderer over a mesh of ranks, one process a device.

    ``mode="spp"`` replicates the pixels and shards the samples;
    ``mode="tile"`` shards the pixels along the mesh's tile axis and the
    samples along its spp axis.  Each sharded step advances by ``n_spp``
    samples.  ``device`` defaults to ``cuda:{LOCAL_RANK}``; a caller may
    give another, several ranks on one card among them.  Checkpoints store
    total samples, so they move between sharded and plain renderers (of
    either package); rank 0 writes them.

    The steps run eagerly, never as CUDA graphs
    (``renderer.graphs_apply(..., sharded=True)``): gloo stages every
    ``all_reduce`` through the host, which no graph can hold."""

    def __init__(self, scene, cfg: RenderConfig, mesh: Mesh,
                 mode: str = "spp", device=None):
        if mode not in ("spp", "tile"):
            raise ValueError(f"mode must be 'spp' or 'tile', got {mode!r}")
        mesh.check_member()
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        super().__init__(scene, cfg, device)
        self.mesh = mesh
        self.mode = mode
        self.samples_per_step = mesh.shape["spp"]
        self.graphed = graphs_apply(cfg, self.device, self.tracer,
                                    sharded=True)

    def step(self, k: Optional[int] = None) -> None:
        """Advance ``k`` sharded steps (``k * samples_per_step`` samples;
        default ``samples_per_dispatch`` steps, as in the JAX package), each
        folded into the average as the reference's sharded step does."""
        k = self.samples_per_dispatch if k is None else k
        render = (render_sample_spp_sharded if self.mode == "spp"
                  else render_sample_tile_sharded)
        n = self.samples_per_step
        for _ in range(k):
            sample, stats = render(self.data, self.spec, self.cfg,
                                   self.offsets, self.frame_index, self.mesh,
                                   self.tracer, baked_tables=self.baked)
            # the sample is already the mean of n consecutive samples
            fif = float(np.float32(self.frame_index) * np.float32(n))
            self.accum.copy_((self.accum * fif + sample * n) / (fif + n))
            self.ray_totals.add_(torch.stack(
                [stats["closest_rays"], stats["shadow_rays"]]).float())
            self.frame_index += 1

    @property
    def total_samples(self) -> int:
        return self.frame_index * self.samples_per_step

    def _set_total_samples(self, total: int) -> None:
        """Checkpoints store total samples; a sharded renderer resumes only
        at a whole step."""
        if total % self.samples_per_step:
            raise ValueError(
                f"checkpoint holds {total} samples, not a multiple of this "
                f"mesh's {self.samples_per_step} samples/step — resume in a "
                f"plain Renderer or on a matching mesh")
        self.frame_index = total // self.samples_per_step

    def render(self, spp: Optional[int] = None) -> np.ndarray:
        """Render until ``spp`` total samples are in the average (default
        cfg.spp), in batches of ``samples_per_dispatch`` whole sharded
        steps with an exact remainder; returns the (H, W, 3) average."""
        spp = self.cfg.spp if spp is None else spp
        while self.total_samples < spp:
            steps_left = -(-(spp - self.total_samples)
                           // self.samples_per_step)
            self.step(min(self.samples_per_dispatch, steps_left))
        return self.image

    def save(self, path: str) -> None:
        """Rank 0 writes the checkpoint; every rank of the mesh returns
        once it is written."""
        if self.mesh.rank == 0:
            super().save(path)
        dist.barrier(group=self.mesh.group)
