"""The ranks of ``tests/test_torch_sharding.py``: one spawned process a
rank, over gloo on the CPU.  This module imports torch and the port only,
so that each spawned rank starts without JAX."""

import os

import numpy as np
import torch
import torch.distributed as dist

SIZE = 32
BOUNCES = 2


def config():
    from metal_raytracing_tpu_torch.types import RenderConfig

    return RenderConfig(width=SIZE, height=SIZE, max_bounces=BOUNCES,
                        ray_block=128)


def scene():
    from metal_raytracing_tpu_torch.scenes import get_scene

    return get_scene("plane_sphere", SIZE, SIZE)


def run(rank: int, world: int, init: str, out: str) -> None:
    """Rank ``rank`` of ``world``: every mesh of the test, rank 0 writing
    each result under ``out``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from metal_raytracing_tpu_torch.parallel import (
        ShardedRenderer, make_mesh, render_sample_spp_sharded,
        render_sample_tile_sharded)
    from metal_raytracing_tpu_torch.renderer import (Renderer,
                                                     make_pixel_offsets)

    cfg = config()
    sc = scene()
    data, spec = sc.build(device="cpu")
    offsets = make_pixel_offsets(cfg)
    results = {}

    def keep(name, img, stats=None):
        results[name] = np.asarray(img)
        for k, v in (stats or {}).items():
            results[f"{name}.{k}"] = np.asarray(int(v))

    # (label, devices, tile, spp, sharded sample); a mesh of two leaves
    # ranks 2 and 3 out, but they make its groups with the others
    for label, n, tile, spp, fn in (
            ("tile2", 2, 2, 1, render_sample_tile_sharded),
            ("spp2", 2, 1, 2, render_sample_spp_sharded),
            ("tile4", 4, 4, 1, render_sample_tile_sharded),
            ("spp4", 4, 1, 4, render_sample_spp_sharded),
            ("tile2spp2", 4, 2, 2, render_sample_tile_sharded)):
        mesh = make_mesh(n, tile=tile, spp=spp)
        if mesh.coord is not None:
            img, stats = fn(data, spec, cfg, offsets, 0, mesh)
            keep(label, img, stats)

    spp_mesh = make_mesh(4, tile=1, spp=4)
    r = ShardedRenderer(sc, cfg, spp_mesh, mode="spp", device="cpu")
    keep("progressive_spp", r.render(8))
    assert r.total_samples == 8
    tile_r = ShardedRenderer(sc, cfg, make_mesh(4, tile=2, spp=2),
                             mode="tile", device="cpu")
    keep("progressive_tile", tile_r.render(4))
    assert tile_r.total_samples == 4
    # two sharded steps in one call: 2 x 4 samples
    batch_r = ShardedRenderer(sc, cfg, spp_mesh, mode="spp", device="cpu")
    batch_r.step(k=2)
    assert batch_r.total_samples == 8
    keep("step2_spp", batch_r.image)

    # a sharded checkpoint (one step, 4 samples), written by rank 0
    ck = ShardedRenderer(sc, cfg, spp_mesh, mode="spp", device="cpu")
    ck.render(4)
    ck.save(os.path.join(out, "sharded.npz"))
    # a plain checkpoint of 3 samples does not resume on a mesh of 4
    if rank == 0:
        plain = Renderer(sc, cfg, device="cpu")
        plain.render(3)
        plain.save(os.path.join(out, "plain3.npz"))
    dist.barrier()
    try:
        ck.load(os.path.join(out, "plain3.npz"))
        results["partial_error"] = np.asarray("")
    except ValueError as e:
        results["partial_error"] = np.asarray(str(e))
    if rank == 0:
        np.savez(os.path.join(out, "results.npz"), **results)
    dist.barrier()
    dist.destroy_process_group()
