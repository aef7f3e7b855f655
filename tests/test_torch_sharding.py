"""Sample and tile sharding in the port (``metal_raytracing_tpu_torch
.parallel``, on ``torch.distributed``) against its plain renderer and the
JAX package's checkpoints, on the CPU.

The counterpart of ``tests/test_sharding.py``, whose 8 virtual JAX devices
become processes: one spawn of four gloo ranks (``tests/
torch_sharding_worker.py``, which imports no JAX) renders plane_sphere
32x32, two bounces, on meshes of two ranks (the first two of the group) and
of four, and writes rank 0's results; the tests here compare them with the
plain ``Renderer`` and ``render_sample`` (the tolerances of
``tests/test_sharding.py``):

- tile-sharded, 2 and 4 tiles: the plain sample (atol 1e-6), and equal ray
  counts;
- spp-sharded, 2 and 4 ranks: the mean of the plain samples (atol 1e-5);
- the 2-D ``tile=2, spp=2`` mesh: the mean of two plain samples;
- the progressive spp and tile renderers, and two sharded steps in one
  ``step(k=2)``: the plain ``Renderer`` (RMSE < 1e-5);
- a sharded checkpoint resumes in the port's plain ``Renderer`` and loads in
  the JAX ``Renderer`` (fingerprint and sample count equal); a checkpoint
  that is not a whole number of steps is rejected.
"""

import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_sharding_worker as W
from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.renderer import Renderer as JRenderer
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch.parallel import make_mesh
from metal_raytracing_tpu_torch.renderer import (Renderer,
                                                 make_pixel_offsets,
                                                 render_sample)
from torch_port_common import few_torch_threads  # noqa: F401

WORLD = 4
DEADLINE = 300  # seconds the spawned ranks may take


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Rank 0's results of one spawn of ``WORLD`` gloo ranks, and the
    directory of its checkpoints."""
    out = tmp_path_factory.mktemp("sharded")
    ranks = mp.start_processes(W.run, args=(WORLD, f"file://{out}/rendezvous",
                                            str(out)),
                               nprocs=WORLD, start_method="spawn", join=False)
    start = time.monotonic()
    while not ranks.join(timeout=5):
        if time.monotonic() - start > DEADLINE:
            for proc in ranks.processes:
                proc.kill()
            pytest.fail(f"the {WORLD} ranks did not end in {DEADLINE} s")
    with np.load(out / "results.npz") as f:
        return {k: f[k] for k in f.files}, out


@pytest.fixture(scope="module")
def plain():
    """The plain samples 0..3 ((H, W, 3) numpy) and their stats."""
    cfg = W.config()
    data, spec = W.scene().build(device="cpu")
    offsets = make_pixel_offsets(cfg)
    return [render_sample(data, spec, cfg, offsets, k) for k in range(4)]


def _mean(samples):
    return np.mean([np.asarray(s[0], np.float64) for s in samples], axis=0)


@pytest.mark.parametrize("tiles", [2, 4])
def test_tile_sharded_matches_plain_sample(sharded, plain, tiles):
    res, _ = sharded
    ref, ref_stats = plain[0]
    got = res[f"tile{tiles}"]
    assert got.shape == (W.SIZE, W.SIZE, 3) and got.max() > 0.01
    np.testing.assert_allclose(got, ref.numpy(), atol=1e-6)
    for k in ("closest_rays", "shadow_rays"):
        assert int(res[f"tile{tiles}.{k}"]) == int(ref_stats[k])


@pytest.mark.parametrize("ranks", [2, 4])
def test_spp_sharded_matches_sequential_mean(sharded, plain, ranks):
    res, _ = sharded
    np.testing.assert_allclose(res[f"spp{ranks}"], _mean(plain[:ranks]),
                               atol=1e-5)
    assert int(res[f"spp{ranks}.closest_rays"]) == sum(
        int(s[1]["closest_rays"]) for s in plain[:ranks])


def test_2d_mesh_tile_and_spp(sharded, plain):
    res, _ = sharded
    np.testing.assert_allclose(res["tile2spp2"], _mean(plain[:2]), atol=1e-5)


def test_sharded_renderers_progressive(sharded):
    res, _ = sharded
    for label, spp in (("progressive_spp", 8), ("progressive_tile", 4),
                       ("step2_spp", 8)):
        ref = Renderer(W.scene(), W.config(), device="cpu").render(spp)
        assert rmse(res[label], ref) < 1e-5, label


def test_sharded_checkpoint_moves_across_renderers_and_packages(sharded):
    _, out = sharded
    path = str(out / "sharded.npz")
    plain_r = Renderer(W.scene(), W.config(), device="cpu")
    plain_r.load(path)
    assert plain_r.total_samples == 4
    plain_r.render(2)
    ref = Renderer(W.scene(), W.config(), device="cpu").render(6)
    assert rmse(plain_r.image, ref) < 1e-5
    cfg = W.config()
    mp_ = pytest.MonkeyPatch()
    mp_.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
                jproc.make_model(n))
    try:
        jr = JRenderer(jlib.get_scene("plane_sphere", W.SIZE, W.SIZE),
                       JConfig(width=cfg.width, height=cfg.height,
                               max_bounces=cfg.max_bounces,
                               ray_block=cfg.ray_block))
    finally:
        mp_.undo()
    jr.load(path)  # checks the fingerprint
    assert jr.total_samples == 4
    assert jr.fingerprint() == plain_r.fingerprint()


def test_sharded_resume_rejects_partial_step(sharded):
    res, _ = sharded
    msg = str(res["partial_error"])
    assert "samples" in msg and "3" in msg, msg


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(tile=1)
