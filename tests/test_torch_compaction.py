"""Wavefront compaction in the port against the JAX package, on the CPU.

Three layers, each on the same inputs for both packages:

- the exact broad phase of the sort keys, ``nearest_cluster`` in every
  return form and ``nearest_cluster_pair``, against the JAX functions
  called eagerly on coatball's and dragon's cluster boxes, with rays from
  numpy seeds: int32 keys and ids equal on every ray (the chain is sub, mul,
  min, max: nothing a compiler may contract), in
  ``tests/test_torch_compaction_keys_*.py`` and
  ``tests/test_torch_compaction_pair_keys.py``;
- ``_morton_512`` on seeded points: equal;
- the renderer: ``compaction=True`` is a permutation of the rays plus exact
  shortcuts, so its image equals the port's own ``compaction=False`` image
  (RMSE < 1e-7 and equal ray counts, the reference's gate in
  ``tests/test_renderer.py``) on coatball 64x48 and dragon 32x24; dragon's
  other compaction configs stay within 1e-6 of it per pixel
  (``tests/test_torch_compaction_variants.py``); and dragon at
  ``compaction=True, rank_trace=2`` meets the JAX renderer at the golden
  gate of ``tests/test_golden.py`` (RMSE < 1e-3, max difference < 5e-2).

One JAX build of each scene (procedural stand-ins) is carried to the port,
and each (scene, config) is rendered once per test run (the ``renders``
fixture; both in ``torch_port_common.py``).  coatball's configs run the plain
tracers as they are, so a fault in them that depends on the batch or the ray
order shows there.  A traced ray's result depends only on the ray (origin,
direction, seed, segment length), so dragon's configs share one per-ray memo
of the plain tracers: a ray that several configs trace, in whatever order,
is traced once and every config gets the same bits.  Against dragon the tests
catch faults of the renderer (a fold, mask, seed or permutation), not of the
tracers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.cli import main as cli_main
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (compaction_dragon_renderer, compaction_render,
                               compaction_scene,
                               few_torch_threads,  # noqa: F401
                               seeded_rays)


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec)."""
    return {name: compaction_scene(name) for name in ("coatball", "dragon")}


@pytest.fixture(scope="module")
def renders():
    """``render(scene, **config) -> (image, stats)``: one port sample of
    ``scene`` at the given config, each config rendered once per test run;
    coatball on the plain tracers, all of dragon's configs through one
    :class:`MemoTracers`."""
    return compaction_render


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_morton_codes_equal_reference(scenes, scene):
    jdata, _, tdata, _ = scenes[scene]
    o, _, _, _ = seeded_rays(4096, 17, tdata)  # a quarter lie off the box
    got = R._morton_512(o, tdata)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JR._morton_512(_j(o), jdata)))
    assert got.dtype == torch.int32 and int(got.max()) < 1 << 27
    assert len(torch.unique(got)) > 2000


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_compaction_is_a_permutation(renders, scene):
    ref, ref_stats = renders(scene)
    img, stats = renders(scene, compaction=True)
    assert img.max() > 0.01 and np.isfinite(img).all()
    assert rmse(ref, img) < 1e-7
    assert stats["closest_rays"] == ref_stats["closest_rays"]
    assert stats["shadow_rays"] == ref_stats["shadow_rays"]


def test_rank_trace_is_off_without_its_seed_and_on_flat_scenes(scenes,
                                                               renders):
    """As in the reference: a flat scene has no rank path, and a scene with
    a global set needs the miss fold's global pass for the walk's seed."""
    ref, _ = renders("coatball", compaction=True)
    img, stats = renders("coatball", compaction=True, rank_trace=2)
    np.testing.assert_array_equal(img, ref)
    assert "rank_unresolved_b1" not in stats
    _, _, tdata, tspec = scenes["coatball"]
    assert TC._use_flat(tspec.bvh)
    _, _, ddata, dspec = scenes["dragon"]
    closest, _ = R.make_tracers(ddata, dspec, "torch")
    on = RenderConfig(compaction=True, rank_trace=2)
    assert R.make_closest_rank(ddata, dspec, on, "torch", closest)
    for off in (dict(rank_trace=0), dict(host_seed=False),
                dict(cluster_miss_fold=False)):
        cfg = dataclasses.replace(on, **off)
        assert R.make_closest_rank(ddata, dspec, cfg, "torch", closest) is None
    assert R.make_closest_rank(tdata, tspec, on, "torch", closest) is None


def test_dragon_rank_trace_image_matches_reference(renders):
    jr = compaction_dragon_renderer()
    img, stats = renders("dragon", compaction=True, rank_trace=2)
    assert img.shape == (24, 32, 3) and img.max() > 0.01
    assert rmse(jr.image, img) < 1e-3
    assert np.abs(jr.image - img).max() < 5e-2
    assert stats["closest_rays"] == jr.total_closest_rays
    assert stats["shadow_rays"] == jr.total_shadow_rays


def test_config_values_the_port_does_not_carry_raise():
    for key in ("cluster2", "dir12", ""):
        with pytest.raises(TypeError, match="sort_key"):
            RenderConfig(sort_key=key)
    for k in (1, 3):
        with pytest.raises(ValueError, match="rank_trace"):
            RenderConfig(rank_trace=k)
    for knob in ("live_widths", "live_from_bounce", "carry_seed",
                 "shadow_mid_order", "shadow_ray_block_last"):
        with pytest.raises(TypeError):
            RenderConfig(**{knob: getattr(JConfig(), knob)})
    # the compaction fields keep the reference's defaults, compaction aside
    ref = JConfig()
    for name in ("sort_bounces", "cluster_miss_fold", "shadow_sort",
                 "pair_broadphase", "rank_trace", "sort_pack_f16"):
        assert getattr(RenderConfig(), name) == getattr(ref, name), name
    assert ref.compaction and not RenderConfig().compaction


def test_cli_takes_the_compaction_flags(tmp_path):
    out = str(tmp_path / "c.png")
    hdrs = []
    for flags in ([], ["--compaction", "--rank-trace", "2"]):
        hdr = str(tmp_path / f"c{len(flags)}.hdr")
        assert cli_main(["render", "--scene", "teapot", "--size", "32x16",
                         "--device", "cpu", "--spp", "1", "--out", out,
                         "--hdr-out", hdr] + flags) == 0
        hdrs.append(open(hdr, "rb").read())
    assert hdrs[0] == hdrs[1]
    with pytest.raises(SystemExit):
        cli_main(["render", "--rank-trace", "3"])
