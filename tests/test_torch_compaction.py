"""Wavefront compaction in the port against the JAX package, on the CPU.

Three layers, each on the same inputs for both packages:

- the exact broad phase of the sort keys, ``nearest_cluster`` in every
  return form and ``nearest_cluster_pair``, against the JAX functions
  called eagerly on coatball's and dragon's cluster boxes, with rays from
  numpy seeds: int32 keys and ids equal on every ray (the chain is sub, mul,
  min, max: nothing a compiler may contract);
- ``_morton_512`` on seeded points: equal;
- the renderer: ``compaction=True`` is a permutation of the rays plus exact
  shortcuts, so its image equals the port's own ``compaction=False`` image
  (RMSE < 1e-7 and equal ray counts, the reference's gate in
  ``tests/test_renderer.py``) on coatball 64x48 and dragon 32x24; dragon's
  other compaction configs stay within 1e-6 of it per pixel; and dragon at
  ``compaction=True, rank_trace=2`` meets the JAX renderer at the golden
  gate of ``tests/test_golden.py`` (RMSE < 1e-3, max difference < 5e-2).

One JAX build of each scene (procedural stand-ins) is carried to the port,
and each (scene, config) is rendered once per module (the ``renders``
fixture).  coatball's configs run the plain tracers as they are, so a fault
in them that depends on the batch or the ray order shows there.  A traced
ray's result depends only on the ray (origin, direction, seed, segment
length), so dragon's configs share one per-ray memo of the plain tracers: a
ray that several configs trace, in whatever order, is traced once and every
config gets the same bits.  Against dragon the tests catch faults of the
renderer (a fold, mask, seed or permutation), not of the tracers.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu import renderer as JR
from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.io.image import rmse
from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu.types import RenderConfig as JConfig
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.cli import main as cli_main
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.scene import scene_data_from_reference
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (MemoTracers, build_both,  # noqa: F401
                               few_torch_threads, jax_scene_arrays,
                               seeded_rays)

SIZES = {"coatball": (64, 48), "dragon": (32, 24)}
N_RAYS = 768


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec); dragon's JAX
    side is a renderer after 1 spp at ``rank_trace=2`` (the JAX package's
    default wavefront is ``compaction=True``)."""
    out = {"coatball": build_both("coatball", *SIZES["coatball"])}
    w, h = SIZES["dragon"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    try:
        jr = JR.Renderer(jlib.get_scene("dragon", w, h),
                         JConfig(width=w, height=h, rank_trace=2))
    finally:
        mp.undo()
    jr.render(1)
    tdata, tspec = scene_data_from_reference(jax_scene_arrays(jr.data),
                                             jr.spec, "cpu")
    out["dragon"] = (jr.data, jr.spec, tdata, tspec)
    out["dragon_renderer"] = jr
    return out


def _j(x):
    return jnp.asarray(x.numpy())


def _same(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# keyword arguments of nearest_cluster per return form; "max_t" is filled in
FORMS = {
    "id": {},
    "key": dict(return_key=True),
    "second": dict(return_key=True, return_second=1),
    "second_no_key": dict(return_second=1),
    "third_packed": dict(return_key=True, return_second=2,
                         return_packed=True),
    "third_ids": dict(return_key=True, return_second=2),
    "segment": dict(max_t=True),
    "segment_second": dict(max_t=True, return_second=1),
}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_nearest_cluster_equals_reference(scenes, scene, form):
    jdata, jspec, tdata, tspec = scenes[scene]
    o, d, m, mt = seeded_rays(N_RAYS, 3, tdata)
    kw = dict(FORMS[form])
    seg = kw.pop("max_t", False)
    got = BP.nearest_cluster(o, d, m, tdata.clu_planes, tspec.bvh,
                             max_t=mt if seg else None, **kw)
    ref = TP.nearest_cluster(_j(o), _j(d), _j(m), jdata.clu_planes, jspec.bvh,
                             max_t=_j(mt) if seg else None, **kw)
    _same(got, ref)
    first = got[0] if isinstance(got, tuple) else got
    ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
    assert (first[m] < ncp).any() and (first[~m] == ncp).all()


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_nearest_cluster_on_super_boxes_equals_reference(scenes, scene):
    """The last bounce's shadow fold passes the super boxes as clusters."""
    jdata, jspec, tdata, tspec = scenes[scene]
    o, d, m, mt = seeded_rays(N_RAYS, 5, tdata)
    got = BP.nearest_cluster(o, d, m, tdata.sup_planes[:, None, :], tspec.bvh,
                             max_t=mt)
    ref = TP.nearest_cluster(_j(o), _j(d), _j(m),
                             jdata.sup_planes[:, None, :], jspec.bvh,
                             max_t=_j(mt))
    _same(got, ref)


@pytest.mark.parametrize("packed", [False, True], ids=["ids", "packed"])
@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_nearest_cluster_pair_equals_reference(scenes, scene, ranks, packed):
    jdata, jspec, tdata, tspec = scenes[scene]
    o, d_sh, m_sh, mt = seeded_rays(N_RAYS, 31, tdata)
    _, d_nb, m_nb, _ = seeded_rays(N_RAYS, 32, tdata)
    got = BP.nearest_cluster_pair(o, d_sh, mt, m_sh, d_nb, m_nb,
                                  tdata.clu_planes, tspec.bvh, ranks=ranks,
                                  return_packed=packed)
    ref = TP.nearest_cluster_pair(_j(o), _j(d_sh), _j(mt), _j(m_sh), _j(d_nb),
                                  _j(m_nb), jdata.clu_planes, jspec.bvh,
                                  ranks=ranks, return_packed=packed)
    _same(got, ref)
    # and the pair equals the port's two separate calls
    sep = (BP.nearest_cluster(o, d_sh, m_sh, tdata.clu_planes, tspec.bvh,
                              max_t=mt),
           *BP.nearest_cluster(o, d_nb, m_nb, tdata.clu_planes, tspec.bvh,
                               return_key=True, return_second=ranks - 1,
                               return_packed=packed))
    for g, s in zip(got, sep):
        assert torch.equal(g, s)


def test_broadphase_chunks_do_not_change_the_keys(scenes, monkeypatch):
    _, _, tdata, tspec = scenes["dragon"]
    o, d, m, mt = seeded_rays(N_RAYS, 9, tdata)
    kw = dict(return_key=True, return_second=2, return_packed=True)
    whole = BP.nearest_cluster(o, d, m, tdata.clu_planes, tspec.bvh, **kw)
    pair = BP.nearest_cluster_pair(o, d, mt, m, d.flip(0), m,
                                   tdata.clu_planes, tspec.bvh, ranks=3)
    monkeypatch.setattr(BP, "_SWEEP_CHUNK_BYTES", 100 * 344 * 4)
    assert len(list(BP._sweep_chunks(N_RAYS, 344))) == 8
    for a, b in zip(whole, BP.nearest_cluster(o, d, m, tdata.clu_planes,
                                              tspec.bvh, **kw)):
        assert torch.equal(a, b)
    for a, b in zip(pair, BP.nearest_cluster_pair(
            o, d, mt, m, d.flip(0), m, tdata.clu_planes, tspec.bvh, ranks=3)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ranks"):
        BP.nearest_cluster_pair(o, d, mt, m, d, m, tdata.clu_planes,
                                tspec.bvh, ranks=4)


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_morton_codes_equal_reference(scenes, scene):
    jdata, _, tdata, _ = scenes[scene]
    o, _, _, _ = seeded_rays(4096, 17, tdata)  # a quarter lie off the box
    got = R._morton_512(o, tdata)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JR._morton_512(_j(o), jdata)))
    assert got.dtype == torch.int32 and int(got.max()) < 1 << 27
    assert len(torch.unique(got)) > 2000


@pytest.fixture(scope="module")
def renders(scenes):
    """``render(scene, **config) -> (image, stats)``: one port sample of
    ``scene`` at the given config, each config rendered once per module;
    coatball on the plain tracers, all of dragon's configs through one
    :class:`MemoTracers`."""
    memo = MemoTracers(*scenes["dragon"][2:])
    tracers = {"coatball": None, "dragon": (memo.closest, memo.any_hit)}
    images = {}

    def render(scene, **kw):
        tag = (scene, tuple(sorted(kw.items())))
        if tag not in images:
            _, _, tdata, tspec = scenes[scene]
            w, h = SIZES[scene]
            cfg = RenderConfig(width=w, height=h, **kw)
            img, stats = R.render_sample(tdata, tspec, cfg,
                                         R.make_pixel_offsets(cfg), 0,
                                         tracers=tracers[scene])
            images[tag] = (img.numpy(),
                           {k: int(v) for k, v in stats.items()})
        return images[tag]

    return render


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_compaction_is_a_permutation(renders, scene):
    ref, ref_stats = renders(scene)
    img, stats = renders(scene, compaction=True)
    assert img.max() > 0.01 and np.isfinite(img).all()
    assert rmse(ref, img) < 1e-7
    assert stats["closest_rays"] == ref_stats["closest_rays"]
    assert stats["shadow_rays"] == ref_stats["shadow_rays"]


# dragon's other compaction configs, each held to the compaction=True image
VARIANTS = {
    "rank_trace": dict(rank_trace=2),
    "fused_broadphase": dict(fused_broadphase=True),
    "no_pair": dict(pair_broadphase=False),
    "rank_trace_no_pair": dict(rank_trace=2, pair_broadphase=False),
    # the walk off behind K5's keys (they carry no third rank)
    "rank_trace_fused": dict(rank_trace=2, fused_broadphase=True),
    "partition_only": dict(sort_bounces=False),
    "no_miss_fold": dict(cluster_miss_fold=False),
    "no_shadow_sort": dict(shadow_sort=False),
    # the walk with the pair sweep off: its keys from a sweep of their own
    "rank_trace_no_shadow_sort": dict(rank_trace=2, shadow_sort=False),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dragon_compaction_variants_give_the_same_image(renders, variant):
    ref, ref_stats = renders("dragon", compaction=True)
    img, stats = renders("dragon", compaction=True, **VARIANTS[variant])
    np.testing.assert_allclose(img, ref, atol=1e-6)
    assert stats["closest_rays"] == ref_stats["closest_rays"]
    assert stats["shadow_rays"] == ref_stats["shadow_rays"]
    kw = VARIANTS[variant]
    walked = "rank_unresolved_b1" in stats
    assert walked == (kw.get("rank_trace", 0) == 2
                      and not kw.get("fused_broadphase", False))
    if walked:
        # the fallback takes a minority of the sorted bounce rays
        for b in (1, 2):
            assert 0 <= stats[f"rank_unresolved_b{b}"] < 0.2 * 32 * 24


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


def test_dragon_rank_trace_image_matches_reference(scenes, renders):
    jr = scenes["dragon_renderer"]
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
