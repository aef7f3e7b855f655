"""The bounce and shadow sort keys of the port's wavefront, on the CPU.

- The bounce sort only reorders the rays, so each sorting config gives the
  ``compaction=False`` image (RMSE < 1e-7, the reference's gate in
  ``tests/test_renderer.py``) and the same ray counts, on coatball 32x32
  (flat, its plain tracers as they are) and dragon 32x24 (hierarchical,
  one per-ray memo of the plain tracers), two bounces: the cluster key
  (the JAX renderer's ``cluster2`` layout), the ``dir_major`` fallback
  (forced by lowering ``renderer._MAX_KEY_CLUSTERS`` below the scene's
  padded cluster count), the rank walk's keys and K5's fused keys.
- ``sort_pack_f16`` rounds the throughput and radiance to f16 once a sort:
  its image against the JAX renderer's ``sort_pack_f16`` image at the
  golden gate, its packing bit-equal to the JAX package's ``_pack2f16``.
- Each key's bit layout against a numpy transcription of the cited JAX
  lines (``metal_raytracing_tpu/renderer.py``) on dragon's recorded
  bounce-1 rays.
- The gating of the rank walk and the pair sweep on the options that
  remain.
- The knobs not ported (ROADMAP's deliberate list, the JAX renderer's sort
  study among them) raise ``TypeError``, and only they.
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
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (MemoTracers, assert_image_gate,  # noqa: F401
                               build_both, few_torch_threads, record_passes)

SIZES = {"coatball": (32, 32), "dragon": (32, 24)}
BOUNCES = 2
# label -> config keywords on top of compaction=True (None: the dir_major
# fallback, cluster keys switched off)
LAYOUTS = {
    "cluster2": {},
    "dir_major": None,
    "rank_trace": dict(rank_trace=2),
    "fused": dict(fused_broadphase=True),
}
# ROADMAP.md's list of knobs deliberately not ported: the TPU schedule
# knobs, then the options of the JAX renderer's sort study
UNPORTED = ("visit_pairs", "visit_pairs2", "shadow_mid_order", "live_widths",
            "live_from_bounce", "carry_seed", "shadow_ray_block_last",
            "sort_key", "bounce_hit_key_from", "shadow_hit_key_from",
            "shadow_hit_key", "shadow_key2", "sort_primary",
            "sort_last_bounce", "shadow_sort_primary")


@pytest.fixture(scope="module")
def scenes():
    return {name: build_both(name, *SIZES[name]) for name in SIZES}


@pytest.fixture(scope="module")
def renders(scenes):
    """``render(scene, fresh=False, **config) -> (image, stats)``: one port
    sample at ``BOUNCES`` bounces unless the config says otherwise, each
    config once per module unless ``fresh`` (then not kept); dragon's
    configs through one memo."""
    memo = MemoTracers(*scenes["dragon"][2:])
    tracers = {"coatball": None, "dragon": (memo.closest, memo.any_hit)}
    images = {}

    def render(scene, fresh=False, **kw):
        tag = (scene, tuple(sorted(kw.items())))
        if fresh or tag not in images:
            _, _, tdata, tspec = scenes[scene]
            w, h = SIZES[scene]
            cfg = RenderConfig(**{"width": w, "height": h,
                                  "max_bounces": BOUNCES, **kw})
            img, stats = R.render_sample(tdata, tspec, cfg,
                                         R.make_pixel_offsets(cfg), 0,
                                         tracers=tracers[scene])
            got = (img.numpy(), {k: int(v) for k, v in stats.items()})
            if fresh:
                return got
            images[tag] = got
        return images[tag]

    return render


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_every_layout_gives_the_unsorted_image(scenes, renders, monkeypatch,
                                               scene):
    ref, ref_stats = renders(scene)
    assert ref.max() > 0.01
    tdata = scenes[scene][2]
    ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
    for label, kw in LAYOUTS.items():
        if kw is None:
            with monkeypatch.context() as mp:
                mp.setattr(R, "_MAX_KEY_CLUSTERS", ncp - 1)
                assert not R._cluster_keys_fit(tdata)
                img, stats = renders(scene, fresh=True, compaction=True)
        else:
            img, stats = renders(scene, compaction=True, **kw)
        assert rmse(ref, img) < 1e-7, label
        for k in ("closest_rays", "shadow_rays"):
            assert stats[k] == ref_stats[k], (label, k)


def test_sort_pack_f16_matches_reference(scenes, renders):
    """The packed sort rounds to f16 (2^-11 relative) once a bounce sort:
    the image moves, within the golden gate of the JAX renderer's."""
    jdata, jspec, _, _ = scenes["coatball"]
    w, h = SIZES["coatball"]
    jcfg = JConfig(width=w, height=h, max_bounces=BOUNCES, sort_pack_f16=True)
    ref, _ = JR.render_sample(jdata, jspec, jcfg, JR.make_pixel_offsets(jcfg),
                              jnp.int32(0))
    img, _ = renders("coatball", compaction=True, sort_pack_f16=True)
    assert_image_gate(img, np.asarray(ref), "coatball sort_pack_f16")
    unpacked, _ = renders("coatball")
    err = rmse(unpacked, img)
    assert 0 < err < 1e-3  # the rounding shows, and stays small
    rng = np.random.RandomState(5)
    vals = np.concatenate([rng.normal(0, 3, 64), [0.0, -0.0, 1e-6, 7e4,
                                                  -65504.0, 1.0 / 3]])
    a = vals.astype(np.float32)
    b = a[::-1].copy()
    got = R._pack2f16(torch.from_numpy(a), torch.from_numpy(b))
    want = JR._pack2f16(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, r in zip(R._unpack2f16(got), JR._unpack2f16(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def bounce1(scenes):
    """dragon's recorded bounce-1 pass: (o, d, mask) and its shadow
    segments (o, d, max_t, mask), at compaction=False."""
    _, _, tdata, tspec = scenes["dragon"]
    w, h = SIZES["dragon"]
    cfg = RenderConfig(width=w, height=h, max_bounces=BOUNCES)
    calls = record_passes(tdata, tspec, cfg)
    o, d, m, _ = calls["closest"][1]
    return tdata, tspec, (o, d, m), calls["any"][1]


def _jax_cluster_key(cid, cid2, d, m, nc_tot):
    """renderer.py:546-575 and :684-706 for the cluster2 layout, in numpy
    int32."""
    cbits = max(1, nc_tot.bit_length())
    db = 2
    avail = 30 - cbits - 3 * db
    c2bits = min(cbits, max(0, avail))
    avail -= c2bits
    mbits = max(0, avail)
    shift = 30 - cbits
    key = cid << shift
    if c2bits:
        shift -= c2bits
        key = key | ((cid2 & ((1 << c2bits) - 1)) << shift)
    lvl = 1 << (db - 1)
    q = np.clip(((d + np.float32(1.0)) * np.float32(lvl)).astype(np.int32),
                0, 2 * lvl - 1)
    dirq = (q[:, 0] << (2 * db)) | (q[:, 1] << db) | q[:, 2]
    shift -= 3 * db
    key = key | (dirq << shift)
    return key | (m >> max(0, 27 - mbits))


def _jax_direction_key(d, m):
    """renderer.py:728-759 for the dir_major layout, in numpy int32."""
    octant = ((d[:, 0] > 0).astype(np.int32)
              + 2 * (d[:, 1] > 0).astype(np.int32)
              + 4 * (d[:, 2] > 0).astype(np.int32))
    return (octant << 27) | m


def test_bounce_key_bits_match_reference(bounce1):
    tdata, tspec, (o, d, m) = bounce1[:3]
    ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
    cid, _, cid2 = BP.nearest_cluster(o, d, m, tdata.clu_planes, tspec.bvh,
                                      return_key=True, return_second=1)
    mort = R._morton_512(o, tdata)
    n = lambda x: x.numpy()  # noqa: E731
    assert (n(cid)[n(m)] < ncp).any() and (n(cid2)[n(m)] < ncp).any()
    got = R.cluster_key(R.cluster_key_bits(ncp), cid, cid2, d, mort)
    want = _jax_cluster_key(n(cid), n(cid2), n(d), n(mort), ncp)
    np.testing.assert_array_equal(n(got), want)
    assert (n(got) < 2 ** 30).all()
    got = R.direction_key(d, mort)
    want = _jax_direction_key(n(d), n(mort))
    np.testing.assert_array_equal(n(got), want)
    assert len(np.unique(want)) > 16


def test_shadow_key_bits_match_reference(bounce1):
    """renderer.py:1306-1316: (segment's nearest cluster, light, origin
    Morton)."""
    tdata, tspec, _, (so, sd, smt, sm) = bounce1
    ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
    scid = BP.nearest_cluster(so, sd, sm, tdata.clu_planes, tspec.bvh,
                              max_t=smt)
    mort = R._morton_512(so, tdata)
    lcount = tspec.light_count
    light = torch.from_numpy(np.random.RandomState(2).randint(
        0, lcount, so.shape[0]).astype(np.int32))
    bits_l = max(1, (lcount - 1).bit_length())
    got = R.shadow_cluster_key(scid, light, mort, ncp, bits_l).numpy()
    cbits_s = max(1, ncp.bit_length())
    mbits_s = max(0, 30 - cbits_s - bits_l)
    want = ((scid.numpy() << (30 - cbits_s)) | (light.numpy() << mbits_s)
            | (mort.numpy() >> max(0, 27 - mbits_s)))
    np.testing.assert_array_equal(got, want)
    assert (got < 2 ** 30).all()


def test_rank_walk_and_pair_sweep_follow_reference_gating(renders,
                                                          monkeypatch):
    """``_rank_at_sort`` and ``_pair_at`` of the reference: the rank walk
    only behind the exact broad phase's keys (not K5's fused ones) where a
    bounce sort runs; the pair sweep only at a bounce that re-sorts its
    shadow rays by the exact cluster key and has a sorted bounce after it
    (so at bounce 1 of 3, never with 2 bounces)."""
    pairs = []
    pair = R.nearest_cluster_pair
    monkeypatch.setattr(R, "nearest_cluster_pair",
                        lambda *a, **k: pairs.append(1) or pair(*a, **k))
    base = dict(compaction=True, rank_trace=2)
    cases = (  # (keywords, rank walk at each bounce, pair sweeps)
        ({}, (False, True), 0),
        (dict(fused_broadphase=True), (False, False), 0),
        (dict(sort_bounces=False), (False, False), 0),
        (dict(max_bounces=3), (False, True, True), 1),
        (dict(max_bounces=3, shadow_sort=False), (False, True, True), 0),
        (dict(max_bounces=3, pair_broadphase=False), (False, True, True), 0),
        (dict(max_bounces=3, fused_broadphase=True), (False, False, False),
         0),
    )
    for kw, walks, n_pairs in cases:
        del pairs[:]
        _, stats = renders("dragon", fresh=True, **base, **kw)
        got = tuple(f"rank_unresolved_b{b}" in stats
                    for b in range(len(walks)))
        assert got == walks, (kw, got)
        assert len(pairs) == n_pairs, (kw, len(pairs))


def test_only_the_deliberate_knobs_raise():
    port = {f.name for f in dataclasses.fields(RenderConfig)}
    ref = {f.name for f in dataclasses.fields(JConfig)}
    assert port <= ref
    assert ref - port == set(UNPORTED), sorted(ref - port)
    for knob in UNPORTED:
        with pytest.raises(TypeError):
            RenderConfig(**{knob: getattr(JConfig(), knob)})
