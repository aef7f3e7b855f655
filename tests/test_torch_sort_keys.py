"""The sort layouts and knobs of the JAX renderer's wavefront (M1b) in the
port, on the CPU.

- Every ``sort_key`` layout (``cluster3``, ``cluster2_nodir``,
  ``cluster1_dir9``, ``cluster1_hit``, ``dir6``, ``dir9``,
  ``dir6_cluster``, ``hybrid``, ``dir_major``) and the knobs
  ``sort_primary``, ``sort_last_bounce``, ``shadow_key2``,
  ``shadow_hit_key``, ``shadow_sort_primary`` and ``bounce_hit_key_from``
  only reorder the rays, so each gives the ``compaction=False`` image
  (RMSE < 1e-7, the reference's gate in ``tests/test_renderer.py``) and the
  same ray counts, on coatball 32x32 (flat, its plain tracers as they are)
  and dragon 32x24 (hierarchical, one per-ray memo of the plain tracers),
  two bounces.
- ``sort_pack_f16`` rounds the throughput and radiance to f16 once a sort:
  its image against the JAX renderer's ``sort_pack_f16`` image at the
  golden gate, its packing bit-equal to the JAX package's ``_pack2f16``.
- Each key's bit layout against a numpy transcription of the cited JAX
  lines (``metal_raytracing_tpu/renderer.py``) on dragon's recorded
  bounce-1 rays.
- The gating of the rank walk and the pair sweep as the reference's
  ``_rank_at_sort`` and ``_pair_at`` decide it.
- The knobs still unported (ROADMAP's deliberate list) still raise
  ``TypeError``, and only they.
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
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.types import SORT_KEYS, RenderConfig
from torch_port_common import (MemoTracers, assert_image_gate,  # noqa: F401
                               build_both, few_torch_threads, record_passes)

SIZES = {"coatball": (32, 32), "dragon": (32, 24)}
BOUNCES = 2
# label -> config keywords on top of compaction=True; every layout, and
# every knob at least once
LAYOUTS = {
    "cluster3": dict(sort_key="cluster3"),
    "cluster2_nodir": dict(sort_key="cluster2_nodir", shadow_key2=True),
    "cluster1_dir9": dict(sort_key="cluster1_dir9", shadow_hit_key=True),
    "cluster1_hit": dict(sort_key="cluster1_hit", sort_primary=True),
    "dir6": dict(sort_key="dir6"),
    "dir9": dict(sort_key="dir9", shadow_sort_primary=True),
    "dir6_cluster": dict(sort_key="dir6_cluster", sort_last_bounce=False),
    "hybrid": dict(sort_key="hybrid", sort_primary=True),
    "dir_major": dict(sort_key="dir_major"),
    "cluster2 knobs": dict(sort_primary=True, shadow_sort_primary=True,
                           shadow_key2=True, bounce_hit_key_from=1,
                           rank_trace=2),
    "cluster2 fused": dict(fused_broadphase=True, shadow_key2=True,
                           sort_primary=True, shadow_sort_primary=True),
}
# ROADMAP.md's list of knobs deliberately not ported
UNPORTED = ("visit_pairs", "visit_pairs2", "shadow_mid_order", "live_widths",
            "live_from_bounce", "carry_seed", "shadow_ray_block_last")


@pytest.fixture(scope="module")
def scenes():
    return {name: build_both(name, *SIZES[name]) for name in SIZES}


@pytest.fixture(scope="module")
def renders(scenes):
    """``render(scene, fresh=False, **config) -> (image, stats)``: one port
    sample, each config once per module unless ``fresh``; dragon's configs
    through one memo."""
    memo = MemoTracers(*scenes["dragon"][2:])
    tracers = {"coatball": None, "dragon": (memo.closest, memo.any_hit)}
    images = {}

    def render(scene, fresh=False, **kw):
        tag = (scene, tuple(sorted(kw.items())))
        if fresh or tag not in images:
            _, _, tdata, tspec = scenes[scene]
            w, h = SIZES[scene]
            cfg = RenderConfig(width=w, height=h, max_bounces=BOUNCES, **kw)
            img, stats = R.render_sample(tdata, tspec, cfg,
                                         R.make_pixel_offsets(cfg), 0,
                                         tracers=tracers[scene])
            images[tag] = (img.numpy(), {k: int(v) for k, v in stats.items()})
        return images[tag]

    return render


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_every_layout_gives_the_unsorted_image(renders, scene):
    ref, ref_stats = renders(scene)
    assert ref.max() > 0.01
    assert set(SORT_KEYS) <= {kw.get("sort_key", "cluster2")
                              for kw in LAYOUTS.values()} | {"cluster1"}
    for label, kw in LAYOUTS.items():
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
    """dragon's recorded bounce-1 pass: (o, d, mask, prev_tri) and its
    shadow segments (o, d, max_t, mask), at compaction=False (the two
    passes in the primary pass's ray order)."""
    _, _, tdata, tspec = scenes["dragon"]
    w, h = SIZES["dragon"]
    cfg = RenderConfig(width=w, height=h, max_bounces=BOUNCES)
    calls = record_passes(tdata, tspec, cfg)
    o0, d0, m0, seed0 = calls["closest"][0]
    _, prev_tri = TC.closest_flat_ref(o0, d0, m0, tdata.tri_planes,
                                      tspec.bvh, seed0)
    o, d, m, _ = calls["closest"][1]
    return tdata, tspec, (o, d, m, prev_tri), calls["any"][1]


def _jax_cluster_key(sort_key, cid, cid2, cid3, d, m, nc_tot, use_hit):
    """renderer.py:546-575 and :684-706, in numpy int32."""
    want2 = sort_key in ("cluster2", "cluster2_nodir", "cluster3")
    want3 = sort_key == "cluster3"
    if use_hit:
        want2 = want3 = False
    cbits = max(1, nc_tot.bit_length())
    db = (3 if sort_key == "cluster1_dir9"
          else 0 if sort_key == "cluster2_nodir" else 2)
    avail = 30 - cbits - 3 * db
    c2bits = min(cbits, max(0, avail)) if want2 else 0
    avail -= c2bits
    c3bits = min(cbits, max(0, avail)) if want3 else 0
    avail -= c3bits
    mbits = max(0, avail)
    shift = 30 - cbits
    key = cid << shift
    if c2bits:
        shift -= c2bits
        key = key | ((cid2 & ((1 << c2bits) - 1)) << shift)
    if c3bits:
        shift -= c3bits
        key = key | ((cid3 & ((1 << c3bits) - 1)) << shift)
    if db:
        lvl = 1 << (db - 1)
        q = np.clip(((d + np.float32(1.0)) * np.float32(lvl)).astype(np.int32),
                    0, 2 * lvl - 1)
        dirq = (q[:, 0] << (2 * db)) | (q[:, 1] << db) | q[:, 2]
        shift -= 3 * db
        key = key | (dirq << shift)
    return key | (m >> max(0, 27 - mbits))


def _jax_direction_key(sort_key, d, m, prev_tri, cluster_size):
    """renderer.py:728-759, in numpy int32."""
    octant = ((d[:, 0] > 0).astype(np.int32)
              + 2 * (d[:, 1] > 0).astype(np.int32)
              + 4 * (d[:, 2] > 0).astype(np.int32))
    if sort_key == "hybrid":
        return ((m >> 21) << 24) | (octant << 21) | (m & 0x1FFFFF)
    if sort_key in ("dir6", "dir9", "dir6_cluster"):
        bits = 3 if sort_key == "dir9" else 2
        lv = 1 << (bits - 1)
        q = np.clip(((d + np.float32(1.0)) * np.float32(lv)).astype(np.int32),
                    0, 2 * lv - 1)
        dirq = (q[:, 0] << (2 * bits)) | (q[:, 1] << bits) | q[:, 2]
        if sort_key == "dir6_cluster":
            clu_bin = np.clip(prev_tri, 0, 2 ** 30) // cluster_size
            return ((dirq << 24) | ((clu_bin & 0x3FF) << 14)
                    | ((m >> 13) & 0x3FFF))
        return (dirq << (30 - 3 * bits)) | (m >> (3 * bits - 3))
    return (octant << 27) | m


def test_bounce_key_bits_match_reference(bounce1):
    tdata, tspec, (o, d, m, prev_tri), _ = bounce1
    ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
    cid, _, cid2, cid3 = BP.nearest_cluster(o, d, m, tdata.clu_planes,
                                            tspec.bvh, return_key=True,
                                            return_second=2)
    mort = R._morton_512(o, tdata)
    n = lambda x: x.numpy()  # noqa: E731
    assert (n(cid)[n(m)] < ncp).any() and (n(cid3)[n(m)] < ncp).any()
    for key in SORT_KEYS:
        if key.startswith("cluster"):
            for use_hit in (False, True):
                bits = R.cluster_key_bits(key, ncp, use_hit)
                got = R.cluster_key(bits, cid, cid2 if bits[1] else None,
                                    cid3 if bits[2] else None, d, mort)
                want = _jax_cluster_key(key, n(cid), n(cid2), n(cid3), n(d),
                                        n(mort), ncp, use_hit)
                np.testing.assert_array_equal(n(got), want, err_msg=key)
                assert (n(got) < 2 ** 30).all()
        else:
            got = R.direction_key(key, d, mort, prev_tri,
                                  tspec.bvh.cluster_size)
            want = _jax_direction_key(key, n(d), n(mort), n(prev_tri),
                                      tspec.bvh.cluster_size)
            np.testing.assert_array_equal(n(got), want, err_msg=key)
            assert len(np.unique(want)) > 16, key


def test_shadow_key_bits_match_reference(bounce1):
    """renderer.py:1306-1316: (segment's nearest cluster, second nearest
    with shadow_key2, light, origin Morton)."""
    tdata, tspec, _, (so, sd, smt, sm) = bounce1
    ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
    scid, scid2 = BP.nearest_cluster(so, sd, sm, tdata.clu_planes, tspec.bvh,
                                     max_t=smt, return_second=1)
    mort = R._morton_512(so, tdata)
    lcount = tspec.light_count
    light = torch.from_numpy(np.random.RandomState(2).randint(
        0, lcount, so.shape[0]).astype(np.int32))
    bits_l = max(1, (lcount - 1).bit_length())
    for key2 in (False, True):
        got = R.shadow_cluster_key(scid, scid2 if key2 else None, light,
                                   mort, ncp, bits_l).numpy()
        cbits_s = max(1, ncp.bit_length())
        c2bits_s = min(cbits_s, max(0, 30 - cbits_s - bits_l)) if key2 else 0
        mbits_s = max(0, 30 - cbits_s - c2bits_s - bits_l)
        want = ((scid.numpy() << (30 - cbits_s))
                | (light.numpy() << mbits_s))
        if c2bits_s:
            want = want | ((scid2.numpy() & ((1 << c2bits_s) - 1))
                           << (mbits_s + bits_l))
        want = want | (mort.numpy() >> max(0, 27 - mbits_s))
        np.testing.assert_array_equal(got, want)
        assert (got < 2 ** 30).all()


def test_rank_walk_and_pair_sweep_follow_reference_gating(renders,
                                                          monkeypatch):
    """``_rank_at_sort`` and ``_pair_at`` of the reference: the rank walk
    only behind cluster2's exact keys, where a sort runs and before
    bounce_hit_key_from; the pair sweep only where both its keys are the
    exact cluster2 ones and its bounce re-sorts the shadow rays."""
    pairs = []
    pair = R.nearest_cluster_pair
    monkeypatch.setattr(R, "nearest_cluster_pair",
                        lambda *a, **k: pairs.append(1) or pair(*a, **k))
    base = dict(compaction=True, rank_trace=2)
    cases = (  # (keywords, rank walk at bounces 0 / 1, pair sweeps)
        ({}, (False, True), 0),
        (dict(sort_primary=True), (True, True), 0),
        (dict(sort_key="cluster1"), (False, False), 0),
        (dict(bounce_hit_key_from=1), (False, False), 0),
        (dict(sort_last_bounce=False), (False, False), 0),
        (dict(shadow_sort_primary=True), (False, True), 1),
        (dict(shadow_sort_primary=True, shadow_key2=True), (False, True), 0),
        (dict(shadow_sort_primary=True, shadow_hit_key=True), (False, True),
         0),
    )
    for kw, walks, n_pairs in cases:
        del pairs[:]
        _, stats = renders("dragon", fresh=True, **base, **kw)
        got = tuple(f"rank_unresolved_b{b}" in stats for b in range(BOUNCES))
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
    assert set(SORT_KEYS) >= {"cluster2", "cluster1", "cluster1_dir9",
                              "cluster1_hit", "cluster2_nodir", "cluster3",
                              "dir6", "dir9", "dir6_cluster", "hybrid",
                              "dir_major"}
    with pytest.raises(ValueError, match="sort_key"):
        RenderConfig(sort_key="dir12")
