"""The traversal kernels' options in the port's plain versions, on the
CPU.

- the per-ray visits in the render stats (``RenderConfig.telemetry``)
  equal the walking plain versions' on the recorded passes, and the kernel
  wrappers' CPU path gives them;
- ``counts`` (the chunk skip) leaves every walking plain version's result
  and visits unchanged, and the renderer's image with ``chunk_skip``;
- supers wider than 32 clusters: the walking plain versions against brute
  force, and a model of the hierarchical kernels' order state inside a
  super (the last pick's entry and index in place of a visited mask)
  against the mask walk;
- ``utils.profiling``: a trace holding the renderer's scope names, and
  ``timed``.
"""

import json

import pytest
import torch

from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.io import procedural as tproc
from metal_raytracing_tpu_torch.ops import rank_cuda as RK
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.ops.broadphase_cuda import (nearest_cluster,
                                                            slab_entry)
from metal_raytracing_tpu_torch.scene import build_scene_data
from metal_raytracing_tpu_torch.scenes import library as tlib
from metal_raytracing_tpu_torch.types import RenderConfig
from metal_raytracing_tpu_torch.utils import profiling
from torch_port_common import few_torch_threads  # noqa: F401
from torch_port_common import assert_near_ties, seeded_rays

W, H = 16, 16


@pytest.fixture(scope="module")
def procedural():
    """The port's scenes from the procedural stand-ins."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tlib, "resolve_model", lambda n, prefer_file=True:
               tproc.make_model(n))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def dragon(procedural):
    """(data, spec) of the port's dragon build (sah_free)."""
    s = tlib.get_scene("dragon", W, H)
    return build_scene_data(s.instances, s.lights, s.camera(), device="cpu")


def test_visits_equal_walking_plain_versions(dragon):
    """The stats' per-ray visits are the visits of the pass they name."""
    tdata, tspec = dragon
    cfg = RenderConfig(width=W, height=H, telemetry=True)
    closest, any_hit = R.make_tracers(tdata, tspec, "torch",
                                      count_visits=True)
    calls = {"closest": [], "any": []}

    def rec_closest(o, d, m, seed, seed_base=None):
        calls["closest"].append((o.contiguous(), d, m, seed))
        return closest(o, d, m, seed, seed_base)

    def rec_any(o, d, mt, m):
        calls["any"].append((o, d, mt, m))
        return any_hit(o, d, mt, m)

    _, stats = R.render_sample(tdata, tspec, cfg, R.make_pixel_offsets(cfg),
                               0, tracers=(rec_closest, rec_any))
    tabs = (tdata.sup_planes, tdata.clu_planes, tdata.tri_planes, tspec.bvh)
    for b, (o, d, m, seed) in enumerate(calls["closest"]):
        _, _, visits = TC.closest_hier_ref(o, d, m, *tabs, seed)
        assert torch.equal(stats[f"visits_b{b}"], visits)
        assert int(visits.max()) >= 2
    for b, (o, d, mt, m) in enumerate(calls["any"]):
        _, visits = TC.any_hier_ref(o, d, mt, m, *tabs)
        assert torch.equal(stats[f"shadow_visits_b{b}"], visits)
    # the kernel wrappers on CPU tensors: the walking plain versions
    o, d, m, seed = calls["closest"][1]
    hit, visits = TC.trace_closest(o, d, m, *tabs, seed, count_visits=True)
    assert torch.equal(visits, stats["visits_b1"])
    assert TC.trace_closest(o, d, m, *tabs, seed).tri.shape == hit.tri.shape


_CHUNKED = {}


def chunked(scene):
    """The port's ``sah_chunk`` build of ``scene`` (partly full clusters)."""
    if scene not in _CHUNKED:
        s = tlib.get_scene(scene, W, H)
        _CHUNKED[scene] = build_scene_data(s.instances, s.lights, s.camera(),
                                           builder="sah_chunk", device="cpu")
    return _CHUNKED[scene]


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_chunk_skip_leaves_the_walks(procedural, scene):
    data, spec = chunked(scene)
    bvh = spec.bvh
    assert bvh.partial_clusters
    counts = data.clu_counts
    assert (counts[:bvh.num_clusters] < bvh.cluster_size).any()
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, bvh)
    o, d, m, mt = seeded_rays(1024, 11, data)
    seed = TC.global_seed_keys(o, d, m, data.tri_planes, bvh)
    for fn, args in ((TC.closest_walk_ref, (o, d, m, *tabs, seed)),
                     (TC.any_walk_ref, (o, d, mt, m, *tabs))):
        ref = fn(*args)
        got = fn(*args, counts=counts)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
    if not TC._use_flat(bvh):
        keys = nearest_cluster(o, d, m, data.clu_planes, bvh,
                               return_key=True, return_second=2,
                               return_packed=True)[1:]
        cand = list(keys[:2])
        ref = RK.closest_rank_walk_ref(o, d, m, cand, data.tri_planes, bvh,
                                       seed)
        got = RK.closest_rank_walk_ref(o, d, m, cand, data.tri_planes, bvh,
                                       seed, counts=counts)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)
        for x, y in zip(RK.closest_rank_ref(o, d, m, cand, data.tri_planes,
                                            bvh, seed, counts), ref[:2]):
            assert torch.equal(x, y)
    if scene != "coatball":
        return
    # the renderer with chunk_skip: the same image
    cfg = RenderConfig(width=W, height=H, chunk_skip=True)
    off = R.make_pixel_offsets(cfg)
    img, _ = R.render_sample(data, spec, cfg, off, 0)
    ref, _ = R.render_sample(data, spec, RenderConfig(width=W, height=H),
                             off, 0)
    assert torch.equal(img, ref)


@pytest.fixture(scope="module")
def wide(procedural):
    """coatball clustered two triangles a cluster (median): 6,386 clusters,
    supers of 56, tables of a few MB."""
    s = tlib.get_scene("coatball", W, H)
    data, spec = build_scene_data(s.instances, s.lights, s.camera(),
                                  cluster_size=2, builder="median",
                                  device="cpu")
    s_per, _ = TC.super_layout(spec.bvh)
    assert s_per > TC.SHARED_PER_SUPER and not TC._use_flat(spec.bvh)
    return data, spec


def test_wide_super_walks_match_brute_force(wide):
    data, spec = wide
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    o, d, m, mt = seeded_rays(1500, 5, data)
    seed = TC.global_seed_keys(o, d, m, data.tri_planes, spec.bvh)
    t, tri, visits = TC.closest_hier_ref(o, d, m, *tabs, seed)
    rt, rtri = TC.closest_flat_ref(o, d, m, data.tri_planes, spec.bvh, seed)
    live = m.numpy()
    assert_near_ties(o, d, tri.numpy(), rtri.numpy(), live, data.tri_planes)
    same = tri == rtri
    assert int(same.sum()) >= 0.999 * len(live)
    assert torch.equal(t[same], rt[same])
    assert int(visits.max()) > 4
    occ, _ = TC.any_hier_ref(o, d, mt, m, *tabs)
    assert torch.equal(occ, TC.any_flat_ref(o, d, mt, m, data.tri_planes,
                                            spec.bvh))


def _order_state_walk(o, d, seed, data, spec):
    """One ray's closest walk with the hierarchical kernels' state: the
    super mask, and inside a super the (entry bits, index) of the last pick,
    the next pick being the nearest box after it (``csrc/trace_hier.cu``).
    Returns (t_chop, tri, visits)."""
    bvh = spec.bvh
    ns, s_per = data.clu_planes.shape[0], data.clu_planes.shape[1]
    sup, clu = data.sup_planes[:ns], data.clu_planes
    key, base, visits = int(seed), bvh.global_base, 0
    svis = torch.zeros((1, ns), dtype=torch.bool)
    s, after = -1, (-1, -1)
    idx = torch.arange(s_per)
    while True:
        bound = TC._key_to_t(torch.tensor([key], dtype=torch.int32))
        if s < 0:
            k = TC._pick(o[None], d[None], sup, None, bound, svis)
            if int(k) < 0:
                break
            s, after = int(k), (-1, -1)
            svis[0, s] = True
        tn, hit = slab_entry(o[None], d[None], clu[s])
        bits = (tn[0] + 0.0).view(torch.int32)
        ok = hit[0] & (tn[0] < bound) & (
            (bits > after[0]) | ((bits == after[0]) & (idx > after[1])))
        if not bool(ok.any()):
            s = -1
            continue
        k = int(torch.where(ok, tn[0], torch.inf).argmin())
        after = (int(bits[k]), k)
        visits += 1
        c = s * s_per + k
        th, hh = TC._cluster_hits(o[None], d[None], data.tri_planes,
                                  torch.tensor([c * bvh.cluster_size]),
                                  bvh.cluster_size)
        vk = torch.where(hh, (th.view(torch.int32) & ~TC.IDX_MASK)
                         | torch.arange(bvh.cluster_size, dtype=torch.int32),
                         TC._INIT_KEY).min()
        if int(vk) < key:
            key, base = int(vk), c * bvh.cluster_size
    found = key < TC._MISS_KEY
    return (float(TC._key_to_t(torch.tensor([key], dtype=torch.int32))),
            base + (key & TC.IDX_MASK) if found else -1, visits)


def test_order_state_walk_is_the_mask_walk(wide):
    """The kernels' order state picks exactly the mask walk's clusters."""
    data, spec = wide
    tabs = (data.sup_planes, data.clu_planes, data.tri_planes, spec.bvh)
    o, d, m, _ = seeded_rays(160, 8, data, live=1.0)
    seed = TC.global_seed_keys(o, d, m, data.tri_planes, spec.bvh)
    t, tri, visits = TC.closest_hier_ref(o, d, m, *tabs, seed)
    assert int(visits.max()) > 4
    for r in range(o.shape[0]):
        got = _order_state_walk(o[r], d[r], seed[r], data, spec)
        assert got == (float(t[r]), int(tri[r]), int(visits[r])), r


def test_profiling_trace_holds_the_scopes(dragon, tmp_path):
    tdata, tspec = dragon
    cfg = RenderConfig(width=W, height=H, compaction=True)
    with profiling.trace(str(tmp_path)):
        R.render_sample(tdata, tspec, cfg, R.make_pixel_offsets(cfg), 0)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(profiling.SCOPES) <= names
    sec, out = profiling.timed(lambda x: x * 2, torch.ones(4), iters=3)
    assert sec >= 0.0 and torch.equal(out, torch.full((4,), 2.0))
