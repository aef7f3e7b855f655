"""The walking plain versions of the traversal kernels
(``closest_hier_ref`` for K3, ``any_hier_ref`` for K4, and for the flat
kernels ``closest_flat_walk_ref`` for K1, ``any_flat_walk_ref`` for K2) and
the warp's grouped leaf service, on the CPU.

The CUDA kernels keep one walk per lane (two levels in K3/K4, one in K1/K2)
and let the 32 lanes of a warp share each requested cluster's leaf test.  They cannot run here; what
can be held here is (a) the walk, in the plain versions that take the
kernels' picks ray by ray, and (b) the schedule of the shared leaf test, in
a numpy model that replays the walk's rounds warp by warp, and of the
box pick the warp shares when few lanes still walk.

Set-ups: coatball at 64x48 with ``flat=False`` (37 clusters, 5 supers of 8),
as ``tests/test_torch_hier.py``, and flat (all 40 cluster boxes, 3 of them
padding), and one dragon build at 32x24 (344 clusters, 43 supers of 8).  Rays are the recorded passes of one port sample.

Tolerances, each with its reason:

- walking version against the brute-force plain version: the same plane
  test in the same op order, so the chopped t of one winner is equal bit
  for bit; ids (flags) equal on >= 99.9% of live rays and every id mismatch
  a near-tie within 2^-13 relative, because the walk skips a cluster whose
  entry is not strictly below the running best and brute force does not
  (measured: 0 mismatches on every pass here);
- walking version against the interpret-mode TPU kernels: the same ids rule;
  chopped t of one winner within 2^-13 relative plus 1e-4 absolute, since
  interpret mode fuses multiply-adds that the port rounds op by op
  (``tests/test_torch_trace.py``);
- warp model against the walking version: exact.  The minimum of packed
  keys and the OR of occlusion flags do not depend on the order of the
  slots, and that is the claim the kernels' design rests on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import rank_cuda as RK
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.types import RenderConfig
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, STEP, WARP,
                               assert_near_ties, build_both,
                               few_torch_threads,  # noqa: F401
                               model_closest, plane_hit_np, record_passes,
                               step_planes, warp_groups)

SIZES = {"coatball": (64, 48), "dragon": (32, 24)}
LAYOUT = {"coatball": (8, 5), "dragon": (8, 43)}
PASSES = [("coatball", 0), ("coatball", 1), ("dragon", 0), ("dragon", 1)]
IDS = [f"{scene}-bounce{b}" for scene, b in PASSES]


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    out = {}
    for name, (w, h) in SIZES.items():
        jdata, jspec, tdata, tspec = build_both(name, w, h)
        assert TC.super_layout(tspec.bvh) == LAYOUT[name]
        assert tspec.bvh.num_global > 0
        calls = record_passes(tdata, tspec, RenderConfig(width=w, height=h))
        out[name] = (jdata, jspec, tdata, tspec, calls)
    return out


@pytest.fixture(scope="module")
def brute(scenes):
    """(scene, kind, bounce) -> the brute-force plain version's result on
    that recorded pass (``closest_flat_ref`` or ``any_flat_ref``), computed
    once for the tests of both walks."""
    memo = {}

    def get(scene, kind, bounce):
        key = (scene, kind, bounce)
        if key not in memo:
            _, _, tdata, tspec, calls = scenes[scene]
            if kind == "closest":
                o, d, m, seed = calls["closest"][bounce]
                memo[key] = TC.closest_flat_ref(o, d, m, tdata.tri_planes,
                                                tspec.bvh, seed)
            else:
                o, d, mt, m = calls["any"][bounce]
                memo[key] = TC.any_flat_ref(o, d, mt, m, tdata.tri_planes,
                                            tspec.bvh)
        return memo[key]

    return get


def _tabs(tdata, tspec):
    return tdata.sup_planes, tdata.clu_planes, tdata.tri_planes, tspec.bvh


def _j(x):
    return jnp.asarray(x.numpy())


def _block(bounce):
    """The renderer's traversal block: primary passes use 512."""
    return 512 if bounce == 0 else 128


def _in_cluster(tri, bvh):
    """Rays whose winner is a clustered triangle (not a global one)."""
    return (tri >= 0) & (tri < bvh.num_clusters * bvh.cluster_size)


# ---------------------------------------------------------------------------
# The walk: plain walking versions against brute force and the TPU kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene,bounce", PASSES, ids=IDS)
def test_closest_walk_matches_brute_force(scenes, brute, scene, bounce):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, m, seed = calls["closest"][bounce]
    t, tri, visits = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec), seed)
    rt, rtri = brute(scene, "closest", bounce)
    live = m.numpy()
    assert live.sum() > 0
    same = (tri == rtri).numpy() & live
    assert same.sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri.numpy(), rtri.numpy(), live, tdata.tri_planes)
    assert torch.equal(t[torch.from_numpy(same)], rt[torch.from_numpy(same)])
    assert torch.equal(tri[~m], rtri[~m]) and torch.equal(t[~m], rt[~m])
    # a ray that hits a cluster visited one; a masked ray visited none
    assert (visits[_in_cluster(tri, tspec.bvh) & m] >= 1).all()
    assert (visits[~m] == 0).all() and int(visits.max()) >= 2
    # the cull shows: no ray visits every cluster its supers hold
    assert int(visits.max()) < tspec.bvh.num_clusters


@pytest.mark.parametrize("scene,bounce", PASSES, ids=IDS)
def test_any_walk_matches_brute_force(scenes, brute, scene, bounce):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, mt, m = calls["any"][bounce]
    occ, visits = TC.any_hier_ref(o, d, mt, m, *_tabs(tdata, tspec))
    ref = brute(scene, "any", bounce)
    live = m.numpy()
    assert live.sum() > 0 and bool(occ[m].any()) and not bool(occ[m].all())
    assert ((occ == ref).numpy() & live).sum() >= MIN_MATCH * live.sum()
    assert not occ[~m].any() and (visits[~m] == 0).all()
    assert int(visits.max()) >= 2
    # a ray the global set occludes never starts its walk (the renderer
    # takes those out of the shadow mask first, so: the closest pass's rays
    # as unbounded segments, many of which end on the floor or a wall)
    o, d, m, _ = (x[:512] for x in calls["closest"][bounce])
    mt = torch.full((o.shape[0],), TC.BIG_T)
    g = TC.global_any_hit(o, d, mt, m, tdata.tri_planes, tspec.bvh)
    occ, visits = TC.any_hier_ref(o, d, mt, m, *_tabs(tdata, tspec))
    assert bool(g.any()) and (visits[g] == 0).all() and occ[g].all()
    assert torch.equal(occ, TC.any_flat_ref(o, d, mt, m, tdata.tri_planes,
                                            tspec.bvh))


@pytest.mark.parametrize("bounce", [0, 1])
def test_closest_walk_matches_hierarchical_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = calls["closest"][bounce]
    ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                           jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                           block=_block(bounce), seed_key=_j(seed),
                           exact_uv=False, flat=False)
    t, tri, _ = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec), seed)
    live, tri, jtri = m.numpy(), tri.numpy(), np.asarray(ref.tri)
    assert ((tri == jtri) & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    both = live & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])


@pytest.mark.parametrize("bounce", [0, 1])
def test_any_walk_matches_hierarchical_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, mt, m = calls["any"][bounce]
    ref = np.asarray(TP.trace_any(
        _j(o), _j(d), _j(mt), _j(m), jdata.sup_planes, jdata.clu_planes,
        jdata.tri_planes, jspec.bvh, block=_block(bounce), flat=False,
        seed_global=False))
    occ, _ = TC.any_hier_ref(o, d, mt, m, *_tabs(tdata, tspec))
    live = m.numpy()
    assert ((occ.numpy() == ref) & live).sum() >= MIN_MATCH * live.sum()
    assert not occ.numpy()[~live].any() and not ref[~live].any()


def _rank_seed(tdata, tspec, calls, bounce=1):
    """(rays, key, base) of the rank walk's best on one closest pass: a
    per-ray seed and seed base for the hierarchical walk."""
    o, d, m, seed = calls["closest"][bounce]
    _, k1, k2, _ = BP.nearest_cluster(o, d, m, tdata.clu_planes, tspec.bvh,
                                      return_key=True, return_second=2,
                                      return_packed=True)
    key, base = RK.closest_rank_ref(o, d, m, [k1, k2], tdata.tri_planes,
                                    tspec.bvh, seed)
    return (o, d, m), key, base


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_closest_walk_with_seed_base(scenes, scene):
    jdata, jspec, tdata, tspec, calls = scenes[scene]
    (o, d, m), key, base = _rank_seed(tdata, tspec, calls)
    t, tri, visits = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec), key,
                                         base)
    rt, rtri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh, key,
                                   base)
    live = m.numpy()
    assert ((tri == rtri).numpy() & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri.numpy(), rtri.numpy(), live, tdata.tri_planes)
    # a seed that no cluster beats keeps its own base, and being a good
    # seed it cuts the walk: fewer visits than from the global seed alone
    kept = m & (t == TC._key_to_t(key)) & (tri >= 0)
    assert bool(kept.any())
    assert torch.equal(tri[kept], (base + (key & TC.IDX_MASK))[kept])
    _, _, unseeded = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec),
                                         calls["closest"][1][3])
    assert int(visits.sum()) < int(unseeded.sum())
    if scene == "coatball":
        ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                               jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                               seed_key=_j(key), seed_base=_j(base),
                               exact_uv=False, flat=False)
        jtri = np.asarray(ref.tri)
        assert ((tri.numpy() == jtri) & live).sum() >= MIN_MATCH * live.sum()
        assert_near_ties(o, d, tri.numpy(), jtri, live, tdata.tri_planes)


def test_walk_without_a_seed_ignores_the_global_set(scenes):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, m, _ = calls["closest"][0]
    t, tri, _ = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec))
    rt, rtri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh)
    assert torch.equal(tri, rtri) and torch.equal(t, rt)
    # without the seed the floor and the walls are missed, not hit
    assert bool((tri < 0).any())
    assert _in_cluster(tri[tri >= 0], tspec.bvh).all()


@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_all_false_mask_leaves_every_ray_at_its_seed(scenes, scene):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, _, seed = calls["closest"][1]
    none = torch.zeros(o.shape[0], dtype=torch.bool)
    rounds = []
    t, tri, visits = TC.closest_hier_ref(o, d, none, *_tabs(tdata, tspec),
                                         seed, rounds=rounds)
    rt, rtri = TC.closest_flat_ref(o, d, none, tdata.tri_planes, tspec.bvh,
                                   seed)
    assert torch.equal(t, rt) and torch.equal(tri, rtri)
    assert torch.equal(t, TC._key_to_t(seed))
    assert not visits.any() and rounds == []
    o2, d2, mt, _ = calls["any"][1]
    occ, visits = TC.any_hier_ref(o2, d2, mt, none, *_tabs(tdata, tspec))
    assert not occ.any() and not visits.any()


@pytest.mark.parametrize("n", [1, 31, 1000])
def test_ragged_ray_counts(scenes, n):
    """A walk is per ray: the first n rays give the first n results."""
    _, _, tdata, tspec, calls = scenes["coatball"]
    assert n % WARP
    o, d, m, seed = calls["closest"][1]
    full = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec), seed)
    part = TC.closest_hier_ref(o[:n], d[:n], m[:n], *_tabs(tdata, tspec),
                               seed[:n])
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)
    o2, d2, mt, m2 = calls["any"][1]
    full = TC.any_hier_ref(o2, d2, mt, m2, *_tabs(tdata, tspec))
    part = TC.any_hier_ref(o2[:n], d2[:n], mt[:n], m2[:n],
                           *_tabs(tdata, tspec))
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)


# ---------------------------------------------------------------------------
# The schedule: a numpy model of one warp's grouped leaf service (its
# closest half, model_closest, is in torch_port_common.py)
# ---------------------------------------------------------------------------

_F = np.float32


def _serve_any(tri, base, count, o, d, max_t, group, steps):
    """``serve_any``: the lanes of the group whose ray is occluded; a ray
    leaves at its first step with an occluder (``__any_sync``)."""
    occluded = set()
    for j0 in range(0, count, STEP):
        group = [lane for lane in group if lane not in occluded]
        if not group:
            break
        p = step_planes(tri, base, j0, count)
        for lane in group:
            t, hit = plane_hit_np(p, o[lane], d[lane])
            if (hit & (t <= max_t[lane])).any():
                occluded.add(lane)
            steps[0] += 1
    return occluded


def model_any(o, d, max_t, mask, tri, bvh, rounds, g_slots=None):
    """K4 as its warps run it: the global slots (``g_slots`` of them,
    ``padded_global`` by default) as one group of every live lane, then each
    round's groups.  Returns (occluded, warp steps).  K2 tests its
    ``num_global`` real global slots lane by lane, each on its own ray,
    which gives the flags of ``g_slots=num_global`` here."""
    n, c = o.shape[0], bvh.cluster_size
    g_slots = bvh.padded_global if g_slots is None else g_slots
    occ = np.zeros(n, bool)
    steps = [0]
    for w0 in range(0, n, WARP):
        sl = slice(w0, min(n, w0 + WARP))
        live = [int(lane) for lane in np.nonzero(mask[sl])[0]]
        hit = _serve_any(tri, bvh.global_base, g_slots, o[sl], d[sl],
                         max_t[sl], live, steps)
        occ[[w0 + lane for lane in hit]] = True
    for req in rounds:
        assert (req[occ | ~mask] < 0).all()  # an occluded ray has left
        for w0 in range(0, n, WARP):
            sl = slice(w0, min(n, w0 + WARP))
            for cid, group in warp_groups(req[sl]):
                hit = _serve_any(tri, cid * c, c, o[sl], d[sl], max_t[sl],
                                 group, steps)
                occ[[w0 + lane for lane in hit]] = True
    return occ, steps[0]


def _np(*tensors):
    return tuple(x.numpy() for x in tensors)


# (scene, bounce, first ray, ray count): whole warps, a ragged tail, and a
# stretch of dragon where neighbouring rays ask for different clusters
MODEL_CASES = [("coatball", 0, 1024, 512), ("coatball", 1, 0, 1000),
               ("dragon", 0, 256, 512), ("dragon", 1, 0, 333)]
MODEL_IDS = [f"{s}-bounce{b}-{n}rays" for s, b, _, n in MODEL_CASES]


@pytest.mark.parametrize("scene,bounce,start,count", MODEL_CASES,
                         ids=MODEL_IDS)
def test_warp_model_gives_the_closest_walks_keys(scenes, scene, bounce, start,
                                                 count):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, m, seed = (x[start:start + count] for x in calls["closest"][bounce])
    rounds = []
    t, tri, visits = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec), seed,
                                         rounds=rounds)
    assert len(rounds) == int(visits.max()) >= 2
    mt, mtri, steps = model_closest(*_np(o, d, m, seed), None,
                                    tdata.tri_planes.numpy(), tspec.bvh,
                                    _np(*rounds))
    np.testing.assert_array_equal(mtri, tri.numpy())
    np.testing.assert_array_equal(mt.view(np.int32),
                                  t.numpy().view(np.int32))
    # a visit costs cluster_size / 64 steps for its ray, whatever its group
    assert steps == int(visits.sum()) * -(-tspec.bvh.cluster_size // STEP)


@pytest.mark.parametrize("scene,bounce,start,count", MODEL_CASES,
                         ids=MODEL_IDS)
def test_warp_model_gives_the_any_walks_flags(scenes, scene, bounce, start,
                                              count):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, mt, m = (x[start:start + count] for x in calls["any"][bounce])
    rounds = []
    occ, visits = TC.any_hier_ref(o, d, mt, m, *_tabs(tdata, tspec),
                                  rounds=rounds)
    got, steps = model_any(*_np(o, d, mt, m), tdata.tri_planes.numpy(),
                           tspec.bvh, _np(*rounds))
    np.testing.assert_array_equal(got, occ.numpy())
    # leaving at the first occluding step saves steps, never adds any
    chunks = -(-tspec.bvh.cluster_size // STEP)
    g_chunks = -(-tspec.bvh.padded_global // STEP)
    most = int(visits.sum()) * chunks + int(m.sum()) * g_chunks
    assert 0 < steps <= most and (steps < most) == bool(occ.any())


def test_warp_model_with_seed_base(scenes):
    _, _, tdata, tspec, calls = scenes["coatball"]
    (o, d, m), key, base = _rank_seed(tdata, tspec, calls)
    o, d, m, key, base = (x[:777] for x in (o, d, m, key, base))
    rounds = []
    t, tri, _ = TC.closest_hier_ref(o, d, m, *_tabs(tdata, tspec), key, base,
                                    rounds=rounds)
    mt, mtri, _ = model_closest(*_np(o, d, m, key, base),
                                tdata.tri_planes.numpy(), tspec.bvh,
                                _np(*rounds))
    np.testing.assert_array_equal(mtri, tri.numpy())
    np.testing.assert_array_equal(mt.view(np.int32),
                                  t.numpy().view(np.int32))


def _coop_pick_np(boxes, o, d, t_max, bound, visited):
    """``coop_pick`` of ``csrc/trace_hier.cu``: lane l slab-tests boxes l,
    l + 32, ... in float32, keeps its nearest by entry bits (the lower index
    on equal bits, since its boxes come in rising order), and the warp takes
    the minimum bits, then the minimum index among the lanes that hold it."""
    inf_bits = np.int32(0x7F800000)
    eps = _F(1e-12)
    with np.errstate(all="ignore"):
        safe = np.where(np.abs(d) < eps, np.where(d < 0, -eps, eps), d)
        inv = _F(1.0) / safe
        lane_best = []
        for lane in range(WARP):
            bits, idx = inf_bits, np.int32(0x7FFFFFFF)
            for k in range(lane, len(boxes), WARP):
                lo, hi = boxes[k, :3], boxes[k, 3:]
                t0, t1 = (lo - o) * inv, (hi - o) * inv
                tn = np.minimum(t0, t1).max()
                tf = np.maximum(t0, t1).min()
                entry = np.maximum(tn, _F(0.0))
                ok = (not visited[k] and tn <= tf and tf >= 0 and tn <= t_max
                      and hi[0] >= lo[0] and entry < bound)
                kb = (entry + _F(0.0)).view(np.int32) if ok else inf_bits
                if kb < bits:
                    bits, idx = kb, np.int32(k)
            lane_best.append((bits, idx))
    mn = min(b for b, _ in lane_best)
    if mn == inf_bits:
        return -1
    return int(min(i for b, i in lane_best if b == mn))


@pytest.mark.parametrize("level", ["supers", "clusters", "flat"])
def test_cooperative_pick_is_the_lanes_own_pick(scenes, level):
    """The pick the warp shares when few lanes walk gives the index each
    lane's own ``pick_box`` gives (``_pick`` here), ties included.  The flat
    level picks among all of coatball's 40 cluster boxes (37 real, 3
    padding), across a 32-box word of the visited mask."""
    _, _, tdata, tspec, calls = scenes["coatball" if level == "flat"
                                      else "dragon"]
    o, d, mt, m = (x[m_] for x, m_ in zip(calls["any"][0],
                                          [calls["any"][0][3]] * 4))
    # coatball's last rows of pixels enter its boxes 32-39
    sel = slice(-96, None) if level == "flat" else slice(0, 96)
    o, d, mt = o[sel], d[sel], mt[sel]
    ns = tdata.clu_planes.shape[0]
    boxes = {"supers": lambda: tdata.sup_planes[:ns],
             "clusters": lambda: tdata.clu_planes[7],
             "flat": lambda: tdata.clu_planes.reshape(-1, 6)}[level]()
    rng = np.random.RandomState(11)
    visited = torch.from_numpy(rng.rand(o.shape[0], boxes.shape[0]) < 0.3)
    big = torch.full((o.shape[0],), TC.BIG_T)
    want_far = TC._pick(o, d, boxes, mt, big, visited)
    # a bound that cuts some boxes off, and exact ties: rays that start
    # inside several boxes enter each of them at 0
    bound = torch.from_numpy(rng.uniform(0.0, 3.0, o.shape[0]).astype(_F))
    want_cut = TC._pick(o, d, boxes, None, bound, visited)
    n_hit = 0
    for i in range(o.shape[0]):
        ray = (boxes.numpy(), o[i].numpy(), d[i].numpy())
        got = _coop_pick_np(*ray, mt[i].numpy(), _F(TC.BIG_T),
                            visited[i].numpy())
        assert got == int(want_far[i])
        got = _coop_pick_np(*ray, _F(TC.BIG_T), bound[i].numpy(),
                            visited[i].numpy())
        assert got == int(want_cut[i])
        n_hit += got >= 0
    assert 0 < n_hit
    if level == "flat":
        assert boxes.shape[0] > WARP and int(want_far.max()) >= WARP


def test_groups_follow_the_lowest_requesting_lane():
    req = np.array([-1, 7, 3, 7, -1, 3, 9, 7])
    assert list(warp_groups(req)) == [(7, [1, 3, 7]), (3, [2, 5]), (9, [6])]
    assert list(warp_groups(np.full(32, -1))) == []


# ---------------------------------------------------------------------------
# The flat walk (K1/K2): one level over every cluster box of coatball
# ---------------------------------------------------------------------------


def _flat(tdata, tspec):
    return tdata.clu_planes, tdata.tri_planes, tspec.bvh


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_closest_walk_matches_brute_force(scenes, brute, bounce):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = calls["closest"][bounce]
    t, tri, visits = TC.closest_flat_walk_ref(o, d, m, *_flat(tdata, tspec),
                                              seed)
    rt, rtri = brute("coatball", "closest", bounce)
    live = m.numpy()
    same = (tri == rtri).numpy() & live
    assert same.sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri.numpy(), rtri.numpy(), live, tdata.tri_planes)
    assert torch.equal(t[torch.from_numpy(same)], rt[torch.from_numpy(same)])
    assert torch.equal(tri[~m], rtri[~m]) and torch.equal(t[~m], rt[~m])
    assert (visits[_in_cluster(tri, tspec.bvh) & m] >= 1).all()
    assert (visits[~m] == 0).all() and int(visits.max()) >= 2
    assert int(visits.max()) < tspec.bvh.num_clusters


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_any_walk_matches_brute_force(scenes, brute, bounce):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, mt, m = calls["any"][bounce]
    occ, visits = TC.any_flat_walk_ref(o, d, mt, m, *_flat(tdata, tspec))
    ref = brute("coatball", "any", bounce)
    live = m.numpy()
    assert bool(occ[m].any()) and not bool(occ[m].all())
    assert ((occ == ref).numpy() & live).sum() >= MIN_MATCH * live.sum()
    assert not occ[~m].any() and (visits[~m] == 0).all()
    assert int(visits.max()) >= 2
    # the flat walk and the two-level walk give the same flags
    assert torch.equal(occ, TC.any_hier_ref(o, d, mt, m,
                                            *_tabs(tdata, tspec))[0])


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_closest_walk_matches_flat_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = calls["closest"][bounce]
    ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                           jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                           block=_block(bounce), seed_key=_j(seed),
                           exact_uv=False, flat=True)
    t, tri, _ = TC.closest_flat_walk_ref(o, d, m, *_flat(tdata, tspec), seed)
    live, tri, jtri = m.numpy(), tri.numpy(), np.asarray(ref.tri)
    assert ((tri == jtri) & live).sum() >= MIN_MATCH * live.sum()
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    both = live & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=NEAR_TIE_REL, atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])


@pytest.mark.parametrize("bounce", [0, 1])
def test_flat_any_walk_matches_flat_kernel(scenes, bounce):
    jdata, jspec, tdata, tspec, calls = scenes["coatball"]
    o, d, mt, m = calls["any"][bounce]
    ref = np.asarray(TP.trace_any(
        _j(o), _j(d), _j(mt), _j(m), jdata.sup_planes, jdata.clu_planes,
        jdata.tri_planes, jspec.bvh, block=_block(bounce), flat=True,
        seed_global=False))
    occ, _ = TC.any_flat_walk_ref(o, d, mt, m, *_flat(tdata, tspec))
    live = m.numpy()
    assert ((occ.numpy() == ref) & live).sum() >= MIN_MATCH * live.sum()
    assert not occ.numpy()[~live].any() and not ref[~live].any()


FLAT_CASES = [(0, 1024, 512), (1, 0, 1000)]
FLAT_IDS = [f"bounce{b}-{n}rays" for b, _, n in FLAT_CASES]


@pytest.mark.parametrize("bounce,start,count", FLAT_CASES, ids=FLAT_IDS)
def test_warp_model_gives_the_flat_closest_walks_keys(scenes, bounce, start,
                                                      count):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, m, seed = (x[start:start + count] for x in calls["closest"][bounce])
    rounds = []
    t, tri, visits = TC.closest_flat_walk_ref(o, d, m, *_flat(tdata, tspec),
                                              seed, rounds=rounds)
    assert len(rounds) == int(visits.max()) >= 2
    mt, mtri, steps = model_closest(*_np(o, d, m, seed), None,
                                    tdata.tri_planes.numpy(), tspec.bvh,
                                    _np(*rounds))
    np.testing.assert_array_equal(mtri, tri.numpy())
    np.testing.assert_array_equal(mt.view(np.int32),
                                  t.numpy().view(np.int32))
    assert steps == int(visits.sum()) * -(-tspec.bvh.cluster_size // STEP)


@pytest.mark.parametrize("bounce,start,count", FLAT_CASES, ids=FLAT_IDS)
def test_warp_model_gives_the_flat_any_walks_flags(scenes, bounce, start,
                                                   count):
    _, _, tdata, tspec, calls = scenes["coatball"]
    bvh = tspec.bvh
    o, d, mt, m = (x[start:start + count] for x in calls["any"][bounce])
    rounds = []
    occ, visits = TC.any_flat_walk_ref(o, d, mt, m, *_flat(tdata, tspec),
                                       rounds=rounds)
    got, steps = model_any(*_np(o, d, mt, m), tdata.tri_planes.numpy(), bvh,
                           _np(*rounds), g_slots=bvh.num_global)
    np.testing.assert_array_equal(got, occ.numpy())
    chunks = -(-bvh.cluster_size // STEP)
    most = int(visits.sum()) * chunks + int(m.sum()) * -(-bvh.num_global
                                                         // STEP)
    assert 0 < steps <= most and (steps < most) == bool(occ.any())


def test_global_test_over_the_real_slots_gives_the_same_flags(scenes):
    """K2 tests the ``num_global`` real global slots, not the 128-slot
    ``padded_global`` chunk: the padding slots are zero planes, never hit.
    On unbounded segments (where the floor and walls occlude many rays)
    and on a recorded shadow pass, in plain PyTorch and in the warp model."""
    _, _, tdata, tspec, calls = scenes["coatball"]
    bvh, tri = tspec.bvh, tdata.tri_planes
    gb, ng, pg = bvh.global_base, bvh.num_global, bvh.padded_global
    assert 0 < ng < pg
    o, d, m, _ = calls["closest"][1]
    mt = torch.full((o.shape[0],), TC.BIG_T)
    flags = []
    for width in (ng, pg):
        t, hit = TC._plane_hits(o, d, tri[:, gb:gb + width])
        flags.append((hit & (t <= mt[:, None])).any(dim=1) & m)
    assert torch.equal(*flags) and bool(flags[0].any())
    assert torch.equal(flags[0], TC.global_any_hit(o, d, mt, m, tri, bvh))
    o, d, mt, m = (x[:256] for x in calls["any"][0])
    mt = torch.full_like(mt, TC.BIG_T)  # unbounded: the globals occlude
    real = model_any(*_np(o, d, mt, m), tri.numpy(), bvh, [], g_slots=ng)
    padded = model_any(*_np(o, d, mt, m), tri.numpy(), bvh, [], g_slots=pg)
    np.testing.assert_array_equal(real[0], padded[0])
    assert real[0].any() and real[1] < padded[1]


def test_flat_walk_all_false_mask_leaves_every_ray_at_its_seed(scenes):
    _, _, tdata, tspec, calls = scenes["coatball"]
    o, d, _, seed = calls["closest"][1]
    none = torch.zeros(o.shape[0], dtype=torch.bool)
    rounds = []
    t, tri, visits = TC.closest_flat_walk_ref(o, d, none,
                                              *_flat(tdata, tspec), seed,
                                              rounds=rounds)
    rt, rtri = TC.closest_flat_ref(o, d, none, tdata.tri_planes, tspec.bvh,
                                   seed)
    assert torch.equal(t, rt) and torch.equal(tri, rtri)
    assert torch.equal(t, TC._key_to_t(seed))
    assert not visits.any() and rounds == []
    o2, d2, mt, _ = calls["any"][1]
    occ, visits = TC.any_flat_walk_ref(o2, d2, mt, none, *_flat(tdata, tspec),
                                       rounds=rounds)
    assert not occ.any() and not visits.any() and rounds == []


@pytest.mark.parametrize("n", [1, 31, 1000])
def test_flat_walk_ragged_ray_counts(scenes, n):
    """A walk is per ray: the first n rays give the first n results."""
    _, _, tdata, tspec, calls = scenes["coatball"]
    assert n % WARP
    o, d, m, seed = calls["closest"][1]
    full = TC.closest_flat_walk_ref(o, d, m, *_flat(tdata, tspec), seed)
    part = TC.closest_flat_walk_ref(o[:n], d[:n], m[:n],
                                    *_flat(tdata, tspec), seed[:n])
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)
    o2, d2, mt, m2 = calls["any"][1]
    full = TC.any_flat_walk_ref(o2, d2, mt, m2, *_flat(tdata, tspec))
    part = TC.any_flat_walk_ref(o2[:n], d2[:n], mt[:n], m2[:n],
                                *_flat(tdata, tspec))
    for a, b in zip(full, part):
        assert torch.equal(a[:n], b)
