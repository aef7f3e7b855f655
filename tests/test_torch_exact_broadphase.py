"""The exact broad phase of the compaction sort keys as a kernel
(``nearest_cluster_kernel``, ``ops/broadphase_cuda.py``).

On the CPU: ``nearest_cluster`` and ``nearest_cluster_pair`` take the plain
chain and launch nothing; their argument checks; a numpy model of the
kernel's branch-free top-3 update and of its pair against the plain chain.
On a CUDA device only: the kernel's keys against the plain chain's on the
same card, ``torch.equal``, in every return form, on dragon's and
coatball's primary and bounce-1 rays and on adversarial rays (axis-parallel
and near-zero direction components, ``-0.0``, origins inside, on the faces
and at the corners of boxes, flat boxes, masked rays, ragged counts and
``n = 0``); ranks 1-2 against K5's keys; the launches of one sample of each
compaction config; and dragon images at ``compaction=True`` (and
``rank_trace=2``) through the kernel equal to those through the plain
chain.  The file imports no JAX, so its card cases run on the card:
``python -m pytest --noconftest tests/test_torch_exact_broadphase.py``.
"""

import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.ops.intersect import BIG_T
from metal_raytracing_tpu_torch.scenes import get_scene
from metal_raytracing_tpu_torch.types import RenderConfig

# nearest_cluster's keyword arguments per form ("max_t": bounded, "sup": the
# super boxes as the table); "pair<r>" forms call nearest_cluster_pair
FORMS = {
    "id": {},
    "key": dict(return_key=True),
    "second": dict(return_key=True, return_second=1),
    "second_packed": dict(return_key=True, return_second=1,
                          return_packed=True),
    "second_no_key": dict(return_second=1),
    "third": dict(return_key=True, return_second=2),
    "third_packed": dict(return_key=True, return_second=2,
                         return_packed=True),
    "segment": dict(max_t=True),
    "segment_second": dict(max_t=True, return_second=1),
    "segment_third_packed": dict(max_t=True, return_key=True,
                                 return_second=2, return_packed=True),
    "super_segment": dict(sup=True, max_t=True),
    "super_key": dict(sup=True, return_key=True),
    "pair2": dict(ranks=2),
    "pair2_packed": dict(ranks=2, return_packed=True),
    "pair3": dict(ranks=3),
    "pair3_packed": dict(ranks=3, return_packed=True),
}
CPU_FORMS = ("id", "second_packed", "third", "segment_second",
             "super_segment", "pair2", "pair3_packed")


def run_form(form, rays, clu, sup):
    """``form`` on ``rays = (o, d, m, mt, d_nb, m_nb)``: a tuple of int32
    tensors."""
    o, d, m, mt, d_nb, m_nb = rays
    kw = dict(FORMS[form])
    if form.startswith("pair"):
        return BP.nearest_cluster_pair(o, d, mt, m, d_nb, m_nb, clu, None,
                                       **kw)
    table = sup[:, None, :] if kw.pop("sup", False) else clu
    out = BP.nearest_cluster(o, d, m, table, None,
                             max_t=mt if kw.pop("max_t", False) else None,
                             **kw)
    return out if isinstance(out, tuple) else (out,)


def synthetic_table(seed: int, ns: int = 6, s: int = 8):
    """(clu (ns, s, 6), sup (ns + 2, 6)) float32 from a numpy seed: boxes
    that overlap, flat boxes (hi == lo on one axis), a point box, boxes
    that share faces, and inverted ``[BIG_T, -BIG_T]`` padding, as
    ``pack_scene_planes`` pads."""
    rng = np.random.RandomState(seed)
    nc = ns * s
    lo = rng.uniform(-2.0, 2.0, (nc, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 1.5, (nc, 3)).astype(np.float32)
    hi[::5, 1] = lo[::5, 1]  # flat on y
    hi[3] = lo[3]  # a point
    lo[7] = hi[6]  # sharing a corner
    boxes = np.concatenate([lo, hi], axis=1)
    boxes[-3:, :3], boxes[-3:, 3:] = BIG_T, -BIG_T
    real = boxes[:, 3] >= boxes[:, 0]
    sup = np.full((ns + 2, 6), BIG_T, dtype=np.float32)
    sup[:, 3:] = -BIG_T
    for g in range(ns):  # each group's bounds over its real boxes
        grp = boxes[g * s:(g + 1) * s][real[g * s:(g + 1) * s]]
        sup[g, :3], sup[g, 3:] = grp[:, :3].min(0), grp[:, 3:].max(0)
    return torch.from_numpy(boxes.reshape(ns, s, 6)), torch.from_numpy(sup)


# direction components that reach safe_inv's eps branch (|v| < 1e-12, with
# both signs and -0.0), sit on its edge, or are axis-parallel
COMPONENTS = np.array([1.0, -1.0, 0.0, -0.0, 1e-12, -1e-12, 9.99e-13,
                       -9.99e-13, 1e-13, -1e-30, 1e-6, 0.5, -0.3, 2.5],
                      dtype=np.float32)


def adversarial_rays(n: int, seed: int, clu):
    """(o, d, m, mt, d_nb, m_nb) float32 / bool from a numpy seed, aimed at
    the boxes of ``clu``: each axis of an origin lies on a box's lo or hi
    face, at its centre, inside it or a unit outside; each direction
    component is one of ``COMPONENTS`` or a normal draw; segment lengths
    include 0, -0.0, 1e30 and inf; about 80% of the rays live."""
    rng = np.random.RandomState(seed)
    boxes = clu.reshape(-1, 6).numpy()
    real = boxes[boxes[:, 3] >= boxes[:, 0]]
    b = real[rng.randint(0, real.shape[0], n)]
    lo, hi = b[:, :3], b[:, 3:]
    choices = np.stack([lo, hi, 0.5 * (lo + hi),
                        lo + rng.uniform(0, 1, (n, 3)) * (hi - lo),
                        lo - 1.0, hi + 1.0], axis=0)
    o = np.take_along_axis(choices, rng.randint(0, 6, (1, n, 3)), 0)[0]

    def direction():
        d = COMPONENTS[rng.randint(0, len(COMPONENTS), (n, 3))]
        normal = rng.rand(n, 3) < 0.3
        return np.where(normal, rng.normal(size=(n, 3)), d).astype(np.float32)

    mt = rng.uniform(0.0, 4.0, n).astype(np.float32)
    special = np.array([0.0, -0.0, 1e30, np.inf], dtype=np.float32)
    pick = rng.rand(n) < 0.2
    mt[pick] = special[rng.randint(0, 4, int(pick.sum()))]
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(direction()), torch.from_numpy(rng.rand(n) < 0.8),
            torch.from_numpy(mt), torch.from_numpy(direction()),
            torch.from_numpy(rng.rand(n) < 0.8))


# ---------------------------------------------------------------------------
# The CPU: the plain chain, the checks, a model of the kernel's update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", CPU_FORMS)
def test_cpu_takes_the_plain_chain(form):
    """CPU tensors take the plain chain: the keys are its keys and the
    kernel's counters stay at 0."""
    clu, sup = synthetic_table(1)
    rays = adversarial_rays(500, 2, clu)
    TC.reset_launch_counts()
    got = run_form(form, rays, clu, sup)
    assert BP.nearest_cluster.launches == 0
    assert BP.nearest_cluster.launches_pair == 0
    o, d, m, mt, d_nb, m_nb = rays
    if form.startswith("pair"):
        ranks = FORMS[form]["ranks"]
        skey, keys = BP.nearest_cluster_pair_ref(o, d, mt, m, d_nb, m_nb,
                                                 clu.reshape(-1, 6), ranks)
        assert torch.equal(got[0], BP.decode_cluster_key(skey, 48))
        assert torch.equal(got[2], keys[0])
    else:
        kw = FORMS[form]
        table = sup if kw.get("sup") else clu.reshape(-1, 6)
        keys = BP.nearest_cluster_ref(
            o, d, m, table, mt if kw.get("max_t") else None,
            1 + kw.get("return_second", 0))
        assert torch.equal(got[0], BP.decode_cluster_key(keys[0],
                                                         table.shape[0]))
    assert all(g.dtype == torch.int32 and g.shape == (500,) for g in got)


def _bad(kind):
    clu, _ = synthetic_table(1)
    o, d, m, mt, d_nb, m_nb = adversarial_rays(64, 3, clu)
    single = dict(o=o, d=d, mask=m, clu=clu, spec=None)
    pair = dict(o=o, d_sh=d, max_t_sh=mt, mask_sh=m, d_nb=d_nb, mask_nb=m_nb,
                clu=clu, spec=None)
    return {
        "o_float64": (single, dict(o=o.double())),
        "d_shape": (single, dict(d=d[:, :2])),
        "mask_uint8": (single, dict(mask=m.to(torch.uint8))),
        "max_t_float64": (single, dict(max_t=mt.double())),
        "max_t_shape": (single, dict(max_t=mt[:10])),
        "table_float64": (single, dict(clu=clu.double())),
        "table_shape": (single, dict(clu=clu[..., :5])),
        "table_4098_boxes": (single, dict(
            clu=torch.zeros((2, 2049, 6), dtype=torch.float32))),
        "return_second_3": (single, dict(return_second=3)),
        "pair_ranks_1": (pair, dict(ranks=1)),
        "pair_ranks_4": (pair, dict(ranks=4)),
        "pair_d_nb_shape": (pair, dict(d_nb=d_nb[:32])),
        "pair_mask_nb_int": (pair, dict(mask_nb=m_nb.int())),
        "pair_4098_boxes": (pair, dict(
            clu=torch.zeros((1, 4098, 6), dtype=torch.float32))),
    }[kind]


@pytest.mark.parametrize("kind", [
    "o_float64", "d_shape", "mask_uint8", "max_t_float64", "max_t_shape",
    "table_float64", "table_shape", "table_4098_boxes", "return_second_3",
    "pair_ranks_1", "pair_ranks_4", "pair_d_nb_shape", "pair_mask_nb_int",
    "pair_4098_boxes"])
def test_wrappers_refuse_what_the_kernel_does_not_take(kind):
    base, change = _bad(kind)
    kw = {**base, **change}
    fn = BP.nearest_cluster_pair if "d_nb" in base else BP.nearest_cluster
    with pytest.raises(ValueError):
        fn(**kw)


def _chain_keys(o, d, boxes, max_t):
    """(n, NC) int32 numpy: the plain chain's packed keys of every ray and
    box, NC_SENT where the slab test fails (no mask)."""
    ids = torch.arange(boxes.shape[0], dtype=torch.int32)[None, :]
    live = torch.ones(o.shape[0], dtype=torch.bool)
    return BP._packed_slab_keys(BP._box_subs(o, boxes), d, live, max_t,
                                boxes, ids).numpy()


def _kernel_model(keys, live, ranks):
    """The kernel's sweep in numpy: the branch-free update box by box, in
    order, from the sentinel; masked rays write the sentinel."""
    sent = np.int32(BP.NC_SENT)
    k = [np.full(keys.shape[0], sent, np.int32) for _ in range(3)]
    for c in range(keys.shape[1]):
        key = keys[:, c]
        k[2] = np.minimum(k[2], np.maximum(k[1], key))
        k[1] = np.minimum(k[1], np.maximum(k[0], key))
        k[0] = np.minimum(k[0], key)
    return [np.where(live, x, sent) for x in k[:ranks]]


@pytest.mark.parametrize("bounded", [False, True], ids=["unbounded",
                                                        "bounded"])
def test_kernel_update_model_equals_plain_chain(bounded):
    """A numpy model of ``nearest_cluster_kernel``'s sweep (the
    branch-free top-3 update over the boxes in order, masked rays to the
    sentinel) over the plain chain's keys, against the plain chain's
    ranks: 1-3 and the pair."""
    clu, _ = synthetic_table(4)
    o, d, m, mt, d_nb, m_nb = adversarial_rays(400, 5, clu)
    boxes = clu.reshape(-1, 6)
    keys = _chain_keys(o, d, boxes, mt if bounded else None)
    keys_nb = _chain_keys(o, d_nb, boxes, None)
    model = _kernel_model(keys, m.numpy(), 3)
    ref = BP.nearest_cluster_ref(o, d, m, boxes, mt if bounded else None, 3)
    for a, b in zip(model, ref):
        np.testing.assert_array_equal(a, b.numpy())
    assert (model[2] != BP.NC_SENT).any()  # some rays have three boxes
    if bounded:  # the pair: the shadow's rank 1 bounded, the bounce's not
        skey, bkeys = BP.nearest_cluster_pair_ref(o, d, mt, m, d_nb, m_nb,
                                                  boxes, 3)
        np.testing.assert_array_equal(_kernel_model(keys, m.numpy(), 1)[0],
                                      skey.numpy())
        nb = _kernel_model(keys_nb, m_nb.numpy(), 3)
        for a, b in zip(nb, bkeys):
            np.testing.assert_array_equal(a, b.numpy())


# ---------------------------------------------------------------------------
# The card: the kernel against the plain chain on the same card
# ---------------------------------------------------------------------------

SCENES = {"dragon": (1024, 1024), "coatball": (1024, 768)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: nearest_cluster_kernel")
    return torch.device("cuda")


def _plain(fn, monkeypatch):
    """``fn()`` with the wrappers forced onto the plain chain."""
    with monkeypatch.context() as mp:
        mp.setattr(BP, "_device_path", lambda o: False)
        return fn()


@pytest.fixture(scope="module")
def scene_rays():
    """scene -> (clu, sup, [primary rays, bounce-1 rays], tri, bvh) on the
    card from one sample of the default config: each pass's closest rays
    (``max_t`` from its shadow segments) and its shadow segments, both with
    the next pass's directions and mask for the pair's bounce chain."""
    dev = _card()
    out = {}
    for name, (w, h) in SCENES.items():
        r = R.Renderer(get_scene(name, w, h), RenderConfig(width=w, height=h),
                       device=dev)
        closest, any_hit = R.make_tracers(r.data, r.spec, "cuda")
        calls = {"closest": [], "any": []}

        def rec_closest(o, d, m, seed, seed_base=None, baked=False):
            calls["closest"].append((o.clone(), d.clone(), m.clone()))
            return closest(o, d, m, seed, seed_base, baked=baked)

        def rec_any(o, d, mt, m):
            calls["any"].append((o.clone(), d.clone(), mt.clone(), m.clone()))
            return any_hit(o, d, mt, m)

        R.render_sample(r.data, r.spec, r.cfg, r.offsets, 0,
                        tracers=(rec_closest, rec_any, None))
        passes = []
        for b in (0, 1):
            o, d, m = calls["closest"][b]
            so, sd, smt, sm = calls["any"][b]
            _, d_nb, m_nb = calls["closest"][b + 1]
            passes.append(((o, d, m, smt, d_nb, m_nb),
                           (so, sd, sm, smt, d_nb, m_nb)))
        out[name] = (r.data.clu_planes, r.data.sup_planes, passes,
                     r.data.tri_planes, r.spec.bvh)
    return out


def _equal_forms(form, rays, clu, sup, monkeypatch):
    got = run_form(form, rays, clu, sup)
    ref = _plain(lambda: run_form(form, rays, clu, sup), monkeypatch)
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and torch.equal(g, r), form
    return got


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_kernel_equals_plain_chain_on_scene_rays(scene_rays, scene, form,
                                                 monkeypatch):
    """Primary and bounce-1 rays: closest rays for the unbounded forms,
    shadow segments for the bounded ones and the pair."""
    clu, sup, passes = scene_rays[scene][:3]
    for closest_rays, shadow_rays in passes:
        bounded = form.startswith("pair") or FORMS[form].get("max_t")
        rays = shadow_rays if bounded else closest_rays
        got = _equal_forms(form, rays, clu, sup, monkeypatch)
        live = rays[2]
        nc = (sup.shape[0] if FORMS[form].get("sup")
              else clu.shape[0] * clu.shape[1])
        assert (got[0][live] < nc).any() and (got[0][~live] == nc).all()


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("table", ["dragon", "synthetic"])
def test_kernel_equals_plain_chain_on_adversarial_rays(scene_rays, table,
                                                       form, monkeypatch):
    dev = _card()
    if table == "dragon":
        clu, sup = scene_rays["dragon"][:2]
        clu_h = clu.cpu()
    else:
        clu_h, sup_h = synthetic_table(7)
        clu, sup = clu_h.to(dev), sup_h.to(dev)
    rays = tuple(x.to(dev) for x in adversarial_rays(200_003, 11, clu_h))
    _equal_forms(form, rays, clu, sup, monkeypatch)


@pytest.mark.parametrize("n", [0, 1, 31, 1025, 1_000_003])
def test_kernel_ragged_and_empty_counts(scene_rays, n, monkeypatch):
    """Counts that fill no block of the kernel (and none at all)."""
    clu, sup, passes = scene_rays["dragon"][:3]
    closest_rays, shadow_rays = passes[0]
    TC.reset_launch_counts()
    for form in ("third_packed", "segment_second", "pair3_packed"):
        rays = shadow_rays if form[0] in "sp" else closest_rays
        got = _equal_forms(form, tuple(x[:n] for x in rays), clu, sup,
                           monkeypatch)
        assert all(g.shape == (n,) for g in got)
    launched = int(n > 0)
    assert BP.nearest_cluster.launches == 2 * launched
    assert BP.nearest_cluster.launches_pair == launched


def test_kernel_ranks_equal_k5_keys(scene_rays):
    """Ranks 1-2 against K5's cluster keys (``broadphase_kernel`` in its
    keys+second mode) on dragon's primary and bounce-1 rays."""
    _card()
    clu, _, passes, tri, bvh = scene_rays["dragon"]
    for (o, d, m, *_), _ in passes:
        _, k1, k2 = BP.nearest_cluster(o, d, m, clu, bvh, return_key=True,
                                       return_second=1, return_packed=True)
        f1, f2, _ = BP.broadphase_keys(o, d, m, clu, tri, bvh, want2=True)
        assert torch.equal(k1, f1) and torch.equal(k2, f2)


CONFIGS = {  # config -> (single-direction launches, pair launches) a sample
    "B": (dict(compaction=True), (2, 1)),
    "rank_trace=2": (dict(compaction=True, rank_trace=2), (2, 1)),
    "D": (dict(compaction=True, fused_broadphase=True), (1, 0)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_launches_of_one_sample(config):
    """One eager dragon sample: config B and ``rank_trace=2`` launch the
    kernel twice in one direction (bounce 1's ranks, the last bounce's
    super-level shadow fold) and once as the pair; config D (K5's keys)
    once, the super-level fold."""
    dev = _card()
    kw, (single, pair) = CONFIGS[config]
    r = R.Renderer(get_scene("dragon", 256, 256),
                   RenderConfig(width=256, height=256, **kw), device=dev)
    TC.reset_launch_counts()
    R.render_sample(r.data, r.spec, r.cfg, r.offsets, 0, r.tracer,
                    baked_tables=r.baked)
    torch.cuda.synchronize()
    assert (BP.nearest_cluster.launches,
            BP.nearest_cluster.launches_pair) == (single, pair)


@pytest.mark.parametrize("config", ["B", "rank_trace=2"])
def test_compaction_image_equals_plain_chain(config, monkeypatch):
    """Dragon 512x512 through the graphed main path: the image with the
    kernel's keys equals the image with the plain chain's, bit for bit."""
    dev = _card()
    kw = CONFIGS[config][0]
    images = []
    for plain in (False, True):
        with monkeypatch.context() as mp:
            if plain:
                mp.setattr(BP, "_device_path", lambda o: False)
            r = R.Renderer(get_scene("dragon", 512, 512),
                           RenderConfig(width=512, height=512, **kw),
                           device=dev)
            r.render(4)
            torch.cuda.synchronize()
            images.append(r.accum.clone())
    assert torch.equal(images[0], images[1])
