"""Helpers shared by the port's tests (``tests/test_torch_*.py``): one JAX
scene build carried across to the port, the rays of every trace pass of one
port sample, and the scene builds, rays and models that several test files
share.

Every port test file keeps to at most 9 collected items, the count of
``tests/test_sharding.py``: ``pytest -n 6 --dist loadfile`` hands out files
in order of their item count (ties in collection order), and
``test_sharding.py``, the suite's longest file, must start as early as it
can, or the suite's wall moves.  ``tests/test_torch_suite_order.py`` holds
the rule.  So the tests of one concern often span several files, and the
builds they share live here, each computed once per test run under its
arguments (``run_cached``), whichever worker runs the files that use it.

The module imports no JAX: the card runs the files that use only its
JAX-free helpers with ``--noconftest``."""

import atexit
import dataclasses
import fcntl
import functools
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.scene import scene_data_from_reference
from metal_raytracing_tpu_torch.types import RenderConfig


def _remove_own(path):
    """At its exit a worker removes the files it computed (or failed to);
    a worker that asks later computes the value again."""
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def run_cached(fn):
    """``fn`` computed once per test run and argument tuple, and unpickled
    afresh at every call, so a test that writes into what it got cannot
    change what a later test (of any file) gets.  Under pytest-xdist the
    first worker to ask computes it, holding a lock on the file (in the
    temporary directory, named after the run) it leaves the pickle in, and
    the others wait and read that file."""
    @functools.cache
    def pickled(*args):
        run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
        if run is None:
            return pickle.dumps(fn(*args))
        name = "-".join(map(str, ("torch-port-tests", run, fn.__name__)
                            + args))
        path = os.path.join(tempfile.gettempdir(), name)
        with open(path, "a+b") as f:
            fcntl.flock(f, fcntl.LOCK_EX)  # released when f closes
            if os.fstat(f.fileno()).st_size == 0:
                atexit.register(_remove_own, path)
                blob = pickle.dumps(fn(*args))
                f.write(blob)
                return blob
            f.seek(0)
            return f.read()

    @functools.wraps(fn)
    def get(*args):
        return pickle.loads(pickled(*args))

    return get


def jax_scene_arrays(data) -> dict:
    """The JAX package's ``SceneData`` as numpy arrays under the keys
    ``scene_data_from_reference`` reads."""
    out = {}
    for name, value in data._asdict().items():
        if value is None:
            continue
        if hasattr(value, "_asdict"):
            for sub, arr in value._asdict().items():
                out[f"{name}.{sub}"] = np.asarray(arr)
        else:
            out[name] = np.asarray(value)
    return out


def build_both(scene: str, width: int, height: int, cluster_size: int = 384,
               branching: int = 8):
    """(JAX data, JAX spec, port data, port spec) of one JAX build of
    ``scene`` from the procedural stand-ins, carried to the port on the
    CPU."""
    from metal_raytracing_tpu.io import procedural as jproc
    from metal_raytracing_tpu.scenes import library as jlib

    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    try:
        jdata, jspec = jlib.get_scene(scene, width, height).build(
            cluster_size=cluster_size, branching=branching,
            builder="sah_free")
    finally:
        mp.undo()
    tdata, tspec = scene_data_from_reference(jax_scene_arrays(jdata), jspec,
                                             "cpu")
    return jdata, jspec, tdata, tspec


def record_passes(tdata, tspec, cfg) -> dict:
    """The (o, d, mask, seed) of every closest pass and the (o, d, max_t,
    mask) of every shadow pass of one port sample, through the plain
    tracers."""
    closest, any_hit = R.make_tracers(tdata, tspec, "torch")
    calls = {"closest": [], "any": []}

    def rec_closest(o, d, m, seed):
        calls["closest"].append((o.contiguous(), d, m, seed))
        return closest(o, d, m, seed)

    def rec_any(o, d, mt, m):
        calls["any"].append((o, d, mt, m))
        return any_hit(o, d, mt, m)

    R.render_sample(tdata, tspec, cfg, R.make_pixel_offsets(cfg), 0,
                    tracers=(rec_closest, rec_any))
    return calls


def _ray_rows(*cols) -> list:
    """One bytes key per ray from its columns' bits."""
    rows = torch.cat([c.reshape(c.shape[0], -1).view(torch.int32)
                      for c in cols], dim=1)
    return [r.tobytes() for r in rows.numpy()]


class MemoTracers:
    """The plain (closest, any_hit) pair of ``R.make_tracers`` with a
    per-ray memo: each call traces only the live rays no earlier call
    traced, and takes the rest from the memo.  A traced ray's result depends
    only on the ray (origin, direction, seed, segment length, and whether
    it runs on the baked tables), so configs that trace the same rays in
    other orders share the bits."""

    def __init__(self, tdata, tspec, baked=None):
        self.closest_fn, self.any_fn = R.make_tracers(tdata, tspec, "torch",
                                                      baked=baked)
        self.hits, self.occ = {}, {}

    def _split(self, memo, keys, mask):
        live = mask.nonzero()[:, 0].tolist()
        new = torch.zeros_like(mask)
        new[[i for i in live if keys[i] not in memo]] = True
        return live, new

    def closest(self, o, d, m, seed, seed_base=None, baked=False):
        none = torch.full((o.shape[0], 1), -1, dtype=torch.int32)
        keys = _ray_rows(o, d, none if seed is None else seed[:, None],
                         none if seed_base is None else seed_base[:, None],
                         torch.full_like(none, int(baked)))
        live, new = self._split(self.hits, keys, m)
        hit = self.closest_fn(o, d, new, seed, seed_base, baked=baked)
        t, tri = hit.t.clone(), hit.tri.clone()
        for i in live:
            if new[i]:
                self.hits[keys[i]] = (t[i].item(), tri[i].item())
            else:
                t[i], tri[i] = self.hits[keys[i]]
        return dataclasses.replace(hit, t=t, tri=tri)

    def any_hit(self, o, d, mt, m):
        keys = _ray_rows(o, d, mt[:, None])
        live, new = self._split(self.occ, keys, m)
        occ = self.any_fn(o, d, mt, new).clone()
        for i in live:
            if new[i]:
                self.occ[keys[i]] = occ[i].item()
            else:
                occ[i] = self.occ[keys[i]]
        return occ


@pytest.fixture(scope="module", autouse=True)
def procedural_models():
    """Both packages build their scenes from the procedural stand-ins.  A
    test module that imports this fixture uses it for all its tests."""
    from metal_raytracing_tpu.io import procedural as jproc
    from metal_raytracing_tpu.scenes import library as jlib
    from metal_raytracing_tpu_torch.io import procedural as tproc
    from metal_raytracing_tpu_torch.scenes import library as tlib

    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    mp.setattr(tlib, "resolve_model", lambda n, prefer_file=True:
               tproc.make_model(n))
    yield
    mp.undo()


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores.  A test module that
    imports this fixture uses it for all its tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


# Every builder of ``accel.build_cluster_bvh``, and the pre-split: label ->
# its keywords.
BUILDS = {
    "sah": dict(builder="sah"),
    "sah_free": dict(builder="sah_free"),
    "sah_chunk": dict(builder="sah_chunk"),
    "median": dict(builder="median"),
    "morton": dict(builder="morton"),
    "ploc": dict(builder="ploc"),
    "presplit": dict(builder="sah_free", presplit=0.3),
}


# ids (occlusion flags) must agree on this share of live rays; every closest
# id mismatch must be a near-tie: both winners' exact t within 2^-13
# relative (the packed key chops t to 2^-14 relative, and two walks visit
# clusters in different orders).
MIN_MATCH = 0.999
NEAR_TIE_REL = 2.0 ** -13


def assert_near_ties(o, d, tri, ref_tri, live, planes) -> int:
    """Every live ray whose two closest ids differ is a near-tie: both are
    hits, and their exact t agree within NEAR_TIE_REL.  Returns the number
    of such rays."""
    bad = live & (tri != ref_tri)
    if bad.any():
        assert (tri[bad] >= 0).all() and (ref_tri[bad] >= 0).all()
        ta, _, _ = TC.recompute_tuv(o[bad], d[bad],
                                    planes[:, torch.from_numpy(tri[bad])].T)
        tb, _, _ = TC.recompute_tuv(
            o[bad], d[bad], planes[:, torch.from_numpy(ref_tri[bad])].T)
        assert float(((ta - tb).abs() / tb.abs()).max()) <= NEAR_TIE_REL
    return int(bad.sum())


_TRIS = {}


def triangles(scene: str, size: int):
    """(v0, e1, e2) of the port's flattened ``scene`` (its procedural
    stand-ins)."""
    from metal_raytracing_tpu_torch.io import procedural as tproc
    from metal_raytracing_tpu_torch.scene import flatten_instances
    from metal_raytracing_tpu_torch.scenes import library as tlib

    if scene not in _TRIS:
        mp = pytest.MonkeyPatch()
        mp.setattr(tlib, "resolve_model", lambda n, prefer_file=True:
                   tproc.make_model(n))
        try:
            inst = tlib.get_scene(scene, size, size).instances
        finally:
            mp.undo()
        _TRIS[scene] = flatten_instances(inst)[:3]
    return _TRIS[scene]


def sample_ray_table(v0, m: int = 512, seed: int = 3) -> np.ndarray:
    """A seeded (M, 8) ``[o d max_t live]`` ray table over the box of the
    points ``v0``, as ``RenderConfig.export_rays`` exports."""
    lo, hi = v0.min(axis=0), v0.max(axis=0)
    rng = np.random.RandomState(seed)
    o = rng.uniform(lo, hi, (m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    maxt = np.where(rng.rand(m) < 0.5, np.inf, 2.0).astype(np.float32)
    live = (rng.rand(m) < 0.9).astype(np.float32)
    return np.concatenate([o, d, maxt[:, None], live[:, None]], axis=1)


def seeded_rays(n: int, seed: int, data, live: float = 0.85):
    """(o, d, mask, max_t) torch tensors from a numpy seed: origins uniform
    over the scene's root box grown by a quarter, unit directions, about
    ``live`` of the rays unmasked, segment lengths up to the box's size."""
    rng = np.random.RandomState(seed)
    lo = data.node_lo[0].numpy()
    hi = data.node_hi[0].numpy()
    ext = hi - lo
    o = rng.uniform(lo - 0.25 * ext, hi + 0.25 * ext, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mask = rng.rand(n) < live
    max_t = rng.uniform(0.05, 1.0, (n,)) * float(np.linalg.norm(ext))
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)), torch.from_numpy(mask),
            torch.from_numpy(max_t.astype(np.float32)))


# ---------------------------------------------------------------------------
# The schedule: a numpy model of one warp's grouped leaf service (the
# closest-hit kernels K1, K3 and K6 share its closest half, the any-hit
# kernels K2 and K4 its any half, csrc/trace_warp.cuh)
# ---------------------------------------------------------------------------

WARP = 32
STEP = 64  # slots the warp tests in one step of the leaf service, two a lane
_F = np.float32
_INIT = np.int32(TC._INIT_KEY)


def plane_hit_np(p, o, d):
    """``plane_hit`` of ``csrc/trace_common.cuh`` in float32 numpy, op for
    op: plane values p (12, L) of L lanes' slots against one ray."""
    with np.errstate(all="ignore"):
        den = p[0] * d[0] + p[1] * d[1] + p[2] * d[2]
        rcp = _F(1.0) / den
        rcp = rcp * (_F(2.0) - den * rcp)
        t = (p[3] - (p[0] * o[0] + p[1] * o[1] + p[2] * o[2])) * rcp
        px, py, pz = o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]
        u = p[4] * px + p[5] * py + p[6] * pz + p[7]
        v = p[8] * px + p[9] * py + p[10] * pz + p[11]
        hit = (u >= 0) & (v >= 0) & (u + v <= _F(1.0)) & (t > _F(1e-6))
    assert t.dtype == np.float32
    return t, hit


def step_planes(tri, base, j0, count):
    """The 32 lanes' plane values of step j0: lane l holds slots base + j0 +
    l and base + j0 + 32 + l (columns l and 32 + l here), zeros (never hit)
    past ``count``."""
    p = np.zeros((12, STEP), np.float32)
    width = min(STEP, count - j0)
    p[:, :width] = tri[:, base + j0:base + j0 + width]
    return p


def warp_groups(req):
    """The warp's requests grouped as the kernels do: the lowest requesting
    lane leads, every lane with its cluster joins."""
    pending = [lane for lane in range(len(req)) if req[lane] >= 0]
    while pending:
        c = req[pending[0]]
        group = [lane for lane in pending if req[lane] == c]
        pending = [lane for lane in pending if req[lane] != c]
        yield int(c), group


def serve_closest_np(tri, base, count, o, d, group, steps):
    """``serve_closest``: per ray of the group, the minimum over steps of
    the lanes' minimum key (each lane the smaller of its two slots' keys,
    then ``__reduce_min_sync``)."""
    vkey = {lane: _INIT for lane in group}
    for j0 in range(0, count, STEP):
        p = step_planes(tri, base, j0, count)
        j = np.arange(j0, j0 + STEP, dtype=np.int32)
        for lane in group:
            t, hit = plane_hit_np(p, o[lane], d[lane])
            k = np.where(hit, (t.view(np.int32) & ~TC.IDX_MASK) | j, _INIT)
            per_lane = np.minimum(k[:WARP], k[WARP:])
            vkey[lane] = min(vkey[lane], per_lane.min())
            steps[0] += 1
    return vkey


def model_closest(o, d, mask, seed, seed_base, tri, bvh, rounds):
    """K1, K3 or K6 as its warps run it, given each round's requests:
    returns (t, tri, warp steps).  A step is 64 slots against one ray."""
    n, c = o.shape[0], bvh.cluster_size
    key = seed.copy()
    base = (np.full(n, bvh.global_base, np.int32) if seed_base is None
            else seed_base.copy())
    steps = [0]
    for req in rounds:
        assert (req[~mask] < 0).all()
        for w0 in range(0, n, WARP):
            sl = slice(w0, min(n, w0 + WARP))
            for cid, group in warp_groups(req[sl]):
                vkey = serve_closest_np(tri, cid * c, c, o[sl], d[sl],
                                        group, steps)
                for lane in group:
                    if vkey[lane] < key[w0 + lane]:  # strictly smaller only
                        key[w0 + lane] = vkey[lane]
                        base[w0 + lane] = cid * c
    t = (key & ~TC.IDX_MASK).view(np.float32)
    tri_id = np.where(key < TC._MISS_KEY, base + (key & TC.IDX_MASK), -1)
    return t, tri_id, steps[0]


def serve_any_np(tri, base, count, o, d, max_t, group, steps):
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
        hit = serve_any_np(tri, bvh.global_base, g_slots, o[sl], d[sl],
                           max_t[sl], live, steps)
        occ[[w0 + lane for lane in hit]] = True
    for req in rounds:
        assert (req[occ | ~mask] < 0).all()  # an occluded ray has left
        for w0 in range(0, n, WARP):
            sl = slice(w0, min(n, w0 + WARP))
            for cid, group in warp_groups(req[sl]):
                hit = serve_any_np(tri, cid * c, c, o[sl], d[sl], max_t[sl],
                                   group, steps)
                occ[[w0 + lane for lane in hit]] = True
    return occ, steps[0]


# The reference's golden gate (tests/test_golden.py): image RMSE and the
# largest pixel difference.
GATE_RMSE = 1e-3
GATE_MAX = 5e-2


def assert_image_gate(got, ref, what: str, worst: int = 5) -> None:
    """``got`` within the golden gate of ``ref`` ((H, W, 3) arrays); the
    message names the ``worst`` pixels with both values."""
    diff = np.asarray(got, np.float64) - np.asarray(ref, np.float64)
    err = float(np.sqrt(np.mean(diff ** 2)))
    per_px = np.abs(diff).max(axis=-1)
    top = np.argsort(per_px, axis=None)[::-1][:worst]
    pixels = "; ".join(
        f"(y={y}, x={x}) {np.asarray(got)[y, x]} vs {np.asarray(ref)[y, x]}"
        for y, x in zip(*np.unravel_index(top, per_px.shape)))
    msg = (f"{what}: RMSE {err:.3e} (gate {GATE_RMSE}), max "
           f"{per_px.max():.3e} (gate {GATE_MAX}); worst pixels, port vs "
           f"reference: {pixels}")
    assert err < GATE_RMSE and per_px.max() < GATE_MAX, msg


# ---------------------------------------------------------------------------
# Scene builds and recorded passes that several test files share
# ---------------------------------------------------------------------------


@run_cached
def scene_passes(scene: str, width: int, height: int):
    """(JAX data, JAX spec, port data, port spec, passes): ``build_both`` of
    ``scene`` and ``record_passes`` of one port sample at its size and the
    default config."""
    jdata, jspec, tdata, tspec = build_both(scene, width, height)
    calls = record_passes(tdata, tspec,
                          RenderConfig(width=width, height=height))
    return jdata, jspec, tdata, tspec, calls


def coatball_passes():
    """``scene_passes`` of coatball at 64x48: 37 clusters in 5 supers of 8,
    which take the flat kernels unless ``flat=False``."""
    return scene_passes("coatball", 64, 48)


def torch_of(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def jax_of(*arrays):
    import jax.numpy as jnp

    return tuple(jnp.asarray(a) for a in arrays)


def numpy_of(*tensors):
    return tuple(x.numpy() for x in tensors)


def traversal_block(bounce):
    """The renderer's traversal block: primary passes use 512."""
    return 512 if bounce == 0 else 128


# ---------------------------------------------------------------------------
# The walking plain versions (tests/test_torch_hier_walk_*.py,
# tests/test_torch_flat_walk*.py)
# ---------------------------------------------------------------------------

WALK_SIZES = {"coatball": (64, 48), "dragon": (32, 24)}
WALK_LAYOUT = {"coatball": (8, 5), "dragon": (8, 43)}


def walk_scenes(*names) -> dict:
    """scene -> (JAX data, JAX spec, port data, port spec, passes) of each
    of ``names``: coatball at 64x48 (37 clusters, 5 supers of 8), dragon at
    32x24 (344 clusters, 43 supers of 8)."""
    out = {}
    for name in names:
        out[name] = scene_passes(name, *WALK_SIZES[name])
        tspec = out[name][3]
        assert TC.super_layout(tspec.bvh) == WALK_LAYOUT[name]
        assert tspec.bvh.num_global > 0
    return out


@run_cached
def brute_force_pass(scene, kind, bounce):
    """The brute-force plain version's result (``closest_flat_ref`` or
    ``any_flat_ref``) on one recorded pass of ``walk_scenes``, computed once
    for the tests of both walks."""
    _, _, tdata, tspec, calls = scene_passes(scene, *WALK_SIZES[scene])
    if kind == "closest":
        o, d, m, seed = calls["closest"][bounce]
        return TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh, seed)
    o, d, mt, m = calls["any"][bounce]
    return TC.any_flat_ref(o, d, mt, m, tdata.tri_planes, tspec.bvh)


def hier_tables(tdata, tspec):
    return tdata.sup_planes, tdata.clu_planes, tdata.tri_planes, tspec.bvh


def flat_tables(tdata, tspec):
    return tdata.clu_planes, tdata.tri_planes, tspec.bvh


def in_cluster(tri, bvh):
    """Rays whose winner is a clustered triangle (not a global one)."""
    return (tri >= 0) & (tri < bvh.num_clusters * bvh.cluster_size)


def rank_seed(tdata, tspec, calls, bounce=1):
    """(rays, key, base) of the rank walk's best on one closest pass: a
    per-ray seed and seed base for the hierarchical walk."""
    from metal_raytracing_tpu_torch.ops import rank_cuda as RK

    o, d, m, seed = calls["closest"][bounce]
    _, k1, k2, _ = BP.nearest_cluster(o, d, m, tdata.clu_planes, tspec.bvh,
                                      return_key=True, return_second=2,
                                      return_packed=True)
    key, base = RK.closest_rank_ref(o, d, m, [k1, k2], tdata.tri_planes,
                                    tspec.bvh, seed)
    return (o, d, m), key, base


# ---------------------------------------------------------------------------
# The rank walk (K6) on coatball (tests/test_torch_rank*.py)
# ---------------------------------------------------------------------------


@run_cached
def rank_setup():
    """(JAX data, JAX spec, port data, port spec, passes) on coatball; each
    pass is ((o, d, mask), seed key, rank keys 1..3)."""
    jdata, jspec, tdata, tspec, calls = coatball_passes()
    assert tspec.bvh.num_global > 0
    passes = []
    for o, d, m, seed in calls["closest"]:
        _, k1, k2, k3 = BP.nearest_cluster(
            o, d, m, tdata.clu_planes, tspec.bvh, return_key=True,
            return_second=2, return_packed=True)
        passes.append(((o, d, m), seed, (k1, k2, k3)))
    assert len(passes) == 3
    return jdata, jspec, tdata, tspec, passes


def rank_bounce1(setup):
    """(JAX data, JAX spec, port data, port spec, rays, seed, rank keys) of
    the bounce-1 pass."""
    return setup[:4] + setup[4][1]


@run_cached
def rank_walks(bounce):
    """(port key, port base, TPU key, TPU base) of one pass's rank walk on
    ``rank_setup``."""
    import jax.numpy as jnp

    from metal_raytracing_tpu.ops import trace_pallas as TP
    from metal_raytracing_tpu_torch.ops import rank_cuda as RK

    def _j(x):
        return jnp.asarray(x.numpy())

    jdata, jspec, tdata, tspec, passes = rank_setup()
    (o, d, m), seed, (k1, k2, _) = passes[bounce]
    key, base = RK.closest_rank_ref(o, d, m, [k1, k2], tdata.tri_planes,
                                    tspec.bvh, seed)
    jkey, jbase = TP.trace_closest_rank(
        _j(o), _j(d), _j(m), [_j(k1), _j(k2)], jdata.tri_planes,
        jspec.bvh, seed_key=_j(seed))
    return (key, base, torch.from_numpy(np.array(jkey)),
            torch.from_numpy(np.array(jbase)))


def decode_key(key, base):
    found = key < TC._MISS_KEY
    return torch.where(found, base + (key & TC.IDX_MASK), -1).numpy()


# ---------------------------------------------------------------------------
# Wavefront compaction on coatball 64x48 and dragon 32x24
# (tests/test_torch_compaction*.py)
# ---------------------------------------------------------------------------

COMPACTION_SIZES = {"coatball": (64, 48), "dragon": (32, 24)}
COMPACTION_RAYS = 768

# keyword arguments of nearest_cluster per return form; "max_t" is filled in
JAX_FORMS = {
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


def assert_int32_equal(got, ref):
    """A port result (a tensor or a tuple of them) int32 and equal to the
    JAX one."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@functools.cache
def _compaction_dragon():
    """dragon's JAX renderer at ``rank_trace=2`` (the JAX package's default
    wavefront is ``compaction=True``) and its tables carried to the port."""
    from metal_raytracing_tpu import renderer as JR
    from metal_raytracing_tpu.io import procedural as jproc
    from metal_raytracing_tpu.scenes import library as jlib
    from metal_raytracing_tpu.types import RenderConfig as JConfig

    w, h = COMPACTION_SIZES["dragon"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    try:
        jr = JR.Renderer(jlib.get_scene("dragon", w, h),
                         JConfig(width=w, height=h, rank_trace=2))
    finally:
        mp.undo()
    tdata, tspec = scene_data_from_reference(jax_scene_arrays(jr.data),
                                             jr.spec, "cpu")
    return jr, tdata, tspec


@run_cached
def compaction_scene(scene):
    """(JAX data, JAX spec, port data, port spec): coatball's
    ``build_both``; dragon's JAX side is the renderer of
    ``compaction_dragon_renderer``."""
    if scene == "coatball":
        return build_both("coatball", *COMPACTION_SIZES["coatball"])
    jr, tdata, tspec = _compaction_dragon()
    return jr.data, jr.spec, tdata, tspec


@functools.cache
def compaction_dragon_renderer():
    """dragon's JAX renderer after 1 spp.  Handed out as it is: its one
    reader reads its image and its ray totals."""
    jr = _compaction_dragon()[0]
    jr.render(1)
    return jr


@functools.cache
def _compaction_memo():
    """One per-ray memo of the plain tracers for all of dragon's configs."""
    return MemoTracers(*compaction_scene("dragon")[2:])


@run_cached
def _compaction_render(scene, config):
    _, _, tdata, tspec = compaction_scene(scene)
    w, h = COMPACTION_SIZES[scene]
    cfg = RenderConfig(width=w, height=h, **dict(config))
    tracers = None
    if scene == "dragon":
        memo = _compaction_memo()
        tracers = (memo.closest, memo.any_hit)
    img, stats = R.render_sample(tdata, tspec, cfg, R.make_pixel_offsets(cfg),
                                 0, tracers=tracers)
    return img.numpy(), {k: int(v) for k, v in stats.items()}


def compaction_render(scene, **kw):
    """``(image, stats)`` of one port sample of ``scene`` at the given
    config, each (scene, config) rendered once per test run; coatball on the
    plain tracers, all of dragon's configs through one
    :class:`MemoTracers`."""
    return _compaction_render(scene, tuple(sorted(kw.items())))


# ---------------------------------------------------------------------------
# The scene build at 64x48 (tests/test_torch_scene*.py)
# ---------------------------------------------------------------------------


@run_cached
def scene_tables(scene):
    """(JAX arrays, JAX spec, port arrays, port spec) of one scene at 64x48,
    built by each package at the renderer's defaults (sah_free, 384).  The
    calling module patches in the procedural stand-ins
    (``procedural_models``)."""
    from metal_raytracing_tpu.scenes import library as jlib
    from metal_raytracing_tpu_torch.scene import scene_data_arrays
    from metal_raytracing_tpu_torch.scenes import library as tlib

    jdata, jspec = jlib.get_scene(scene, 64, 48).build(
        cluster_size=384, builder="sah_free")
    tdata, tspec = tlib.get_scene(scene, 64, 48).build(
        cluster_size=384, builder="sah_free", device="cpu")
    return (jax_scene_arrays(jdata), jspec, scene_data_arrays(tdata), tspec)


# ---------------------------------------------------------------------------
# The exact tracers' packet walk on plane_sphere 32x32
# (tests/test_torch_trace_bvh*.py)
# ---------------------------------------------------------------------------

PACKET_BUILDS = [(64, 8), (32, 2), (384, 8)]
# every build under a full and a partial mask, the default one under an
# empty mask too
PACKET_CASES = ([(b, m) for b in PACKET_BUILDS for m in ("full", "partial")]
                + [((384, 8), "none")])
PACKET_CASE_IDS = [f"c{b[0]}b{b[1]}-{m}" for b, m in PACKET_CASES]
PACKET_RAYS = 512
PACKET_BLOCK = 128
PACKET_T_RTOL = 1e-5


@run_cached
def plane_sphere_build(cluster_size, branching):
    """(JAX data, JAX spec, port data, port spec) of plane_sphere 32x32 at
    one (cluster size, branching)."""
    return build_both("plane_sphere", 32, 32, cluster_size, branching)


def packet_rays(n, seed):
    """(o, d, max_t) numpy float32: origins in [-3, 3]^3 above the floor
    (hits likely), unit directions, segment lengths in [0.5, 6]."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1])
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = rng.uniform(0.5, 6.0, n).astype(np.float32)
    return o, d, max_t


def packet_mask(kind, n, seed=7):
    if kind == "full":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    return np.random.RandomState(seed).rand(n) < 0.6


def assert_closest_gate(got, ref_t, ref_tri, tri_src, what):
    """tests/test_trace.py's gate: found equal, t rtol 1e-5 on hits, source
    triangles equal."""
    from metal_raytracing_tpu_torch.ops.intersect import BIG_T

    ref_t, ref_tri = np.asarray(ref_t), np.asarray(ref_tri)
    tri = got.tri.numpy()
    np.testing.assert_array_equal(tri >= 0, ref_tri >= 0, err_msg=what)
    hits = ref_tri >= 0
    np.testing.assert_allclose(got.t.numpy()[hits], ref_t[hits],
                               rtol=PACKET_T_RTOL, err_msg=what)
    np.testing.assert_array_equal(tri_src[tri[hits]], tri_src[ref_tri[hits]],
                                  err_msg=what)
    misses = ~hits
    assert (got.t.numpy()[misses] == np.float32(BIG_T)).all(), what


# ---------------------------------------------------------------------------
# The exact broad phase as a kernel, ``nearest_cluster_kernel``
# (tests/test_torch_exact_broadphase_*.py; JAX-free, so its card cases run
# on the card)
# ---------------------------------------------------------------------------

# nearest_cluster's keyword arguments per form ("max_t": bounded, "sup": the
# super boxes as the table); "pair<r>" forms call nearest_cluster_pair
KERNEL_FORMS = {
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


def bounded_form(form) -> bool:
    """The forms on shadow segments: ``max_t`` and the pair."""
    return bool(form.startswith("pair") or KERNEL_FORMS[form].get("max_t"))


# the forms on closest rays, and those on shadow segments
UNBOUNDED_FORMS = [f for f in sorted(KERNEL_FORMS) if not bounded_form(f)]
BOUNDED_FORMS = [f for f in sorted(KERNEL_FORMS) if bounded_form(f)]


def run_form(form, rays, clu, sup):
    """``form`` on ``rays = (o, d, m, mt, d_nb, m_nb)``: a tuple of int32
    tensors."""
    o, d, m, mt, d_nb, m_nb = rays
    kw = dict(KERNEL_FORMS[form])
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
    from metal_raytracing_tpu_torch.ops.intersect import BIG_T

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


def bad_arguments(kind):
    """(the wrapper's arguments, the change that it must refuse) of one
    refusal case."""
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


def assert_refused(kind):
    """The wrapper raises ``ValueError`` on the refusal case ``kind``."""
    base, change = bad_arguments(kind)
    kw = {**base, **change}
    fn = BP.nearest_cluster_pair if "d_nb" in base else BP.nearest_cluster
    with pytest.raises(ValueError):
        fn(**kw)


CARD_SCENES = {"dragon": (1024, 1024), "coatball": (1024, 768)}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: nearest_cluster_kernel")
    return torch.device("cuda")


def plain_chain(fn, monkeypatch):
    """``fn()`` with the wrappers forced onto the plain chain."""
    with monkeypatch.context() as mp:
        mp.setattr(BP, "_device_path", lambda o: False)
        return fn()


@run_cached
def card_scene_rays():
    """scene -> (clu, sup, [primary rays, bounce-1 rays], tri, bvh) on the
    card from one sample of the default config: each pass's closest rays
    (``max_t`` from its shadow segments) and its shadow segments, both with
    the next pass's directions and mask for the pair's bounce chain."""
    from metal_raytracing_tpu_torch.scenes import get_scene

    dev = card()
    out = {}
    for name, (w, h) in CARD_SCENES.items():
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


def equal_forms(form, rays, clu, sup, monkeypatch):
    """``form`` through the kernel equal to it through the plain chain on
    the same card; returns the kernel's result."""
    got = run_form(form, rays, clu, sup)
    ref = plain_chain(lambda: run_form(form, rays, clu, sup), monkeypatch)
    torch.cuda.synchronize()
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32 and torch.equal(g, r), form
    return got


def assert_kernel_equals_plain_chain_on_scene_rays(scene_rays, scene, form,
                                                   monkeypatch):
    """Primary and bounce-1 rays: closest rays for the unbounded forms,
    shadow segments for the bounded ones and the pair."""
    clu, sup, passes = scene_rays[scene][:3]
    for closest_rays, shadow_rays in passes:
        rays = shadow_rays if bounded_form(form) else closest_rays
        got = equal_forms(form, rays, clu, sup, monkeypatch)
        live = rays[2]
        nc = (sup.shape[0] if KERNEL_FORMS[form].get("sup")
              else clu.shape[0] * clu.shape[1])
        assert (got[0][live] < nc).any() and (got[0][~live] == nc).all()


def assert_kernel_equals_plain_chain_on_adversarial_rays(scene_rays, table,
                                                         form, monkeypatch):
    """200,003 adversarial rays against dragon's cluster boxes or a
    synthetic table."""
    dev = card()
    if table == "dragon":
        clu, sup = scene_rays["dragon"][:2]
        clu_h = clu.cpu()
    else:
        clu_h, sup_h = synthetic_table(7)
        clu, sup = clu_h.to(dev), sup_h.to(dev)
    rays = tuple(x.to(dev) for x in adversarial_rays(200_003, 11, clu_h))
    equal_forms(form, rays, clu, sup, monkeypatch)


def assert_nearest_cluster_equals_reference(scenes, scene, form):
    """``nearest_cluster`` in one return form equal to the JAX function on
    seeded rays over ``scene``'s cluster boxes."""
    import jax.numpy as jnp

    from metal_raytracing_tpu.ops import trace_pallas as TP

    def _j(x):
        return jnp.asarray(x.numpy())

    jdata, jspec, tdata, tspec = scenes[scene]
    o, d, m, mt = seeded_rays(COMPACTION_RAYS, 3, tdata)
    kw = dict(JAX_FORMS[form])
    seg = kw.pop("max_t", False)
    got = BP.nearest_cluster(o, d, m, tdata.clu_planes, tspec.bvh,
                             max_t=mt if seg else None, **kw)
    ref = TP.nearest_cluster(_j(o), _j(d), _j(m), jdata.clu_planes, jspec.bvh,
                             max_t=_j(mt) if seg else None, **kw)
    assert_int32_equal(got, ref)
    first = got[0] if isinstance(got, tuple) else got
    ncp = tdata.clu_planes.shape[0] * tdata.clu_planes.shape[1]
    assert (first[m] < ncp).any() and (first[~m] == ncp).all()


def assert_super_boxes_equal_reference(scenes, scene):
    """The last bounce's shadow fold passes the super boxes as clusters."""
    import jax.numpy as jnp

    from metal_raytracing_tpu.ops import trace_pallas as TP

    def _j(x):
        return jnp.asarray(x.numpy())

    jdata, jspec, tdata, tspec = scenes[scene]
    o, d, m, mt = seeded_rays(COMPACTION_RAYS, 5, tdata)
    got = BP.nearest_cluster(o, d, m, tdata.sup_planes[:, None, :], tspec.bvh,
                             max_t=mt)
    ref = TP.nearest_cluster(_j(o), _j(d), _j(m),
                             jdata.sup_planes[:, None, :], jspec.bvh,
                             max_t=_j(mt))
    assert_int32_equal(got, ref)
