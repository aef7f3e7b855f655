"""Helpers shared by the port's tests (``tests/test_torch_*.py``): one JAX
scene build carried across to the port, and the rays of every trace pass of
one port sample.

The port's test files newer than ``tests/test_sharding.py`` keep to at most
its 9 collected items: ``pytest -n 6 --dist loadfile`` hands out files in
order of their item count, and ``test_sharding.py``, the suite's longest
file, must start as early as it did, or the suite's wall moves."""

import dataclasses

import numpy as np
import pytest
import torch

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu_torch import renderer as R
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from metal_raytracing_tpu_torch.scene import scene_data_from_reference


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
# closest-hit kernels K1, K3 and K6 share it, csrc/trace_warp.cuh)
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
