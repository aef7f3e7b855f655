"""Helpers shared by the port's tests (``tests/test_torch_*.py``): one JAX
scene build carried across to the port, and the rays of every trace pass of
one port sample."""

import numpy as np
import pytest
import torch

from metal_raytracing_tpu.io import procedural as jproc
from metal_raytracing_tpu.scenes import library as jlib
from metal_raytracing_tpu_torch import renderer as R
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


def build_both(scene: str, width: int, height: int):
    """(JAX data, JAX spec, port data, port spec) of one JAX build of
    ``scene`` from the procedural stand-ins, carried to the port on the
    CPU."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jlib, "resolve_model", lambda n, prefer_file=True:
               jproc.make_model(n))
    try:
        jdata, jspec = jlib.get_scene(scene, width, height).build(
            cluster_size=384, builder="sah_free")
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


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs several test processes at once; two intra-op threads
    each keep torch from oversubscribing the cores.  A test module that
    imports this fixture uses it for all its tests."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


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
    from metal_raytracing_tpu_torch.ops import trace_cuda as TC

    bad = live & (tri != ref_tri)
    if bad.any():
        assert (tri[bad] >= 0).all() and (ref_tri[bad] >= 0).all()
        ta, _, _ = TC.recompute_tuv(o[bad], d[bad],
                                    planes[:, torch.from_numpy(tri[bad])].T)
        tb, _, _ = TC.recompute_tuv(
            o[bad], d[bad], planes[:, torch.from_numpy(ref_tri[bad])].T)
        assert float(((ta - tb).abs() / tb.abs()).max()) <= NEAR_TIE_REL
    return int(bad.sum())


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
