"""The plain versions of the hierarchical kernels (K3 closest, K4 any hit)
against the JAX package's Pallas kernels, run in interpret mode on the CPU;
the wrappers on the CPU, the super layout and the kernels' build.

Coatball at 64x48 has 37 clusters, 5 supers of 8; ``flat=False`` forces the
hierarchical kernels on it, as ``tests/test_trace_pallas.py`` does.  Both
sides see the same scene planes (one JAX build carried across) and the same
rays, recorded from the port's renderer: the primary, bounce-1 and shadow
passes (``torch_port_common.coatball_passes``).  The fused broad phase (K5)
is held in ``tests/test_torch_fused_broadphase.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (MIN_MATCH, NEAR_TIE_REL, assert_near_ties,
                               coatball_passes,
                               few_torch_threads,  # noqa: F401
                               traversal_block)


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, recorded passes)."""
    setup = coatball_passes()
    tspec = setup[3]
    assert TC.super_layout(tspec.bvh) == (8, 5)
    assert TC._use_flat(tspec.bvh) and tspec.bvh.num_global > 0
    return setup


def _j(x):
    return jnp.asarray(x.numpy())


_CLOSEST = {}


def closest_pair(setup, bounce):
    """(live, port t, port tri, JAX t, JAX tri) of one recorded closest
    pass: the plain version against the interpret-mode K3."""
    if bounce not in _CLOSEST:
        jdata, jspec, tdata, tspec, calls = setup
        o, d, m, seed = calls["closest"][bounce]
        ref = TP.trace_closest(_j(o), _j(d), _j(m), jdata.sup_planes,
                               jdata.clu_planes, jdata.tri_planes, jspec.bvh,
                               block=traversal_block(bounce),
                               seed_key=_j(seed),
                               exact_uv=False, flat=False)
        t, tri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh,
                                     seed)
        _CLOSEST[bounce] = (m.numpy(), t.numpy(), tri.numpy(),
                            np.asarray(ref.t), np.asarray(ref.tri))
    return _CLOSEST[bounce]


@pytest.mark.parametrize("bounce", [0, 1])
def test_closest_plain_matches_hierarchical_kernel(setup, bounce):
    _, _, tdata, _, calls = setup
    o, d, _, _ = calls["closest"][bounce]
    live, t, tri, jt, jtri = closest_pair(setup, bounce)
    assert live.sum() > 0.9 * live.size
    assert_near_ties(o, d, tri, jtri, live, tdata.tri_planes)
    # chopped t of the same winner: within the chop, plus 1e-4 absolute for
    # bounce rays that start 1e-3 off a surface (see test_torch_trace.py)
    both = live & (tri == jtri) & (tri >= 0)
    np.testing.assert_allclose(t[both], jt[both], rtol=NEAR_TIE_REL,
                               atol=1e-4)
    np.testing.assert_array_equal(tri[~live], jtri[~live])


def test_closest_hierarchical_ids_agree_on_live_rays(setup):
    n_live = n_same = 0
    for bounce in (0, 1):
        live, _, tri, _, jtri = closest_pair(setup, bounce)
        n_live += int(live.sum())
        n_same += int(((tri == jtri) & live).sum())
    assert n_same >= MIN_MATCH * n_live, (n_same, n_live)


@pytest.mark.parametrize("bounce", [0, 1])
def test_any_plain_matches_hierarchical_kernel(setup, bounce):
    jdata, jspec, tdata, tspec, calls = setup
    o, d, mt, m = calls["any"][bounce]
    ref = np.asarray(TP.trace_any(
        _j(o), _j(d), _j(mt), _j(m), jdata.sup_planes, jdata.clu_planes,
        jdata.tri_planes, jspec.bvh, block=traversal_block(bounce), flat=False,
        seed_global=False))
    got = TC.any_flat_ref(o, d, mt, m, tdata.tri_planes, tspec.bvh).numpy()
    live = m.numpy()
    assert live.sum() > 0 and got[live].any()
    assert ((got == ref) & live).sum() >= MIN_MATCH * live.sum()
    assert not got[~live].any() and not ref[~live].any()


def test_hierarchical_wrappers_run_plain_versions_on_cpu(setup):
    _, _, tdata, tspec, calls = setup
    o, d, m, seed = calls["closest"][1]
    before = (TC.trace_closest.launches_hier, TC.trace_any.launches_hier)
    hit = TC.trace_closest(o, d, m, tdata.sup_planes, tdata.clu_planes,
                           tdata.tri_planes, tspec.bvh, seed, flat=False)
    t, tri = TC.closest_flat_ref(o, d, m, tdata.tri_planes, tspec.bvh, seed)
    assert torch.equal(hit.tri, tri) and torch.equal(hit.t, t)
    o2, d2, mt2, m2 = calls["any"][1]
    occ = TC.trace_any(o2, d2, mt2, m2, tdata.sup_planes, tdata.clu_planes,
                       tdata.tri_planes, tspec.bvh, flat=False)
    assert torch.equal(occ, TC.any_flat_ref(o2, d2, mt2, m2,
                                            tdata.tri_planes, tspec.bvh))
    assert (TC.trace_closest.launches_hier,
            TC.trace_any.launches_hier) == before


def test_super_layout_of_a_dragon_sized_scene(setup):
    _, jspec, _, tspec, _ = setup
    big = dataclasses.replace(tspec.bvh, num_clusters=344)
    jbig = dataclasses.replace(jspec.bvh, num_clusters=344)
    assert TC.super_layout(big) == TP.super_layout(jbig) == (8, 43)
    assert not TC._use_flat(big) and TC._use_flat(big, True)


def test_build_compiles_every_kernel_source(tmp_path, monkeypatch):
    """One library from every ``csrc/*.cu``, keyed by the sources, the
    shared header and the flags; without nvcc the first launch raises."""
    from metal_raytracing_tpu_torch.ops import _build

    names = [p.rsplit("/", 1)[-1] for p in _build.sources()]
    assert names == ["broadphase.cu", "trace_bvh.cu", "trace_flat.cu",
                     "trace_hier.cu", "trace_rank.cu"]
    path = _build._library_path()
    assert path.startswith(_build.BUILD_DIR) and path.endswith(".so")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library()
