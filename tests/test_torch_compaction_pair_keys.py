"""The sort keys' pair sweep (``nearest_cluster_pair``) against the JAX
function, and against the port's two separate calls, on coatball 64x48 and
dragon 32x24 (``torch_port_common.compaction_scene``) with rays from numpy
seeds: int32 keys and ids equal on every ray; and the broad phase's chunked
sweep gives the keys of the whole one."""

import jax.numpy as jnp
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from torch_port_common import (COMPACTION_RAYS, assert_int32_equal,
                               compaction_scene,
                               few_torch_threads,  # noqa: F401
                               seeded_rays)


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec)."""
    return {name: compaction_scene(name) for name in ("coatball", "dragon")}


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("packed", [False, True], ids=["ids", "packed"])
@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("scene", ["coatball", "dragon"])
def test_nearest_cluster_pair_equals_reference(scenes, scene, ranks, packed):
    jdata, jspec, tdata, tspec = scenes[scene]
    o, d_sh, m_sh, mt = seeded_rays(COMPACTION_RAYS, 31, tdata)
    _, d_nb, m_nb, _ = seeded_rays(COMPACTION_RAYS, 32, tdata)
    got = BP.nearest_cluster_pair(o, d_sh, mt, m_sh, d_nb, m_nb,
                                  tdata.clu_planes, tspec.bvh, ranks=ranks,
                                  return_packed=packed)
    ref = TP.nearest_cluster_pair(_j(o), _j(d_sh), _j(mt), _j(m_sh), _j(d_nb),
                                  _j(m_nb), jdata.clu_planes, jspec.bvh,
                                  ranks=ranks, return_packed=packed)
    assert_int32_equal(got, ref)
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
    o, d, m, mt = seeded_rays(COMPACTION_RAYS, 9, tdata)
    kw = dict(return_key=True, return_second=2, return_packed=True)
    whole = BP.nearest_cluster(o, d, m, tdata.clu_planes, tspec.bvh, **kw)
    pair = BP.nearest_cluster_pair(o, d, mt, m, d.flip(0), m,
                                   tdata.clu_planes, tspec.bvh, ranks=3)
    monkeypatch.setattr(BP, "_SWEEP_CHUNK_BYTES", 100 * 344 * 4)
    assert len(list(BP._sweep_chunks(COMPACTION_RAYS, 344))) == 8
    for a, b in zip(whole, BP.nearest_cluster(o, d, m, tdata.clu_planes,
                                              tspec.bvh, **kw)):
        assert torch.equal(a, b)
    for a, b in zip(pair, BP.nearest_cluster_pair(
            o, d, mt, m, d.flip(0), m, tdata.clu_planes, tspec.bvh, ranks=3)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="ranks"):
        BP.nearest_cluster_pair(o, d, mt, m, d, m, tdata.clu_planes,
                                tspec.bvh, ranks=4)
