"""The schedule of the hierarchical kernels' shared leaf test (K3, K4) on
the CPU: a numpy model that replays the walk's rounds warp by warp, each
requested cluster's leaf test shared by the lanes that ask for it
(``model_closest`` and ``model_any`` in ``torch_port_common.py``), against
the walking plain versions ``closest_hier_ref`` / ``any_hier_ref``, exactly.
The minimum of packed keys and the OR of occlusion flags do not depend on
the order of the slots, and that is the claim the kernels' design rests
on.  Set-ups as in ``tests/test_torch_hier_walk_brute_force.py``.
"""

import numpy as np
import pytest

from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (STEP, few_torch_threads,  # noqa: F401
                               hier_tables, model_any, model_closest,
                               numpy_of, rank_seed, walk_scenes)

# (scene, bounce, first ray, ray count): whole warps, a ragged tail, and a
# stretch of dragon where neighbouring rays ask for different clusters
MODEL_CASES = [("coatball", 0, 1024, 512), ("coatball", 1, 0, 1000),
               ("dragon", 0, 256, 512), ("dragon", 1, 0, 333)]
MODEL_IDS = [f"{s}-bounce{b}-{n}rays" for s, b, _, n in MODEL_CASES]


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    return walk_scenes("coatball", "dragon")


@pytest.mark.parametrize("scene,bounce,start,count", MODEL_CASES,
                         ids=MODEL_IDS)
def test_warp_model_gives_the_closest_walks_keys(scenes, scene, bounce, start,
                                                 count):
    _, _, tdata, tspec, calls = scenes[scene]
    o, d, m, seed = (x[start:start + count] for x in calls["closest"][bounce])
    rounds = []
    t, tri, visits = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec),
                                         seed, rounds=rounds)
    assert len(rounds) == int(visits.max()) >= 2
    mt, mtri, steps = model_closest(*numpy_of(o, d, m, seed), None,
                                    tdata.tri_planes.numpy(), tspec.bvh,
                                    numpy_of(*rounds))
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
    occ, visits = TC.any_hier_ref(o, d, mt, m, *hier_tables(tdata, tspec),
                                  rounds=rounds)
    got, steps = model_any(*numpy_of(o, d, mt, m), tdata.tri_planes.numpy(),
                           tspec.bvh, numpy_of(*rounds))
    np.testing.assert_array_equal(got, occ.numpy())
    # leaving at the first occluding step saves steps, never adds any
    chunks = -(-tspec.bvh.cluster_size // STEP)
    g_chunks = -(-tspec.bvh.padded_global // STEP)
    most = int(visits.sum()) * chunks + int(m.sum()) * g_chunks
    assert 0 < steps <= most and (steps < most) == bool(occ.any())


def test_warp_model_with_seed_base(scenes):
    _, _, tdata, tspec, calls = scenes["coatball"]
    (o, d, m), key, base = rank_seed(tdata, tspec, calls)
    o, d, m, key, base = (x[:777] for x in (o, d, m, key, base))
    rounds = []
    t, tri, _ = TC.closest_hier_ref(o, d, m, *hier_tables(tdata, tspec), key,
                                    base, rounds=rounds)
    mt, mtri, _ = model_closest(*numpy_of(o, d, m, key, base),
                                tdata.tri_planes.numpy(), tspec.bvh,
                                numpy_of(*rounds))
    np.testing.assert_array_equal(mtri, tri.numpy())
    np.testing.assert_array_equal(mt.view(np.int32),
                                  t.numpy().view(np.int32))
