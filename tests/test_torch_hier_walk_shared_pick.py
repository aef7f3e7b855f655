"""The box pick the warp shares when few lanes still walk (``coop_pick`` of
``csrc/trace_hier.cu``, in a float32 numpy model) against each lane's own
pick, ties included, on dragon 32x24's supers and clusters and over all of
coatball 64x48's cluster boxes; and the grouping of a warp's requests.
Set-ups as in ``tests/test_torch_hier_walk_brute_force.py``.
"""

import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (WARP, few_torch_threads,  # noqa: F401
                               walk_scenes, warp_groups)

_F = np.float32


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec, passes)."""
    return walk_scenes("coatball", "dragon")


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
