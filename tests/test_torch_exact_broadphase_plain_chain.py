"""The exact broad phase of the compaction sort keys (``nearest_cluster``,
``nearest_cluster_pair``, ``ops/broadphase_cuda.py``) on the CPU: CPU
tensors take the plain chain and launch nothing, and a numpy model of
``nearest_cluster_kernel``'s branch-free top-3 update and of its pair gives
the plain chain's keys.  The file imports no JAX."""

import numpy as np
import pytest
import torch

from metal_raytracing_tpu_torch.ops import broadphase_cuda as BP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import (KERNEL_FORMS, adversarial_rays, run_form,
                               synthetic_table)

CPU_FORMS = ("id", "second_packed", "third", "segment_second",
             "super_segment", "pair2", "pair3_packed")


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
        ranks = KERNEL_FORMS[form]["ranks"]
        skey, keys = BP.nearest_cluster_pair_ref(o, d, mt, m, d_nb, m_nb,
                                                 clu.reshape(-1, 6), ranks)
        assert torch.equal(got[0], BP.decode_cluster_key(skey, 48))
        assert torch.equal(got[2], keys[0])
    else:
        kw = KERNEL_FORMS[form]
        table = sup if kw.get("sup") else clu.reshape(-1, 6)
        keys = BP.nearest_cluster_ref(
            o, d, m, table, mt if kw.get("max_t") else None,
            1 + kw.get("return_second", 0))
        assert torch.equal(got[0], BP.decode_cluster_key(keys[0],
                                                         table.shape[0]))
    assert all(g.dtype == torch.int32 and g.shape == (500,) for g in got)


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
