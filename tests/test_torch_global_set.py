"""The global set's plain versions (``global_seed_keys``, the closest
passes' seed, and ``global_any_hit``) against the JAX package's, bit for
bit, on the CPU: coatball at 64x48, the primary and bounce-1 passes recorded
from the port's renderer (``torch_port_common.coatball_passes``), one JAX
build carried across.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_raytracing_tpu.ops import trace_pallas as TP
from metal_raytracing_tpu_torch.ops import trace_cuda as TC
from torch_port_common import coatball_passes, few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def setup():
    """(JAX data, JAX spec, port data, port spec, recorded passes)."""
    setup = coatball_passes()
    tspec = setup[3]
    assert TC._use_flat(tspec.bvh) and tspec.bvh.num_global > 0
    return setup


def _j(x):
    return jnp.asarray(x.numpy())


@pytest.mark.parametrize("bounce", [0, 1])
def test_global_seed_keys_exact(setup, bounce):
    jdata, jspec, tdata, tspec, calls = setup
    o, d, m, seed = calls["closest"][bounce]
    ref = np.asarray(TP.global_seed_keys(_j(o), _j(d), _j(m),
                                         jdata.tri_planes, jspec.bvh))
    np.testing.assert_array_equal(seed.numpy(), ref)
    got = TC.global_seed_keys(o, d, m, tdata.tri_planes, tspec.bvh)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bounce", [0, 1])
def test_global_any_hit_exact(setup, bounce):
    jdata, jspec, tdata, tspec, calls = setup
    o, d, mt, _ = calls["any"][bounce]
    # the shadow pass's pre-fold mask is not recorded: test every lane, on
    # the shadow segments and on the same segments reversed (toward the
    # floor, which is in the global set)
    m = torch.ones(o.shape[0], dtype=torch.bool)
    hits = 0
    for dd in (d, -d):
        ref = np.asarray(TP.global_any_hit(_j(o), _j(dd), _j(mt), _j(m),
                                           jdata.tri_planes, jspec.bvh))
        got = TC.global_any_hit(o, dd, mt, m, tdata.tri_planes, tspec.bvh)
        np.testing.assert_array_equal(got.numpy(), ref)
        hits += int(ref.sum())
    assert hits > 0
