"""The wrappers of the exact broad phase (``nearest_cluster``,
``nearest_cluster_pair``, ``ops/broadphase_cuda.py``) refuse the tables
(dtype, shape, more than 4,096 boxes) and the ranks that
``nearest_cluster_kernel`` does not take, with ``ValueError``, on the CPU as
on the card.  The file imports no JAX."""

import pytest

from torch_port_common import assert_refused


@pytest.mark.parametrize("kind", [
    "table_float64", "table_shape", "table_4098_boxes", "return_second_3",
    "pair_ranks_1", "pair_ranks_4", "pair_4098_boxes"])
def test_wrappers_refuse_what_the_kernel_does_not_take(kind):
    assert_refused(kind)
