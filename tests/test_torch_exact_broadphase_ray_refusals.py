"""The wrappers of the exact broad phase (``nearest_cluster``,
``nearest_cluster_pair``, ``ops/broadphase_cuda.py``) refuse the ray
arguments (dtype, shape) that ``nearest_cluster_kernel`` does not take, with
``ValueError``, on the CPU as on the card.  The file imports no JAX."""

import pytest

from torch_port_common import assert_refused


@pytest.mark.parametrize("kind", [
    "o_float64", "d_shape", "mask_uint8", "max_t_float64", "max_t_shape",
    "pair_d_nb_shape", "pair_mask_nb_int"])
def test_wrappers_refuse_what_the_kernel_does_not_take(kind):
    assert_refused(kind)
