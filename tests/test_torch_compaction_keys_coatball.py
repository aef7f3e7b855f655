"""The exact broad phase of the compaction sort keys against the JAX package on
coatball 64x48 (one JAX build carried to the port,
``torch_port_common.compaction_scene``): ``nearest_cluster`` in every return
form, and on the super boxes, against the JAX functions called eagerly, with
rays from numpy seeds: int32 keys and ids equal on every ray (the chain is
sub, mul, min, max: nothing a compiler may contract).  Dragon's are in
``tests/test_torch_compaction_keys_dragon.py``."""

import pytest

from torch_port_common import (JAX_FORMS,
                               assert_nearest_cluster_equals_reference,
                               assert_super_boxes_equal_reference,
                               compaction_scene,
                               few_torch_threads)  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    """scene -> (JAX data, JAX spec, port data, port spec)."""
    return {name: compaction_scene(name) for name in ("coatball",)}


@pytest.mark.parametrize("form", sorted(JAX_FORMS))
@pytest.mark.parametrize("scene", ["coatball"])
def test_nearest_cluster_equals_reference(scenes, scene, form):
    assert_nearest_cluster_equals_reference(scenes, scene, form)


@pytest.mark.parametrize("scene", ["coatball"])
def test_nearest_cluster_on_super_boxes_equals_reference(scenes, scene):
    """The last bounce's shadow fold passes the super boxes as clusters."""
    assert_super_boxes_equal_reference(scenes, scene)
