"""``nearest_cluster_kernel`` against the plain chain on the same card,
``torch.equal``, in the forms without a segment bound, on 200,003
adversarial rays (axis-parallel and near-zero direction components,
``-0.0``, origins inside, on the faces and at the corners of boxes, masked
rays, segment lengths 0, -0.0, 1e30 and inf) against a synthetic table
(overlapping, flat, point and padding boxes).  On the CPU every case skips.
The file imports no JAX, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_exact_broadphase_*.py``."""

import pytest

from torch_port_common import (
    card_scene_rays, assert_kernel_equals_plain_chain_on_adversarial_rays,
    UNBOUNDED_FORMS)


@pytest.fixture(scope="module")
def scene_rays():
    """scene -> (clu, sup, [primary rays, bounce-1 rays], tri, bvh) on the
    card."""
    return card_scene_rays()


@pytest.mark.parametrize("form", UNBOUNDED_FORMS)
@pytest.mark.parametrize("table", ["synthetic"])
def test_kernel_equals_plain_chain_on_adversarial_rays(scene_rays, table,
                                                       form, monkeypatch):
    assert_kernel_equals_plain_chain_on_adversarial_rays(scene_rays, table,
                                                         form, monkeypatch)
