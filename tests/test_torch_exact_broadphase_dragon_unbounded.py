"""``nearest_cluster_kernel`` against the plain chain on the same card,
``torch.equal``, on dragon 1024x1024's primary and bounce-1 passes of one
sample of the default config: its closest rays, in the forms without a
segment bound.  On the CPU every case skips.
The file imports no JAX, so it runs on the card:
``python -m pytest --noconftest tests/test_torch_exact_broadphase_*.py``."""

import pytest

from torch_port_common import (card_scene_rays,
                               assert_kernel_equals_plain_chain_on_scene_rays,
                               UNBOUNDED_FORMS)


@pytest.fixture(scope="module")
def scene_rays():
    """scene -> (clu, sup, [primary rays, bounce-1 rays], tri, bvh) on the
    card."""
    return card_scene_rays()


@pytest.mark.parametrize("form", UNBOUNDED_FORMS)
@pytest.mark.parametrize("scene", ["dragon"])
def test_kernel_equals_plain_chain_on_scene_rays(scene_rays, scene, form,
                                                 monkeypatch):
    """Primary and bounce-1 rays: closest rays for the unbounded forms,
    shadow segments for the bounded ones and the pair."""
    assert_kernel_equals_plain_chain_on_scene_rays(scene_rays, scene, form,
                                                   monkeypatch)
