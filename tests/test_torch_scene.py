"""The port's scene build (BVH spec, index and box tables, lights,
materials and camera) against the JAX package's, exactly, on the CPU: one
build of each scene by each package at the renderer's defaults
(``torch_port_common.scene_tables``).  The planes and shade rows, the round
trip and the refusals are in ``tests/test_torch_scene_planes.py``."""

import dataclasses

import numpy as np
import pytest

from torch_port_common import (few_torch_threads,  # noqa: F401
                               procedural_models, scene_tables)

SCENES = ["coatball", "teapot"]


@pytest.mark.parametrize("scene", SCENES)
def test_bvh_spec_identical(scene):
    _, jspec, _, tspec = scene_tables(scene)
    assert repr(tspec.bvh) == repr(jspec.bvh)
    assert dataclasses.asdict(tspec.bvh) == dataclasses.asdict(jspec.bvh)
    assert (tspec.light_count, tspec.material_count, tspec.has_env_map) == (
        jspec.light_count, jspec.material_count, jspec.has_env_map)


@pytest.mark.parametrize("scene", SCENES)
def test_index_and_box_tables_exact(scene):
    ja, _, ta, _ = scene_tables(scene)
    for key in ("tri_src", "geometry.material_id", "clu_counts", "node_lo",
                "node_hi", "sup_planes", "geometry.v0", "geometry.e1",
                "geometry.e2", "geometry.n0", "geometry.n1", "geometry.n2"):
        assert ta[key].dtype == ja[key].dtype, key
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)


@pytest.mark.parametrize("scene", SCENES)
def test_lights_materials_camera_exact(scene):
    ja, _, ta, _ = scene_tables(scene)
    keys = [k for k in ja if k.split(".")[0] in
            ("lights", "materials", "camera")]
    assert sorted(keys) == sorted(k for k in ta if k.split(".")[0] in
                                  ("lights", "materials", "camera"))
    for key in keys:
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
