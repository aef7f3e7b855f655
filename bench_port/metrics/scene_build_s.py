"""scene_build_s: the scene-load and build layers in set-up, in seconds:
the program's OBJ parse of the scene's models plus ``Renderer(scene,
cfg)`` (flatten, cluster build, table packing; host clock)."""


def read(record):
    return record["setup"]["scene_build_s"]
