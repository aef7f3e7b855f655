"""render.mrays_per_s: closest and shadow rays traced (the renderer's own
counters) over the unprofiled window's wall time, in millions a second."""


def read(record):
    w = record["window"]
    rays = w["closest_rays"] + w["shadow_rays"]
    if not rays or w["wall_s"] <= 0:
        return None
    return rays / w["wall_s"] / 1e6
