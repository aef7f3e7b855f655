"""A ball of tinted glass, radius 0.6, standing on y = 0: a closed UV
sphere of 48 x 48 (4,512 triangles), Ni 1.5, d 0.1 (a tenth of the hits
shaded by its diffuse layer, the rest sent through or off it)."""

from bench_port.scenegen.models import from_parts, material, uv_sphere


def make() -> dict:
    pos, tris = uv_sphere(48, 48, 0.6)
    pos[:, 1] += 0.6
    glass = material("glass", base_color=(0.9, 0.95, 1.0),
                     specular=(1.0, 1.0, 1.0), specular_exponent=500.0,
                     refraction_index=1.5, dissolve=0.1)
    return from_parts([(glass, pos, tris)])
