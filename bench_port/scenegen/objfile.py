"""Write a model of :mod:`.models` as a Wavefront OBJ file and its MTL.

Positions and normals are written at ``%.9g``, so every float32 reads back
to the bit; triangles as ``v//vn`` with 1-based indices, one ``usemtl`` a
submesh; each material's Kd, Ks, Ke, Ns, Ni and d.  The benchmark writes
its scenes this way so that the program loads them through its own OBJ
loader, the scene-load layer a user's scene goes through.
"""

from __future__ import annotations

import os

__all__ = ["write_obj"]


def write_obj(model: dict, path: str) -> str:
    """Write ``model`` to ``path`` (``.obj``) and its materials beside it
    (same stem, ``.mtl``); returns ``path``.  A model's materials have
    distinct names."""
    stem = os.path.splitext(os.path.basename(path))[0]
    mtl_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                            f"{stem}.mtl")
    mats = {}
    for sub in model["submeshes"]:
        m = sub["material"]
        if mats.setdefault(m["name"], m) != m:
            raise ValueError(f"two materials named {m['name']!r}")
    with open(mtl_path, "w") as f:
        for name, m in mats.items():
            f.write(f"newmtl {name}\n"
                    f"Kd {' '.join(map(repr, m['base_color']))}\n"
                    f"Ks {' '.join(map(repr, m['specular']))}\n"
                    f"Ke {' '.join(map(repr, m['emission']))}\n"
                    f"Ns {m['specular_exponent']!r}\n"
                    f"Ni {m['refraction_index']!r}\n"
                    f"d {m['dissolve']!r}\n")
    lines = [f"mtllib {stem}.mtl"]
    lines += ["v %.9g %.9g %.9g" % tuple(p)
              for p in model["positions"].tolist()]
    lines += ["vn %.9g %.9g %.9g" % tuple(n)
              for n in model["normals"].tolist()]
    for sub in model["submeshes"]:
        lines.append(f"usemtl {sub['material']['name']}")
        lines += ["f %d//%d %d//%d %d//%d" % (a, a, b, b, c, c)
                  for a, b, c in (sub["tris"] + 1).tolist()]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
