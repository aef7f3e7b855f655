"""The benchmark's frozen scene inputs: procedural models and their OBJ
form (:mod:`.models`, :mod:`.objfile`), environment maps and their
``.hdr`` form (:mod:`.envmap`)."""

from typing import Dict, Optional, Tuple

from .envmap import encode_hdr, make_env  # noqa: F401
from .models import MODELS, make_model  # noqa: F401
from .objfile import write_obj  # noqa: F401


def scene_inputs(config: dict) -> Tuple[Dict[str, dict], Optional[bytes]]:
    """The models a configuration's instances name, and the ``.hdr`` bytes
    of its environment map (None without an ``env_map`` entry)."""
    names = dict.fromkeys(i["model"] for i in config["instances"])
    models = {name: make_model(name) for name in names}
    env = config.get("env_map")
    if env is None:
        return models, None
    return models, encode_hdr(make_env(env["generator"], env["height"],
                                       env["width"]))
