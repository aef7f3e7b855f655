"""The benchmark's frozen scene inputs: procedural models and their OBJ
form (:mod:`.models`, :mod:`.objfile`)."""

from .models import MODELS, make_model  # noqa: F401
from .objfile import write_obj  # noqa: F401
