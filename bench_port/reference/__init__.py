"""The plain reference the benchmark decides ``correct`` against: plain
PyTorch and numpy, nothing of the program (:mod:`.pathtrace`,
:mod:`.tracer`, :mod:`.scene`, :mod:`.sampling`)."""

from .pathtrace import render_pixels, tf32, trace_paths  # noqa: F401
from .scene import RefScene, build_scene  # noqa: F401
from .tracer import Binned, any_brute, closest_brute  # noqa: F401
