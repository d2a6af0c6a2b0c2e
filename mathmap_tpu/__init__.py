"""mathmap_tpu — an image-transform engine on JAX with the capabilities of
MathMap (firstBusiness/mathmap).

See SURVEY.md for the reference analysis (note its §0 provenance warning) and
README.md for the architecture. Quick start:

    import mathmap_tpu as mm
    f = mm.compile("grayColor(gray(origVal(xy)))")
    out = f.render(image)            # fused XLA program on the GPU
    ref = f.render(image, interpret=True)   # NumPy oracle
"""

import os as _os
import sys as _sys

# Deep machine-generated expressions recurse through the parser and tracer;
# give Python headroom and let utils.errors report a clean failure instead
# of a bare RecursionError.
_sys.setrecursionlimit(max(_sys.getrecursionlimit(), 20000))


def compile_cache_dir(environ=_os.environ):
    """Where this process keeps JAX's persistent compilation cache (the
    analog of the reference's compiled-filter cache surviving across
    runs — cgen.c caches generated .so files): None when
    JAX_COMPILATION_CACHE_DIR is set, since JAX then reads that variable
    itself; otherwise a fixed directory inside the checkout, so every run
    from the same checkout finds what earlier runs compiled."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", _cache_dir)

from . import ops as _ops  # noqa: F401  — populate the builtin registry
from .api import Filter, compile_file, compile_source, shared
from .expression_db import ExpressionDB, default_db
from .imgio.images import read_image, to_float_rgba, to_uint8, write_image
from .runtime.options import RenderOptions
from .runtime.value import Curve, Gradient, InputImage
from .utils.errors import MMError, MMNameError, MMRuntimeError, MMSyntaxError, MMTypeError

compile = compile_source  # noqa: A001 — mirrors the reference's compile_mathmap()

__version__ = "0.1.0"

__all__ = [
    "Filter",
    "shared",
    "ExpressionDB",
    "default_db",
    "compile",
    "compile_source",
    "compile_file",
    "read_image",
    "write_image",
    "to_float_rgba",
    "to_uint8",
    "RenderOptions",
    "Curve",
    "Gradient",
    "InputImage",
    "MMError",
    "MMSyntaxError",
    "MMTypeError",
    "MMNameError",
    "MMRuntimeError",
    "__version__",
]
