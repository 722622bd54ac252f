"""Host-side data layer (counterpart of instaorder_tpu/data): the RLE
codec, the annotation readers, an image reader that needs no PIL for
PNG, and the synthetic fixtures.

Importing the package loads the native C++ RLE codec (building it on
first use), as the JAX package does; when it cannot be built the numpy
codec stays in use and `native.LOAD_ERROR` says why.
"""

from . import rle
from .. import native as _native

_native.load(build_if_missing=True)
