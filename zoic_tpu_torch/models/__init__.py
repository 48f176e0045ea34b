"""Camera ray-generation models (raytraced and thin lens)."""

from . import common, raytraced, thinlens  # noqa: F401
