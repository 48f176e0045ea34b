"""Camera ray-generation models (raytraced)."""

from . import common, raytraced  # noqa: F401
