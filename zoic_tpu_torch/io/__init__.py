"""Serialization: compiled-camera state files and the compile cache."""

from . import state  # noqa: F401
