"""Serialization: reading compiled-camera state files."""

from . import state  # noqa: F401
