"""Data parallelism: the ray batch split over several devices."""

from . import sharding  # noqa: F401
