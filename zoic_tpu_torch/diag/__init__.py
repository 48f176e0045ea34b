"""Diagnostics: ray tapes, draw.zoic dumps, diagrams, pupil comparisons.

Port of ``zoic_tpu/diag``, the counterpart of the reference's _DRAW debug
subsystem: the per-ray dump hooks become one batched tape trace on the
state's device, the Python2/PIL renderers become matplotlib (imported only
by the two functions that draw a PNG), and the dump format stays
byte-compatible, so artifacts interchange with the reference plugin and
the JAX package.
"""

from . import draw, dump, pupilplot, session, tape  # noqa: F401
