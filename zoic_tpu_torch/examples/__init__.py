"""Runnable examples of the port, the counterparts of the repository's
``examples/``: :mod:`.render_demo` (a lens's vignetting, ray diagram and
exit-pupil comparison through ``Camera``, ``render`` and ``diag``) and
:mod:`.lens_optimization` (a lens refocused by gradient descent through
the eager trace).  Each runs with ``python -m`` and on the card unless
``--device cpu`` is given.
"""
