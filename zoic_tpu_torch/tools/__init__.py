"""Measurement tools of the port, run as ``python -m zoic_tpu_torch.tools.NAME``."""
