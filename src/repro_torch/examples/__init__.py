"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
:mod:`repro_torch.examples.recsys_dedup` trains Wide & Deep with and
without ``dedup_gather``."""
