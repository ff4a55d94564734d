"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
:mod:`repro_torch.examples.recsys_dedup` trains Wide & Deep with and
without ``dedup_gather``; :mod:`repro_torch.examples.serve_lm` serves an LM
(prefill and batched decode with a KV cache); :mod:`repro_torch.examples.train_lm`
trains a qwen-family LM until its loss falls."""
