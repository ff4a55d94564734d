"""The training substrate: AdamW (:mod:`repro_torch.train.optimizer`), the
train-step factory (:mod:`repro_torch.train.trainer`), int8 gradient
compression with error feedback (:mod:`repro_torch.train.compression`),
checkpoints in the JAX package's on-disk format
(:mod:`repro_torch.train.checkpoint`) and the retry and straggler policies
(:mod:`repro_torch.train.fault`).

Parameters, gradients and optimizer moments are pytrees of tensors (dicts,
tuples, NamedTuples), flattened in JAX's leaf order
(:mod:`repro_torch.train.tree`) so that a leaf's place, and a checkpoint,
mean the same in both packages.
"""
