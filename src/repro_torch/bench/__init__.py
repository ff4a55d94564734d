"""The paper's measurements on the card: Figures 5 and 6
(:mod:`repro_torch.bench.paper_figs`) and the §III.iv operation-count model
(:mod:`repro_torch.bench.op_model`); the probe behind the shard
session's serial gather (:mod:`repro_torch.bench.shard_gather`), and the
one behind training's tolerances across devices
(:mod:`repro_torch.bench.train_precision`)."""
