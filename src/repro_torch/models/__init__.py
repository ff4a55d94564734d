"""Models beside the RDF path: shared layers (:mod:`repro_torch.models.layers`),
Wide & Deep (:mod:`repro_torch.models.recsys`), the consumer of
:mod:`repro_torch.core.dedup_gather`, and the LM family
(:mod:`repro_torch.models.transformer` over ``attention``, ``moe`` and
``vocab_parallel``)."""
