"""Models beside the RDF path: shared layers (:mod:`repro_torch.models.layers`)
and Wide & Deep (:mod:`repro_torch.models.recsys`), the consumer of
:mod:`repro_torch.core.dedup_gather`."""
