"""Model configurations: Wide & Deep (:mod:`repro_torch.configs.wide_deep`)
and the shapes it runs at (:mod:`repro_torch.configs.registry`)."""
