"""Model configurations: the five LMs (``qwen2_5_3b``, ``gemma_2b``,
``mixtral_8x7b``, ``dbrx_132b``, ``command_r_plus_104b``), Wide & Deep
(:mod:`repro_torch.configs.wide_deep`) and the shapes they run at
(:mod:`repro_torch.configs.registry`)."""
