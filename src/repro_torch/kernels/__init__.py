"""Hand-written CUDA kernels (``csrc/``) for the card, each with a plain
PyTorch version (:mod:`repro_torch.kernels.ref`) for CPU tensors:
``cdf_scan``, ``forest_delta`` (and ``forest_delta_update``),
``forest_sample`` (and ``forest_pack``, the layout it reads),
``forest_sample_batched`` (and
``forest_sample_batched_streams``), ``alias_build_batched``,
``alias_sample_batched``, ``sample_rows`` and ``flash_attention``."""
