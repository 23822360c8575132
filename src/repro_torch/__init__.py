"""PyTorch/CUDA port of :mod:`repro` (radix tree forests for parallel
discrete sampling, Binder & Keller 2019).

Module paths mirror ``repro``. The package imports ``torch`` and numpy and
never ``jax`` or ``repro``: what it needs of the JAX package's pure-numpy
modules it keeps as its own copies (``robust.errors``, ``robust.validate``,
``core.alias``'s host builds, ``core.lds``, ``core.metrics``,
``models.config``, the config registry and ``data.pipeline``).

Layers on the card so far:

* one distribution: ``core.cdf.build_cdf`` -> ``core.forest.build_forest``
  -> ``core.sample.sample_forest`` and ``serve.sampler.ForestSampler``,
  on the kernels ``cdf_scan``, ``forest_delta`` and ``forest_sample``;
* the multi-tenant pool: ``pool.ForestPool`` (size-class arenas of
  stacked forests and packed alias tables, admission, updates,
  evictions, drains) and ``serve.sampler.PooledForestSampler`` with
  ``DeviceQmcStreams``, on the kernels ``forest_delta_update``,
  ``forest_sample_batched``, ``forest_sample_batched_streams``,
  ``alias_build_batched`` and ``alias_sample_batched`` (and the batched
  builds' ``cdf_scan`` and ``forest_delta``). ``interop`` restores a
  JAX pool or sampler snapshot into the port;
* model-backed serving: the LM of every family (``models``:
  ``init_params``, ``prefill``, ``decode_step`` over attention, Mamba,
  mLSTM and sLSTM blocks, dense and MoE MLPs, the Whisper encoder and the
  embedding frontend; ``configs`` holds the ten architectures),
  ``serve.sampler.TokenSampler`` and
  ``serve.engine.ServeEngine``, on the kernels ``cdf_scan`` (softmax
  mode) and ``sample_rows``; ``interop.params_from_jax`` and
  ``cache_from_jax`` carry JAX weights and caches across, and
  ``ServeEngine.restore`` takes a JAX engine snapshot;
* eval of every family and training of the dense LM: ``models.forward``
  and ``loss_fn``
  (``attn_impl="flash"`` on the kernel ``flash_attention``, forward only;
  ``"einsum"`` with gradients), ``train`` (AdamW over float32 masters,
  ``make_train_step`` with microbatches and remat, ``Trainer`` with
  checkpoint/resume and failure injection), ``data`` (``MixtureSampler``,
  whose corpus ids are drawn by ``cdf_scan``, ``forest_delta`` and
  ``forest_sample``, and ``make_batch``), ``ckpt`` (atomic ``save``,
  ``restore``, ``latest_step``, ``CheckpointManager``) and
  ``launch.train``; ``interop.params_to_jax`` and ``opt_state_from_jax``
  carry training state between the packages, and the ``Trainer``'s
  checkpoints are in JAX's layout (``models.layout``);
* the 2-D map path (``spatial.Map2DSampler``, ``serve.SpatialSampler``)
  and the paper's workloads (``core.counting``, ``core.forest2d``);
* the serving state and robustness layer: ``ckpt.save_state`` /
  ``load_state`` (the JAX package's format), ``robust.save_serving`` /
  ``load_serving``, ``robust.verify_pool`` and ``robust.faults.run_chaos``;
* ``dist.forest``: forests cell-partitioned over a ``torch.distributed``
  process group (nccl on the card, gloo on the CPU), and the sharded
  ``ForestSampler``, ``MixtureSampler`` and ``Map2DSampler``.

Device policy (see :mod:`repro_torch.device`):

* every public entry point takes ``device=`` and defaults to ``"cuda"``
  (``ForestPool(device=...)``, the samplers, the builds, ``restore``);
  without a card it raises unless the caller passes ``device="cpu"``;
* kernel wrappers dispatch on the tensor they are given: a CPU tensor goes
  to the plain PyTorch version, a CUDA tensor launches the hand-written
  kernel or raises. Nothing falls back from the card to the plain version.
"""
