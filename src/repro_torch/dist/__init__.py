"""The distribution layer over ``torch.distributed`` (a process group or a
``DeviceMesh`` takes the place of the JAX package's mesh axes).

Submodules (imported by callers; this package import stays light):

* :mod:`.sharding`    — ``Policy`` and the JAX package's spec rules, carried
  onto DTensor placements of the LM's parameters, batches and caches.
* :mod:`.hints`       — scoped hints (``sharding_hints``) whose
  ``gather_params`` / ``act_seq`` call sites in ``models.model`` are the
  identity outside the context.
* :mod:`.local`       — attention and the decode cache's write on each
  rank's own rows and heads (kernel B10 takes plain tensors).
* :mod:`.compression` — int8 quantization, error feedback and the pod
  all-reduce.
* :mod:`.pipeline`    — GPipe over a mesh dim (sequential execution exactly,
  differentiable).
* :mod:`.forest`      — cell-partitioned sharded radix-tree forests, the
  port of the JAX package's ``dist/forest.py``.
"""
