"""PyTorch/CUDA port of :mod:`repro` (radix tree forests for parallel
discrete sampling, Binder & Keller 2019).

Module paths mirror ``repro``. The package imports ``torch`` and numpy and
never ``jax`` or ``repro``: what it needs of the JAX package's pure-numpy
modules it keeps as its own copies.

Device policy (see :mod:`repro_torch.device`):

* every public entry point takes ``device=`` and defaults to ``"cuda"``;
  without a card it raises unless the caller passes ``device="cpu"``;
* kernel wrappers dispatch on the tensor they are given: a CPU tensor goes
  to the plain PyTorch version, a CUDA tensor launches the hand-written
  kernel or raises. Nothing falls back from the card to the plain version.
"""
