"""Sharded forests over ``torch.distributed``: :mod:`.forest`, the port of
the JAX package's ``dist/forest.py`` (the process group takes the place of
the mesh axis)."""
