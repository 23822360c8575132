"""Hand-written CUDA kernels (``csrc/``) for the card, each with a plain
PyTorch version (:mod:`repro_torch.kernels.ref`) for CPU tensors."""
