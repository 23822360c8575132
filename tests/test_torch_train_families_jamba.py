"""Jamba (one period: attention, Mamba and MoE blocks): train steps
and the Trainer's checkpoint tree against the JAX package, on the CPU at
reduced widths in float32. The checks themselves, their tolerances and helpers are in
``tests/_train_families_steps.py``, shared with the other files of the
split (``..._steps.py``, ``..._kimi.py``, ``..._jamba_trainer.py``).
"""
import pytest

import _train_families_steps as T

ARCHS = ["jamba_1_5_large_398b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    T.check_train_steps_match_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_tree_is_jax_layout(arch, tmp_path):
    T.check_trainer_tree_is_jax_layout(arch, tmp_path)
