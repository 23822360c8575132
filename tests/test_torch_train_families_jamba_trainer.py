"""Jamba's Trainer (one period) against JAX's Trainer, and resumed from
a JAX checkpoint killed at step 2, on the CPU at reduced widths in
float32: the two tests share one ``_trainer_runs``, so they stay in one
file. The checks themselves, their tolerances and helpers are in
``tests/_train_families_steps.py``, shared with the other files of the
split (``..._steps.py``, ``..._kimi.py``, ``..._jamba.py``).
"""
import pytest

import _train_families_steps as T

TRAINER_ARCHS = ["jamba_1_5_large_398b"]


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_matches_jax_trainer(arch, tmp_path_factory):
    T.check_trainer_matches_jax_trainer(arch, tmp_path_factory)


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_jax_checkpoint_resumes_in_port(arch, tmp_path_factory):
    T.check_jax_checkpoint_resumes_in_port(arch, tmp_path_factory)
