"""Kimi K2 (MoE with the aux loss): train steps, microbatches against
one batch and against JAX's, the Trainer against JAX's Trainer and resumed
from a JAX checkpoint, and the checkpoint tree, on the CPU at reduced
widths in float32. The checks themselves, their tolerances and helpers are in
``tests/_train_families_steps.py``, shared with the other files of the
split (``..._steps.py``, ``..._jamba.py``, ``..._jamba_trainer.py``).
"""
import pytest

import _train_families_steps as T

ARCHS = ["kimi_k2_1t_a32b"]

TRAINER_ARCHS = ["kimi_k2_1t_a32b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    T.check_train_steps_match_jax(arch)


def test_microbatches_match_full_batch_moe(monkeypatch):
    T.check_microbatches_match_full_batch_moe(monkeypatch)


def test_microbatches_match_jax_moe():
    T.check_microbatches_match_jax_moe()


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_matches_jax_trainer(arch, tmp_path_factory):
    T.check_trainer_matches_jax_trainer(arch, tmp_path_factory)


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_jax_checkpoint_resumes_in_port(arch, tmp_path_factory):
    T.check_jax_checkpoint_resumes_in_port(arch, tmp_path_factory)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_tree_is_jax_layout(arch, tmp_path):
    T.check_trainer_tree_is_jax_layout(arch, tmp_path)
