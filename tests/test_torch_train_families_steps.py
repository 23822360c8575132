"""Train steps and the Trainer's checkpoint tree of Llama 4, Whisper,
InternVL and xLSTM against the JAX package, and InternVL's Trainer against
JAX's Trainer and resumed from a JAX checkpoint, on the CPU at reduced
widths in float32. The checks themselves, their tolerances and helpers are in
``tests/_train_families_steps.py``, shared with the other files of the
split (``..._kimi.py``, ``..._jamba.py``, ``..._jamba_trainer.py``).
"""
import pytest

import _train_families_steps as T

ARCHS = ["llama4_maverick_400b_a17b", "whisper_small", "internvl2_76b", "xlstm_1_3b"]

TRAINER_ARCHS = ["internvl2_76b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    T.check_train_steps_match_jax(arch)


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_matches_jax_trainer(arch, tmp_path_factory):
    T.check_trainer_matches_jax_trainer(arch, tmp_path_factory)


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_jax_checkpoint_resumes_in_port(arch, tmp_path_factory):
    T.check_jax_checkpoint_resumes_in_port(arch, tmp_path_factory)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_tree_is_jax_layout(arch, tmp_path):
    T.check_trainer_tree_is_jax_layout(arch, tmp_path)
