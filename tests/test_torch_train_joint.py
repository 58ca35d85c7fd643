"""The ensemble's ('genconvit') train step against the JAX package's, as
tests/test_torch_train.py holds 'ed' and 'vae' (its docstring states the
comparisons and tolerances): float32 with the KL term, bfloat16 without."""

import pytest

from tests.test_torch_train import JOINT_CASES, check_step, setup  # noqa: F401 (fixture)


@pytest.mark.parametrize("net,dtype,use_kl", JOINT_CASES)
def test_joint_train_step_matches_jax(setup, net, dtype, use_kl):  # noqa: F811
    check_step(setup, net, dtype, use_kl)
