"""The hybrid 2D-Swin video model with the 2D PWAM (--ytvos_2d_swin_pwam)
against the JAX package's, on the CPU: the checks and sizes of
tests/test_torch_hybrid.py (its SepTPWAM case), in a file of their own so
that the two JAX builds run in parallel test workers."""

import pytest

from test_torch_hybrid import check_logits, check_train_step, hybrid_case
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def hybrid():
    return hybrid_case("pwam2d")


def test_hybrid_pwam2d_logit_parity(hybrid):
    check_logits(hybrid)


@pytest.mark.parametrize("use_checkpoint", [False, True],
                         ids=["plain", "checkpoint"])
def test_hybrid_pwam2d_train_step_matches_jax(hybrid, use_checkpoint):
    check_train_step(hybrid, use_checkpoint)
