"""The training step of BCAM and GACD against the JAX package's, on the
CPU, in f32: test_torch_fusion_variants_train.py's checks on its fixture
for these two kinds (the files split to stay under ~90 s each in the
tier-1 run's workers).
"""

from test_torch_fusion_variants_train import (  # noqa: F401 (collected here)
    batch_norm_statistics_match_jax, steps_fixture, test_block_gradients_match_jax,
    test_label_param_matches_jax, test_loss_matches_jax, variant_configs)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

steps = steps_fixture((("bcam", "IN"), ("gacd", "IN")), variant_configs)


def test_batch_norm_statistics_match_jax(steps):
    """The decoder's BatchNorms (the two kinds hold none)."""
    batch_norm_statistics_match_jax(steps)
    assert not any(".fusion." in n for n in steps["bn_counts"])
