"""The training step of the VLT families (vlt, lavt_vlt) against the JAX
package's, on the CPU, in f32: test_torch_train_families.py's checks (the
loss, the block gradients, the BatchNorm statistics, the parameter
groups) on its `steps` fixture for these two families, and what only the
VLT head has:

  * its BatchNorm1d (the sentence projection) refuses a batch of 1 in
    train mode, as the reference's nn.BatchNorm1d (flax's does not);
  * flax's fast variance, behind `STATS_TOL`;
  * under DDP `SyncBatchNorm1d` takes that BatchNorm1d.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.models.factory import build_model
from test_torch_train_families import (  # noqa: F401 (collected here too)
    _tiny, steps_fixture, test_batch_norm_statistics_match_jax,
    test_block_gradients_match_jax, test_label_param_matches_jax,
    test_loss_matches_jax)
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

steps = steps_fixture(("vlt", "lavt_vlt"))


def test_vlt_batch_norm_1d_refuses_a_batch_of_one():
    """The sentence projection's BatchNorm1d raises in train mode on one
    sample, as the reference's (train at bs >= 2 a process); eval mode
    takes it."""
    model = build_model(_tiny("vlt"), "cpu", torch.Generator().manual_seed(0),
                        train=True)
    img = torch.randn(1, 32, 32, 3)
    ids = torch.randint(1, 64, (1, 5))
    mask = torch.ones(1, 5, dtype=torch.long)
    with pytest.raises(ValueError, match="more than 1 value per channel"):
        model(img, ids, mask, generator=torch.Generator().manual_seed(1))
    model.eval()
    with torch.no_grad():
        assert model(img, ids, mask).shape == (1, 32, 32, 2)
    model.train()
    assert model(img.expand(2, -1, -1, -1), ids.expand(2, -1),
                 mask.expand(2, -1),
                 generator=torch.Generator().manual_seed(1)).shape == (
        2, 32, 32, 2)


def test_sentence_batch_norm_variance_form():
    """The known difference behind `STATS_TOL`: at a batch of 2 whose two
    values of a channel lie close (|x| ~ 1, spread ~ 2e-3), flax's
    train-mode BatchNorm (its fast variance E[x²] − E[x]² in f32) is off
    the exact f64 output by more than 1e-3 (6.4e-3 to 7.5e-3 measured),
    the port's BatchNorm1d (the reference's torch module, two-pass) by
    under 1e-4 (3.1e-5 to 3.3e-5: the f32 rounding of the mean against a
    spread of 1e-3)."""
    import flax.linen as fnn

    rng = np.random.default_rng(21)
    m = rng.uniform(0.5, 1.5, (1, 256))
    d = rng.uniform(1e-3, 3e-3, (1, 256))
    x = np.concatenate([m + d, m - d]).astype(np.float32)
    x64 = x.astype(np.float64)
    exact = (x64 - x64.mean(0)) / np.sqrt(x64.var(0) + 1e-5)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    flax_y, _ = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port_y = torch.nn.BatchNorm1d(256).train()(torch.from_numpy(x))
    assert np.abs(np.asarray(flax_y) - exact).max() > 1e-3
    assert np.abs(port_y.detach().numpy() - exact).max() < 1e-4


def test_sync_batch_norm_covers_vlts_batch_norm_1d(tmp_path):
    """Under DDP `convert_sync_bn` takes VLT's BatchNorm1d too (the
    reference's `convert_sync_batchnorm` converts every BatchNorm): in a
    one-process gloo group its train-mode output, gradients and running
    statistics equal nn.BatchNorm1d's."""
    import torch.distributed as dist

    from lavt_rs_tpu_torch.parallel.ddp import (SyncBatchNorm1d,
                                                SyncBatchNorm2d,
                                                convert_sync_bn)

    model = convert_sync_bn(build_model(_tiny("vlt"), "cpu", train=True))
    assert isinstance(model.classifier.lang_proj[1], SyncBatchNorm1d)
    assert isinstance(model.classifier.joint_threshold[0], SyncBatchNorm2d)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        ref = torch.nn.BatchNorm1d(6).train()
        sync = SyncBatchNorm1d(6).train()
        x = torch.randn(5, 6) * 3 + 1
        xs = x.clone().requires_grad_()
        xr = x.clone().requires_grad_()
        gy = torch.randn(5, 6)
        ys, yr = sync(xs), ref(xr)
        (ys * gy).sum().backward()
        (yr * gy).sum().backward()
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(ys, yr, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(xs.grad, xr.grad, rtol=1e-5, atol=1e-6)
    for a, b in ((sync.running_mean, ref.running_mean),
                 (sync.running_var, ref.running_var),
                 (sync.weight.grad, ref.weight.grad),
                 (sync.bias.grad, ref.bias.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
