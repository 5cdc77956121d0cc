"""The softmax forms of the port's inference MSA kernels past a logit of 80,
on the CPU, against the JAX package.

The JAX inference kernels (K1, K2, K11 and K2p, `_fwd_call` at its default
`exact=False`) take the shift-free exp(min(s, 80)) (`_softmax_exp` of
lavt_rs_tpu/ops/pallas/fused_msa.py), a TPU speed measure that equals the
exact softmax while every logit stays below 80.  The port takes the clamp
form only in K1 f32, K2 f32 and K11 f32 at inference; K2p f32 runs K10 f32's
max-subtracted softmax and every bf16 MSA kernel the exact one
(`fused_msa.softmax_form`).  With a bias table of std 60 the logits pass 80:

* K2p's plain version (`fused_window_msa_grouped_plain`, what K2p f32 and
  the bf16 K2p are held to on the card) is the exact K2 plain version,
  bit for bit, and more than 1e-2 from JAX's `fused_window_msa` on its
  Pallas kernel in interpret mode, which equals the clamp form within
  2e-4 abs + rel (the port's K2p tests' tolerance against Pallas);
* `softmax_form` gives bf16 the exact form at `exact=False` and f32 the
  clamp form.

The kernels themselves are held to their exact plain versions past 80 on
the card in tests/test_torch_attn_tf32_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu.ops.pallas import fused_msa as jfused
from lavt_rs_tpu_torch.ops import fused_msa
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

HEADS, C, N = 2, 64, 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_k2p_plain_is_exact_past_80_where_jax_clamps():
    rng = np.random.default_rng(80)
    nw = 3
    x = rng.standard_normal((1, nw, N, C)).astype(np.float32)
    w = [(rng.standard_normal(s) * sd).astype(np.float32)
         for s, sd in (((3 * C, C), C ** -0.5), ((3 * C,), 0.2),
                       ((C, C), C ** -0.5), ((C,), 0.2))]
    bias = (rng.standard_normal((HEADS, N, N)) * 60.0).astype(np.float32)
    scale = 32 ** -0.5
    tw = [_t(a) for a in w]
    args = (_t(x), *tw, _t(bias), None)
    got = fused_msa.fused_window_msa_grouped_plain(*args, nw, HEADS, scale)
    exact = fused_msa.fused_window_msa_plain(*args, HEADS, scale)
    clamp = fused_msa.fused_window_msa_plain(*args, HEADS, scale, exact=False)
    assert torch.equal(got, exact)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfused.fused_window_msa(
            jnp.asarray(x), jnp.asarray(w[0].T), jnp.asarray(w[1]),
            jnp.asarray(w[2].T), jnp.asarray(w[3]), jnp.asarray(bias), None,
            HEADS, scale))
    assert np.abs(got.numpy() - want).max() > 1e-2
    np.testing.assert_allclose(clamp.numpy(), want, rtol=2e-4, atol=2e-4)


def test_softmax_form_is_exact_for_bf16():
    bf16, f32 = torch.zeros(1, dtype=torch.bfloat16), torch.zeros(1)
    assert fused_msa.softmax_form(bf16, False) is True
    assert fused_msa.softmax_form(bf16, True) is True
    assert fused_msa.softmax_form(f32, False) is False
    assert fused_msa.softmax_form(f32, True) is True
