"""The port's head-batching probe against the JAX tool's Pallas kernels, on
the CPU.

`tools/probe_headbatch.py` is loaded from its file (it is a script, not a
module of the package) and its `loop_kernel` (P1) and `batch_kernel` (P2)
run through `pl.pallas_call` in `pltpu.force_tpu_interpret_mode()` with the
tool's own block specs and scratch, at the tool's window geometry (ch 3,
4 heads, n 144, hd 32) on a small grid.  The port's plain version
(`probe_attention_plain`, which both CUDA wrappers take on a CPU tensor)
must agree with each on the tool's input (std 0.1) and on the check input
(std `CHECK_STD`, where the softmax is far from uniform) within
`CHECK_ATOL` abs + `CHECK_RTOL` rel (bf16 outputs, p rounded to bf16
before p v).  A kernel that wrote each window's mean, or x itself, fails
that check on the check input.
"""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lavt_rs_tpu_torch.tools import probe_headbatch as probe

CH, HEADS, N, HD, GRID = 3, 4, 144, 32, 2


@pytest.fixture(scope="module")
def jax_tool():
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_headbatch.py"
    spec = importlib.util.spec_from_file_location("jax_probe_headbatch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def x():
    return probe.probe_input(GRID, CH, HEADS, N, HD)


def _window_mean(x, n=N):
    """What a kernel that skipped the scores and the exp would write."""
    rows, cq = x.shape
    xs = x.float().view(rows // n, n, cq)
    return xs.mean(1, keepdim=True).expand(-1, n, -1).reshape(rows, cq)


def _pallas(jax_tool, x, batch: bool):
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    blk = pl.BlockSpec((CH * N, HEADS * HD), lambda i: (i, 0))
    kernel = jax_tool.batch_kernel if batch else jax_tool.loop_kernel
    extra = ({"scratch_shapes": [pltpu.VMEM((HEADS * CH, N, HD),
                                            jnp.bfloat16)]}
             if batch else {})
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            functools.partial(kernel, heads=HEADS, n=N, hd=HD), grid=(GRID,),
            in_specs=[blk], out_specs=blk,
            out_shape=jax.ShapeDtypeStruct(xj.shape, xj.dtype), **extra)
        return np.asarray(call(xj), np.float32)


@pytest.mark.parametrize("std", [0.1, probe.CHECK_STD],
                         ids=["tool_input", "check_input"])
@pytest.mark.parametrize("batch", [False, True], ids=["P1_loop", "P2_batch"])
def test_plain_version_matches_the_pallas_kernel(jax_tool, batch, std):
    x = probe.probe_input(GRID, CH, HEADS, N, HD, std=std)
    want = _pallas(jax_tool, x, batch)
    got = probe.probe_attention_plain(x, HEADS, N, HD).float().numpy()
    assert got.shape == want.shape == (GRID * CH * N, HEADS * HD)
    np.testing.assert_allclose(got, want, atol=probe.CHECK_ATOL,
                               rtol=probe.CHECK_RTOL)


def test_check_rejects_a_kernel_that_skips_the_scores(x):
    """On the tool's input the window mean passes atol 1e-2 (the softmax
    is nearly uniform); on the check input it and a copy of x fail the
    kernel check, while the plain version passes it."""
    want = probe.probe_attention_plain(x, HEADS, N, HD).float()
    assert (_window_mean(x) - want).abs().max().item() <= 1e-2
    xc = probe.probe_input(GRID, CH, HEADS, N, HD, std=probe.CHECK_STD)
    want = probe.probe_attention_plain(xc, HEADS, N, HD)
    assert probe.mismatch(want, want) == 0.0
    assert probe.mismatch(_window_mean(xc), want) > 50
    assert probe.mismatch(xc, want) > 50


def test_wrappers_take_the_plain_version_on_the_cpu(x):
    want = probe.probe_attention_plain(x, HEADS, N, HD)
    before = (probe.loop_attention.launches, probe.batch_attention.launches)
    torch.testing.assert_close(probe.loop_attention(x, CH, HEADS, N), want,
                               rtol=0, atol=0)
    torch.testing.assert_close(probe.batch_attention(x, CH, HEADS, N), want,
                               rtol=0, atol=0)
    # a CPU call launches nothing, so it counts nothing
    assert (probe.loop_attention.launches,
            probe.batch_attention.launches) == before


def test_probe_input_is_the_jax_tools(x):
    rng = np.random.default_rng(0)
    want = jnp.asarray(rng.standard_normal((GRID * CH * N, HEADS * HD)) * 0.1,
                       jnp.bfloat16)
    np.testing.assert_allclose(x.float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=0)


def test_tool_runs_on_the_cpu(capsys):
    assert probe.main(["--device", "cpu", "--grid", "2", "--rounds", "1"]) == 0
    out = capsys.readouterr().out
    assert "loop :" in out and "batch:" in out


def test_tool_needs_the_card_by_default(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["--grid", "1", "--rounds", "1"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err


def test_tool_and_new_modules_run_without_jax():
    """The probe, the torch-chain attention and the routing predicates
    import and run with JAX and the JAX package blocked."""
    code = """
import sys
for name in ("jax", "jaxlib", "flax", "lavt_rs_tpu"):
    sys.modules[name] = None
from lavt_rs_tpu_torch.ops import attention, fused_msa, window_attn
from lavt_rs_tpu_torch.tools import probe_headbatch
assert window_attn.attn_fwd_supported(324, 49, 4, 32)
assert not fused_msa.fused_msa_routed(324, 49, 128, 4)
sys.exit(probe_headbatch.main(["--device", "cpu", "--grid", "1",
                                "--rounds", "1"]))
"""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "loop :" in proc.stdout


@pytest.mark.parametrize("grid,ch,heads,n,split", [
    (96, 3, 4, 144, 2),    # the tool's defaults on 132 SMs
    (4, 3, 4, 144, 12),    # few row blocks: one slot a block
    (400, 3, 4, 144, 1),   # the row blocks alone fill the card
    (8, 2, 3, 192, 6),
    (200, 8, 4, 192, 2)])  # 32 slots of 192 rows do not fit one block
def test_p2_launch_plan(grid, ch, heads, n, split):
    """P2's plan, with no card: the split divides the row block's slots,
    the staged slots fit a block's shared memory, and the blocks fit the
    card in one wave unless the row blocks alone exceed it."""
    plan = probe.batch_plan(grid, ch, heads, n, 132)
    assert plan["split"] == split and (ch * heads) % split == 0
    assert plan["slots_per_block"] == ch * heads // split
    assert plan["blocks"] == grid * split
    assert plan["smem"] == 1024 + plan["slots_per_block"] * (n * 64 + 8)
    assert plan["smem"] <= probe.SMEM_PER_BLOCK
    assert plan["waves"] <= 1 or split == 1 or grid * split > 264


@pytest.mark.parametrize("grid,ch,heads,n,split", [
    (96, 3, 4, 144, 2),    # the tool's defaults on 132 SMs
    (4, 3, 4, 144, 4),     # few row blocks: one head a block
    (400, 3, 4, 144, 1),   # the row blocks alone fill the card
    (8, 2, 3, 192, 3),
    (200, 8, 4, 192, 2)])  # 32 slots of 192 rows do not fit one block
def test_p1_launch_plan(grid, ch, heads, n, split):
    """P1's plan, with no card: the split divides the heads (a head's
    windows stay in one block, which works its heads in order), the staged
    slots fit a block's shared memory, and the blocks fit the card in one
    wave unless the row blocks alone exceed it."""
    plan = probe.loop_plan(grid, ch, heads, n, 132)
    assert plan["split"] == split and heads % split == 0
    assert plan["slots_per_block"] == ch * heads // split
    assert plan["blocks"] == grid * split
    assert plan["smem"] == 1024 + plan["slots_per_block"] * (n * 64 + 8)
    assert plan["smem"] <= probe.SMEM_PER_BLOCK
    assert plan["waves"] <= 1 or split == 1 or grid * split > 264
