"""The test and train CLIs under the fusion and decoder variants, on the
CPU.

Both packages' CLIs build the small model of test_torch_fusion_variants.py
(embed 48, depths (1, 1, 2, 1), window 12, one BERT layer, 64²; f32)
through a patched `model_config_from_args`, and read test_torch_eval.py's
synthetic RefCOCO root (`refcoco_root`).

  * `cli.test --efn --lazy_pred` and `cli.test --att_norm_layer_type BN`
    against the JAX CLI on the same weights: JAX variables drawn from a
    seeded numpy generator, saved as the JAX CLI's own checkpoint (its
    converter from a reference .pth maps neither EFN nor the BN att_norm)
    and, through `from_jax`, as the reference-format .pth the port's CLI
    reads.  mIoU and oIoU within 0.5 points (an f32 argmax tie may flip);
    both pass --max_tokens (ROADMAP.md watch list);
  * `cli.test` takes every fusion flag it once refused (--bcam, --gacd,
    --efn, --fuse simple) on the synthetic refs.
`cli.train` under the variants: tests/test_torch_variants_train_cli.py;
the weight-import flags: tests/test_torch_variants_pretrained.py.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lavt_rs_tpu.cli.args as jcli_args
from lavt_rs_tpu.cli import test as jcli_test
from lavt_rs_tpu.config import SwinConfig as JSwinConfig
from lavt_rs_tpu.models.factory import build_model as jbuild_model
from lavt_rs_tpu.train.checkpoint import save_checkpoint as jsave_checkpoint
from lavt_rs_tpu.train.optim import TrainConfig as JTrainConfig
from lavt_rs_tpu.train.step import create_train_state as jcreate_train_state
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.cli import args as cli_args
from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.convert.from_jax import state_dict_from_jax
from lavt_rs_tpu_torch.models.factory import build_model
from test_torch_eval import VOCAB, refcoco_root  # noqa: F401 (fixture)
from test_torch_model import SWIN, random_variables
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
BERT = dict(num_layers=1, vocab_size=len(VOCAB) + 100)
IMG, TOKENS = 64, 8
VARIANTS = (["--efn", "--lazy_pred"], ["--att_norm_layer_type", "BN"])


@pytest.fixture
def small(monkeypatch):
    """Both packages' CLIs build the small model (the port's cli.train
    binds model_config_from_args at import, both test CLIs at call
    time); returns (port config, JAX config) of parsed args."""
    port_real, jax_real = (cli_args.model_config_from_args,
                           jcli_args.model_config_from_args)

    def port(args):
        cfg = port_real(args)
        return cfg.replace(swin=C.SwinConfig(**SWIN, drop_path_rate=0.0),
                           bert=dataclasses.replace(cfg.bert, **BERT))

    def jax_config(args):
        cfg = jax_real(args)
        return cfg.replace(swin=JSwinConfig(**SWIN, drop_path_rate=0.0),
                           bert=dataclasses.replace(cfg.bert, **BERT))

    monkeypatch.setattr(cli_args, "model_config_from_args", port)
    monkeypatch.setattr(cli_train, "model_config_from_args", port)
    monkeypatch.setattr(jcli_args, "model_config_from_args", jax_config)
    return port, jax_config


def _argv(root):
    return ["--img_size", str(IMG), "--max_tokens", str(TOKENS), "--device",
            "cpu", "--no_bf16", "--refer_data_root", root, "--dataset",
            "refcoco", "--splitBy", "unc", "--split", "val", "--vocab",
            os.path.join(root, "vocab.txt")]


def _balanced_variables(jm, cfg):
    """Seeded JAX variables whose head bias splits a random image's pixels
    evenly between the classes (a random head prefers one class, and every
    IoU is then 0)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)),
        jnp.ones((1, TOKENS), jnp.int32), jnp.ones((1, TOKENS), jnp.int32)))
    variables = random_variables({k: shapes[k] for k in ("params",
                                                         "batch_stats")},
                                 np.random.default_rng(3))
    pm = build_model(cfg, CPU)
    pm.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        logits = pm(torch.from_numpy(rng.standard_normal(
            (1, IMG, IMG, 3)).astype(np.float32)),
            torch.ones(1, TOKENS, dtype=torch.long),
            torch.ones(1, TOKENS, dtype=torch.long))
    head = variables["params"]["classifier"]["head"]["bias"]
    head[1] -= float((logits[..., 1] - logits[..., 0]).median())
    return variables


@pytest.mark.parametrize("flags", VARIANTS, ids=" ".join)
def test_cli_test_matches_the_jax_cli(flags, refcoco_root, small,  # noqa: F811
                                      tmp_path, capsys):
    port_config, jax_config = small
    argv = _argv(refcoco_root) + flags
    cfg = port_config(cli_test.get_parser().parse_args(argv))
    jcfg = jax_config(jcli_test.get_parser().parse_args(argv))
    jm = jbuild_model(jcfg)
    variables = _balanced_variables(jm, cfg)
    state, _ = jcreate_train_state(jm, variables, JTrainConfig())
    jpath = jsave_checkpoint(str(tmp_path / "jax"), 0, state)
    path = str(tmp_path / "variant.pth")
    torch.save({"model": state_dict_from_jax(variables, cfg), "epoch": 0},
               path)
    got = cli_test.main(argv + ["--checkpoint", path])
    capsys.readouterr()
    jcli_test.main(argv + ["--checkpoint", jpath])
    want = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["mIoU"] > 1.0, (got, want)
    for k in ("mIoU", "oIoU"):
        assert got[k] == pytest.approx(float(want[k]), abs=0.5), (k, got, want)


@pytest.mark.parametrize("flag", [["--bcam"], ["--gacd"], ["--efn"],
                                  ["--fuse", "simple"]], ids=" ".join)
def test_cli_test_takes_the_fusion_flags(flag, small):
    """cli.test once refused these (ROADMAP.md item 3): each builds its
    fusion and evaluates the synthetic refs."""
    summary = cli_test.main(["--synthetic", "--device", "cpu", "--no_bf16",
                             "--img_size", str(IMG), "--max_items", "2"]
                            + flag)
    assert 0.0 <= summary["mIoU"] <= 100.0
