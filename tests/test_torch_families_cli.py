"""The test and train CLIs with the other families (lavt, vlt), on the CPU.

Both packages' CLIs build the small model of test_torch_families.py
(embed 48, depths (1, 1, 2, 1), window 12, one BERT layer, 64²; f32)
through a patched `model_config_from_args`, and read test_torch_eval.py's
synthetic RefCOCO root (`refcoco_root`: REFER, COCO masks, JPEGs, a
vocab.txt).

  * `cli.test --model lavt` from a reference-format checkpoint written by
    the test, the two dicts {'model', 'bert_model'} (BERT's pooler in it,
    its position_ids not), against the JAX CLI (`lavt_rs_tpu.cli.test`,
    `convert_lavt_two_file`) on the same file; `--model vlt` from a
    one-dict file (`convert_vlt`).  mIoU and oIoU within 0.5 points (f32
    logits summed in another order may flip an argmax tie).  Both pass
    --max_tokens: without it the JAX CLI pads every sentence to zero
    tokens (ROADMAP.md watch list);
  * a lavt file without its 'bert_model' dict is refused, naming it;
  * `cli.train --model lavt --synthetic` for an epoch and a resume: its
    checkpoints hold the reference's two dicts, the resume restores them
    bitwise, and `cli.test --model lavt --resume <dir>` loads the newest.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import lavt_rs_tpu.cli.args as jcli_args
from lavt_rs_tpu.cli import test as jcli_test
from lavt_rs_tpu.config import SwinConfig as JSwinConfig
from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch.cli import args as cli_args
from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.train import checkpoint as ckpt_mod
from test_torch_eval import VOCAB, refcoco_root  # noqa: F401 (fixture)
from test_torch_families import SWIN, random_state_dict
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
HEAD_BIAS = {"lavt": "model.classifier.conv1_1.bias",
             "vlt": "classifier.decoding.classifier.bias"}
BERT = dict(num_layers=1, vocab_size=len(VOCAB) + 100)
IMG, TOKENS = 64, 8


@pytest.fixture
def small(monkeypatch):
    """Both packages' CLIs build the small model (the port's cli.train
    binds model_config_from_args at import, both test CLIs at call
    time)."""
    port_real, jax_real = (cli_args.model_config_from_args,
                           jcli_args.model_config_from_args)

    def port(args):
        cfg = port_real(args)
        return cfg.replace(swin=C.SwinConfig(**SWIN, drop_path_rate=0.0),
                           bert=dataclasses.replace(cfg.bert, **BERT))

    def jax(args):
        cfg = jax_real(args)
        return cfg.replace(swin=JSwinConfig(**SWIN, drop_path_rate=0.0),
                           bert=dataclasses.replace(cfg.bert, **BERT))

    monkeypatch.setattr(cli_args, "model_config_from_args", port)
    monkeypatch.setattr(cli_train, "model_config_from_args", port)
    monkeypatch.setattr(jcli_args, "model_config_from_args", jax)
    return port


def _argv(root, model):
    return ["--model", model, "--img_size", str(IMG), "--max_tokens",
            str(TOKENS), "--device", "cpu", "--no_bf16", "--refer_data_root",
            root, "--dataset", "refcoco", "--splitBy", "unc", "--split",
            "val", "--vocab", os.path.join(root, "vocab.txt")]


def _balance_classes(model, name):
    """Set the head's bias so that the two classes split a random image's
    pixels evenly (a random head prefers one class everywhere, and every
    IoU is then 0)."""
    rng = np.random.default_rng(4)
    with torch.no_grad():
        logits = model(torch.from_numpy(rng.standard_normal(
            (1, IMG, IMG, 3)).astype(np.float32)),
            torch.ones(1, TOKENS, dtype=torch.long),
            torch.ones(1, TOKENS, dtype=torch.long))
        model.get_parameter(HEAD_BIAS[name])[1] -= (
            logits[..., 1] - logits[..., 0]).median()


def _reference_file(model, name, path):
    """The reference's checkpoint of `model`: lavt's two dicts (BERT's
    pooler in, position_ids out, as a transformers BertModel saves), else
    one 'model' dict."""
    sd = model.state_dict()
    if name != "lavt":
        torch.save({"model": sd, "epoch": 3}, path)
        return
    bert = {k.removeprefix("bert_model."): v for k, v in sd.items()
            if k.startswith("bert_model.") and not k.endswith("position_ids")}
    bert["pooler.dense.weight"] = torch.zeros(768, 768)
    bert["pooler.dense.bias"] = torch.zeros(768)
    torch.save({"model": {k.removeprefix("model."): v for k, v in sd.items()
                          if k.startswith("model.")},
                "bert_model": bert, "epoch": 3}, path)


@pytest.mark.parametrize("name", ["lavt", "vlt"])
def test_cli_test_matches_the_jax_cli(name, refcoco_root, small,  # noqa: F811
                                      tmp_path, capsys):
    argv = _argv(refcoco_root, name)
    cfg = small(cli_test.get_parser().parse_args(argv))
    model = build_model(cfg, CPU)
    model.load_state_dict(random_state_dict(model, np.random.default_rng(3)))
    _balance_classes(model, name)
    path = str(tmp_path / f"{name}.pth")
    _reference_file(model, name, path)
    got = cli_test.main(argv + ["--checkpoint", path])
    capsys.readouterr()
    jcli_test.main(argv + ["--checkpoint", path])
    want = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and got["mIoU"] > 1.0, (got, want)
    for k in ("mIoU", "oIoU"):
        assert got[k] == pytest.approx(float(want[k]), abs=0.5), (k, got, want)


def test_cli_test_refuses_lavt_without_its_bert(refcoco_root, small,  # noqa: F811
                                                tmp_path):
    argv = _argv(refcoco_root, "lavt")
    model = build_model(small(cli_test.get_parser().parse_args(argv)), CPU)
    path = str(tmp_path / "one_dict.pth")
    torch.save({"model": {k.removeprefix("model."): v
                          for k, v in model.state_dict().items()
                          if k.startswith("model.")}}, path)
    with pytest.raises(ValueError, match="'bert_model'"):
        cli_test.main(argv + ["--checkpoint", path])


SYNTH = ["--synthetic", "--synthetic_steps", "2", "-b", "2", "--img_size",
         str(IMG), "--max_tokens", str(TOKENS), "--print-freq", "1",
         "--no_bf16", "--device", "cpu"]


def test_cli_train_lavt_saves_two_dicts_and_resumes(refcoco_root, small,  # noqa: F811
                                                    tmp_path, monkeypatch):
    restored = []
    real = ckpt_mod.restore_checkpoint

    def restore(path, model, opt, sched, device):
        out = real(path, model, opt, sched, device)
        saved = ckpt_mod.load_checkpoint(path, CPU)
        for part in ("model", "bert_model"):
            for k, v in getattr(model, part).state_dict().items():
                assert torch.equal(v, saved[part][k]), (part, k)
        restored.append(os.path.basename(path))
        return out

    monkeypatch.setattr(ckpt_mod, "restore_checkpoint", restore)
    out = str(tmp_path / "ck")
    argv = SYNTH + ["--model", "lavt", "--output-dir", out]
    cli_train.main(argv + ["--epochs", "1"])
    rec = cli_train.main(argv + ["--epochs", "2", "--resume", out])
    assert rec["start_epoch"] == 1 and restored == ["epoch_0000_lavt.pth"]
    saved = ckpt_mod.load_checkpoint(ckpt_mod.latest_checkpoint(out), CPU)
    assert set(saved) == {"model", "bert_model", "optimizer", "lr_scheduler",
                          "epoch", "args"}
    assert {k.split(".")[0] for k in saved["model"]} == {"backbone",
                                                         "classifier"}
    assert "embeddings.word_embeddings.weight" in saved["bert_model"]
    assert saved["lr_scheduler"]["last_epoch"] == 4

    summary = cli_test.main(_argv(refcoco_root, "lavt")
                            + ["--resume", out, "--max_items", "2"])
    assert 0.0 <= summary["mIoU"] <= 100.0
