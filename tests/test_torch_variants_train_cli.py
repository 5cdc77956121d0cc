"""The train CLI under the fusion and decoder variants, on the CPU, on
test_torch_variants_cli.py's small model and test_torch_eval.py's
synthetic RefCOCO root.

  * `cli.train --efn --lazy_pred` and `--att_norm_layer_type BN`: an
    epoch on the split's train ref, a --resume for a second (the model
    restored bitwise), and `cli.test --resume` on its directory giving
    the in-train eval's summary;
  * `cli.train --model lavt_video --sep_seq_t_pwam` for a few synthetic
    steps: its checkpoint holds SepSeqTPWAM's convolutions.
"""

import os

import numpy as np
import pytest
import torch

from lavt_rs_tpu_torch.cli import test as cli_test
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.train import checkpoint as ckpt_mod
from test_torch_eval import refcoco_root  # noqa: F401 (fixture)
from test_torch_variants_cli import CPU, VARIANTS, _argv, small  # noqa: F401
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("flags", VARIANTS, ids=" ".join)
def test_cli_train_epoch_resume_and_test(flags, refcoco_root, small,  # noqa: F811
                                         tmp_path, monkeypatch):
    restored = []
    real = ckpt_mod.restore_checkpoint

    def restore(path, model, opt, sched, device):
        out = real(path, model, opt, sched, device)
        saved = ckpt_mod.load_checkpoint(path, CPU)["model"]
        for k, v in model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        restored.append(os.path.basename(path))
        return out

    monkeypatch.setattr(ckpt_mod, "restore_checkpoint", restore)
    out = str(tmp_path / "ck")
    data = _argv(refcoco_root) + flags
    train = data + ["-b", "1", "--val_split", "val", "--print-freq", "1",
                    "--output-dir", out]
    cli_train.main(train + ["--epochs", "1"])
    rec = cli_train.main(train + ["--epochs", "2", "--resume", out])
    assert rec["start_epoch"] == 1 and len(restored) == 1
    assert np.isfinite(rec["train_mIoU"])
    saved = ckpt_mod.load_checkpoint(ckpt_mod.latest_checkpoint(out), CPU)
    names = set(saved["model"])
    if "--efn" in flags:
        assert "backbone.layers.0.fusion.image_lang_att.W.0.weight" in names
        assert "classifier.conv1_2.weight" not in names
    else:
        assert ("backbone.layers.0.fusion.image_lang_att.f_query.1."
                "running_var") in names
    summary = cli_test.main(data + ["--resume", out])
    assert summary == rec["summary"]


def test_cli_train_video_sep_seq_t_pwam(tmp_path, small):
    out = str(tmp_path / "ck")
    rec = cli_train.main(["--synthetic", "--synthetic_steps", "2", "-b", "1",
                          "--img_size", "32", "--max_tokens", "6",
                          "--print-freq", "1", "--no_bf16", "--device",
                          "cpu", "--model", "lavt_video", "--num_frames", "2",
                          "--sep_seq_t_pwam", "--epochs", "1",
                          "--output-dir", out])
    assert np.isfinite(rec["train_mIoU"])
    saved = ckpt_mod.load_checkpoint(ckpt_mod.latest_checkpoint(out), CPU)
    assert "backbone.layers.0.fusion.f_query_t_q.0.weight" in saved["model"]
    assert "backbone.layers.3.fusion.spatial_vis_project_q.0.weight" in \
        saved["model"]

