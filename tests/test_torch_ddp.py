"""The port's data parallelism (`parallel/ddp.py`, the DDP train step, the
rank-sharded loader, the synchronized meters, the train CLI in a process
group) on the CPU under gloo, at world 2.

Two processes start once for the file (`torch.multiprocessing.spawn`,
a `file://` rendezvous in a temporary directory, a finite group timeout
and a limit on the join, so a hung collective fails the file instead of
running out the suite's clock) and run every case that needs a group:
  (a) `SyncBatchNorm2d` against nn.BatchNorm2d on the joint batch: the
      output, dx, dweight and dbias (the ranks' sum, as DDP reduces them),
      the running statistics and `num_batches_tracked`, within 1e-5;
  (b) two DDP train steps of the small lavt_one of
      test_full_model_parity.py (embed 48, depths (1, 1, 2, 1), window 7,
      64², one BERT layer, drop path and dropout 0, f32, plain versions),
      bs 2 a rank, with and without --use_checkpoint, against the
      one-process step on the joint bs-4 batch: each step's loss (1e-5
      relative), every gradient (‖got − want‖ ≤ 1e-4 ‖want‖ + 1e-6 G √n,
      G the largest gradient), the decoder BatchNorms' running statistics
      (1e-5) and the parameters after the two AdamW steps (f32 sums in
      another order: 1e-5 relative, and 2 lr absolute for the parameters
      whose gradient is f32 noise around 0, where AdamW's first steps
      move by ±lr whichever the noise's sign);
  (d) `SmoothedValue.synchronize_between_processes` sums count and total;
  (f) `cli.train.main` in that group (--synthetic, the shrunk config of
      test_torch_train_cli.py): only rank 0 writes a checkpoint, with no
      `module.` key, and a one-process --resume of it runs.
Without a group: (c) the loader's shards and (e) the step generators.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn as nn

from lavt_rs_tpu_torch import config as C
from lavt_rs_tpu_torch import losses
from lavt_rs_tpu_torch.cli import args as cli_args
from lavt_rs_tpu_torch.cli import train as cli_train
from lavt_rs_tpu_torch.data.loader import PrefetchLoader
from lavt_rs_tpu_torch.models.factory import build_model
from lavt_rs_tpu_torch.parallel import ddp
from lavt_rs_tpu_torch.train.optim import TrainConfig
from lavt_rs_tpu_torch.train.step import create_train_state, make_train_step
from lavt_rs_tpu_torch.utils.logging import MetricLogger, SmoothedValue
from torch_threads import torch_threads  # noqa: F401 (autouse fixture)

WORLD, B, STEPS = 2, 2, 2
JOIN_LIMIT_S = 300
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
CFG = C.ModelConfig(
    swin=C.SwinConfig(embed_dim=48, depths=(1, 1, 2, 1),
                      num_heads=(3, 6, 12, 24), window_size=7,
                      drop_path_rate=0.0),
    bert=C.BertConfig(vocab_size=120, num_layers=1, intermediate_size=256,
                      max_position_embeddings=64, hidden_dropout=0.0,
                      attn_dropout=0.0),
    img_size=64, max_tokens=6, dtype="float32")
SYNTH = ["--synthetic", "--synthetic_steps", "2", "-b", "2", "--img_size",
         "32", "--print-freq", "1", "--no_bf16", "--device", "cpu"]


def _batches(steps=STEPS, b=WORLD * B, img=64, tokens=6):
    rng = np.random.default_rng(9)
    out = []
    for _ in range(steps):
        mask = np.ones((b, tokens), np.int32)
        mask[0, 4:] = 0
        out.append({
            "image": rng.integers(0, 256, (b, img, img, 3)).astype(np.uint8),
            "ids": rng.integers(1, 120, (b, tokens)).astype(np.int32),
            "mask": mask,
            "target": rng.integers(0, 2, (b, img, img)).astype(np.int32)})
    return out


def _bn_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((WORLD * B, 8, 5, 6)).astype(np.float32) * 2 + 1
    gy = rng.standard_normal(x.shape).astype(np.float32)
    w = rng.standard_normal(8).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, gy, w, b)]


def _bn_run(bn, x, gy):
    """One training forward + backward: y, dx, dweight, dbias, and the
    state after it."""
    x = x.clone().requires_grad_()
    y = bn(x)
    (y * gy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "state": bn.state_dict()}


def _shrunk(args):
    cfg = cli_args.model_config_from_args(args)
    return cfg.replace(
        swin=C.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                          num_heads=(1, 2, 4, 8), window_size=4,
                          drop_path_rate=0.0),
        bert=C.BertConfig(num_layers=1, vocab_size=120), img_size=32)


def _steps(batches, world, rank, use_checkpoint):
    """STEPS train steps of CFG from its seeded init: each step's loss and
    gradients, then the parameters and BatchNorm buffers."""
    cfg = CFG.replace(use_checkpoint=use_checkpoint)
    model = build_model(cfg, "cpu", train=True,
                        generator=torch.Generator().manual_seed(5))
    if world > 1:
        ddp.convert_sync_bn(model)
    tcfg = TrainConfig(iters_per_epoch=STEPS)
    opt, sched = create_train_state(model, tcfg)
    step = make_train_step(ddp.wrap_ddp(model, torch.device("cpu"))
                           if world > 1 else model, opt, sched, tcfg)
    out = {"loss": [], "iou": [], "grads": []}
    for batch in batches:
        part = {k: torch.from_numpy(v[rank * B:(rank + 1) * B]
                                    if world > 1 else v)
                for k, v in batch.items()}
        metrics = step(part, torch.Generator().manual_seed(0))
        out["loss"].append(float(metrics["loss"]))
        out["iou"].append(float(metrics["iou"]))
        out["grads"].append({n: p.grad.clone() for n, p
                             in model.named_parameters()
                             if p.grad is not None})
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


def _child(rank, tmp):
    """One rank: every case that needs the group; results to a file."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=WORLD,
                            timeout=GROUP_TIMEOUT)
    try:
        x, gy, w, b = _bn_inputs()
        bn = ddp.convert_sync_bn(nn.Sequential(nn.BatchNorm2d(8)))[0]
        with torch.no_grad():
            bn.weight.copy_(w)
            bn.bias.copy_(b)
        part = slice(rank * B, (rank + 1) * B)
        out = {"bn_type": type(bn).__name__,
               "bn": _bn_run(bn, x[part], gy[part])}
        batches = _batches()
        out["steps"] = {ck: _steps(batches, WORLD, rank, ck)
                        for ck in (False, True)}

        meter = SmoothedValue()
        for v in range(rank + 1):
            meter.update(10.0 * (rank + 1) + v, n=2)
        logger = MetricLogger()
        logger.update(loss=1.0 + rank)
        meter.synchronize_between_processes()
        logger.synchronize_between_processes()
        out["meter"] = (meter.count, meter.total, logger.loss.count,
                        logger.loss.total)

        cli_train.model_config_from_args = _shrunk
        rec = cli_train.main(SYNTH + ["--epochs", "1", "--output-dir",
                                      os.path.join(tmp, "ckpt")])
        out["cli"] = {"checkpoint": rec["checkpoint"], "epoch": rec["epoch"],
                      "still_initialized": dist.is_initialized()}
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _torchrun_child(rank, port, tmp):
    """One rank as torchrun starts it: the CLI makes and ends the group."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    cli_train.model_config_from_args = _shrunk
    rec = cli_train.main(SYNTH + ["--epochs", "1", "--output-dir",
                                  os.path.join(tmp, "ckpt")])
    torch.save({"checkpoint": rec["checkpoint"],
                "initialized": dist.is_initialized()},
               os.path.join(tmp, f"rank{rank}.pt"))


def _spawn(fn, args, tmp):
    """Run fn(rank, *args) in WORLD processes; each rank's saved dict."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(fn, args=args, nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOIN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the world-2 processes did not end in "
                        f"{JOIN_LIMIT_S} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def torchrun_world2(tmp):
    """`cli.train.main` at world 2 under torchrun's environment variables
    (a free localhost port): each rank's {"checkpoint", "initialized"}."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return _spawn(_torchrun_child, (port, tmp), tmp)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The two ranks' results (each rank's dict), and their directory."""
    tmp = str(tmp_path_factory.mktemp("ddp"))
    return _spawn(_child, (tmp,), tmp), tmp


@pytest.fixture(scope="module")
def one_process():
    batches = _batches()
    return {ck: _steps(batches, 1, 0, ck) for ck in (False, True)}


def test_sync_batch_norm_matches_the_joint_batch(world2):
    ranks, _ = world2
    assert all(r["bn_type"] == "SyncBatchNorm2d" for r in ranks)
    x, gy, w, b = _bn_inputs()
    bn = nn.BatchNorm2d(8)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    want = _bn_run(bn.train(), x, gy)
    got = [r["bn"] for r in ranks]
    close = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), want["y"],
                               **close)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), want["dx"],
                               **close)
    for key in ("dw", "db"):
        torch.testing.assert_close(got[0][key] + got[1][key], want[key],
                                   **close)
    for g in got:
        assert g["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            torch.testing.assert_close(g["state"][k], v, **close)
        assert int(g["state"]["num_batches_tracked"]) == 1


def test_sync_batch_norm_eval_is_batch_norm():
    """In eval mode (no process group) it is nn.BatchNorm2d on its running
    statistics, and its state dict loads into nn.BatchNorm2d."""
    x, _, w, b = _bn_inputs()
    bn = nn.BatchNorm2d(8)
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
        bn.running_mean.uniform_()
        bn.running_var.uniform_(0.5, 2.0)
    sync = ddp.convert_sync_bn(nn.Sequential(bn))[0]
    assert isinstance(sync, ddp.SyncBatchNorm2d) and sync.weight is bn.weight
    plain = nn.BatchNorm2d(8).eval()
    plain.load_state_dict(sync.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(sync.eval()(x), plain(x), rtol=0, atol=0)


@pytest.mark.parametrize("use_checkpoint", [False, True],
                         ids=["plain", "checkpoint"])
def test_ddp_steps_match_the_joint_batch(world2, one_process,
                                         use_checkpoint):
    ranks, _ = world2
    want = one_process[use_checkpoint]
    lr = TrainConfig().lr
    for r in ranks:
        got = r["steps"][use_checkpoint]
        for s in range(STEPS):
            assert abs(got["loss"][s] - want["loss"][s]) <= \
                1e-5 * abs(want["loss"][s]), (s, got["loss"], want["loss"])
            assert abs(got["iou"][s] - want["iou"][s]) <= 1e-6
            wg, gg = want["grads"][s], got["grads"][s]
            assert gg.keys() == wg.keys()
            top = max(float(v.abs().max()) for v in wg.values())
            for name, w in wg.items():
                bound = (1e-4 * float(w.norm())
                         + 1e-6 * top * float(np.sqrt(w.numel())))
                assert float((gg[name] - w).norm()) <= bound, (s, name)
        for k, v in want["state"].items():
            g = got["state"][k]
            if k.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(g, v, rtol=1e-5, atol=1e-5)
            elif v.is_floating_point():
                torch.testing.assert_close(g, v, rtol=1e-5, atol=2 * lr,
                                           msg=k)
            else:
                assert torch.equal(g, v), k


@pytest.mark.parametrize("name", sorted(losses.LOSSES))
def test_loss_weight_joins_batches(name):
    """The joint batch's loss is the halves' losses weighted by
    `loss_weight`: what the DDP step's one all_reduce relies on."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((4, 16, 16, 2)).astype(
        np.float32))
    target = torch.from_numpy(rng.integers(0, 2, (4, 16, 16)))
    fn = losses.get_loss(name)
    halves = [(fn(logits[s], target[s]), losses.loss_weight(name, target[s]))
              for s in (slice(0, 2), slice(2, 4))]
    joint = sum(l * w for l, w in halves) / sum(w for _, w in halves)
    torch.testing.assert_close(joint, fn(logits, target), rtol=1e-6,
                               atol=1e-6)


def test_meters_sum_over_processes(world2):
    ranks, _ = world2
    # rank 0 adds 10 (n=2); rank 1 adds 20 and 21 (n=2 each)
    want = (6, 2 * (10 + 20 + 21), 2, 1.0 + 2.0)
    for r in ranks:
        assert r["meter"] == want


def test_cli_in_a_process_group_checkpoints_on_rank_0(world2, monkeypatch):
    ranks, tmp = world2
    ckpt_dir = os.path.join(tmp, "ckpt")
    files = os.listdir(ckpt_dir)
    assert len(files) == 1 and files[0].startswith("epoch_0000")
    path = os.path.join(ckpt_dir, files[0])
    assert ranks[0]["cli"]["checkpoint"] == path
    assert ranks[1]["cli"]["checkpoint"] is None
    # the caller's group is used as it is, not destroyed by main
    assert all(r["cli"]["still_initialized"] and r["cli"]["epoch"] == 0
               for r in ranks)
    sd = torch.load(path, weights_only=False)["model"]
    assert not any(k.startswith("module.") for k in sd)
    assert "classifier.bn1_4.running_var" in sd
    monkeypatch.setattr(cli_train, "model_config_from_args", _shrunk)
    rec = cli_train.main(SYNTH + ["--epochs", "2", "--resume", ckpt_dir,
                                  "--output-dir", ""])
    assert rec["start_epoch"] == 1 and rec["epoch"] == 1


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("n,world,bs", [(11, 2, 1), (11, 2, 2), (10, 3, 1),
                                        (7, 1, 2)])
def test_loader_shards(n, world, bs):
    """The shards of one epoch are disjoint and equally long on a size the
    world does not divide, so every process takes the same number of
    steps; together they take the epoch's permutation but its last
    n % world items (all of it at bs 1)."""
    shards = []
    for rank in range(world):
        loader = PrefetchLoader(_Items(n), bs, np.asarray, num_workers=1,
                                seed=3, shard_index=rank, num_shards=world)
        loader.set_epoch(2)
        got = [b.tolist() for b in loader]
        assert len(got) == len(loader) == (n // world) // bs
        shards.append([i for b in got for i in b])
    flat = [i for s in shards for i in s]
    assert len(flat) == len(set(flat))
    order = np.arange(n)
    np.random.default_rng(3 + 2).shuffle(order)
    if bs == 1:
        assert sorted(flat) == sorted(order[:world * (n // world)].tolist())


def test_step_generators():
    """Rank 0 (and a one-process run) keeps the (seed + 1, step) stream;
    rank r > 0 draws from (seed + 1, step, r)."""
    def draws(gen):
        return torch.rand(8, generator=gen)

    def seeded(entropy):
        s = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
        return torch.Generator().manual_seed(int(s[0]))

    for seed, step in ((0, 0), (3, 17)):
        base = draws(cli_train.step_generator(seed, step, "cpu"))
        assert torch.equal(base, draws(seeded([seed + 1, step])))
        assert torch.equal(base, draws(cli_train.step_generator(
            seed, step, "cpu", rank=0)))
        one = draws(cli_train.step_generator(seed, step, "cpu", rank=1))
        assert torch.equal(one, draws(seeded([seed + 1, step, 1])))
        assert not torch.equal(one, base)


def test_init_distributed_without_a_group(monkeypatch):
    """World 1: no group is made; a CUDA device without a card raises
    rather than falling back to the CPU."""
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert ddp.init_distributed("cpu") == (0, 1, torch.device("cpu"))
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ddp.init_distributed("cuda")
