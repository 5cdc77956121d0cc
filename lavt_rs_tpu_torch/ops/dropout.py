"""Dropout and DropPath drawn from an explicit `torch.Generator`
(counterparts of flax `nn.Dropout` and `lavt_rs_tpu/models/swin2d.py:
drop_path`).

The masks are uniform f32 draws on the tensor's device, so two models
that make the same calls with generators in the same state draw the same
masks whatever their compute dtype.  Nothing is drawn in eval mode or at
rate 0.
"""

from __future__ import annotations

from typing import Optional

import torch


def _need(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("training with a dropout or drop-path rate > 0 "
                         "needs a torch.Generator for the draws")
    return generator


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Elementwise dropout: x / (1 - rate) where kept, else 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=_need(generator), device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def drop_path_kept(b: int, rate: float, training: bool,
                   generator: Optional[torch.Generator],
                   device) -> Optional[torch.Tensor]:
    """The per-sample DropPath draw: (b,) bool, True where a sample keeps
    its branch; None where nothing is drawn (eval mode or rate 0)."""
    if not training or rate == 0.0:
        return None
    u = torch.rand((b,), generator=_need(generator), device=device)
    return u < 1.0 - rate


def drop_path_scale(kept: Optional[torch.Tensor],
                    rate: float) -> Optional[torch.Tensor]:
    """The (b,) f32 branch scale of a drawn `kept` (`drop_path_kept`), as
    K8 takes it: 1 / (1 - rate) or 0; None for None."""
    if kept is None:
        return None
    return torch.where(kept, 1.0 / (1.0 - rate), 0.0).float()


def drop_path_apply(x: torch.Tensor, kept: Optional[torch.Tensor],
                    rate: float) -> torch.Tensor:
    """Per-sample stochastic depth with a drawn `kept` (`drop_path_kept`):
    each sample's branch is x / (1 - rate) or 0; x itself for None."""
    if kept is None:
        return x
    kept = kept.view((-1,) + (1,) * (x.ndim - 1))
    return torch.where(kept, x / (1.0 - rate), torch.zeros_like(x))


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth over x's leading dim (timm DropPath):
    each sample's branch is x / (1 - rate) or 0."""
    return drop_path_apply(
        x, drop_path_kept(x.shape[0], rate, training, generator, x.device),
        rate)


def dropout_seed(rate: float, training: bool,
                 generator: Optional[torch.Generator],
                 device) -> Optional[int]:
    """A seed for a block's own dropout generator (`seeded`), drawn from
    `generator`; None where nothing is drawn (eval mode or rate 0).  A
    Swin block draws its dropout masks (Swin `drop_rate`) from a generator
    of its own, made from this seed when the block runs, so that a
    checkpointed block's recompute draws the masks of its forward."""
    if not training or rate == 0.0:
        return None
    return int(torch.randint(0, 2 ** 62, (1,), generator=_need(generator),
                             device=device).item())


def seeded(seed: Optional[int], device) -> Optional[torch.Generator]:
    """The generator of a `dropout_seed` on `device` (None for None)."""
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)
