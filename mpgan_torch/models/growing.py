"""Progressive-growing parameter management.

Counterpart of ``mpgan_tpu/models/growing.py``. Modules are stage-indexed,
so the stage-k ``state_dict`` is a subset of the stage-(k+1) one: growing
builds the larger model and merges the smaller one's tensors over it.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch


def migrate_params(old: Mapping[str, torch.Tensor],
                   new: Mapping[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """``new`` with every tensor of ``old`` copied over it (stage k → k+1).

    Every old key must exist in ``new`` with the same shape (KeyError /
    ValueError otherwise)."""
    merged = dict(new)
    for key, leaf in old.items():
        if key not in new:
            raise KeyError(f"param {key} missing in grown model — stage "
                           "models are not nested")
        if leaf.shape != new[key].shape:
            raise ValueError(f"param {key} shape changed "
                             f"{tuple(leaf.shape)} → "
                             f"{tuple(new[key].shape)}")
        merged[key] = leaf
    return merged


def subtree_check(small: Mapping[str, torch.Tensor],
                  big: Mapping[str, torch.Tensor]) -> bool:
    """True iff every key of ``small`` exists in ``big`` with its shape."""
    return all(k in big and v.shape == big[k].shape for k, v in small.items())


def alpha_schedule(it: int, stage_start_it: int, alpha_iters: int) -> float:
    """Linear 0→1 fade over ``alpha_iters`` after a stage transition."""
    if alpha_iters <= 0:
        return 1.0
    return float(min(max((it - stage_start_it) / alpha_iters, 0.0), 1.0))


class GrowthSchedule:
    """Maps a global iteration to (stage, alpha).

    Stage k (1-based) trains for ``alpha_iters + stable_iters`` iterations:
    α ramps 0→1 over the first ``alpha_iters`` (stage 1 starts at α=1),
    then holds at 1. The final stage trains until the end.
    """

    def __init__(self, n_stages: int, alpha_iters: int, stable_iters: int):
        self.n_stages = n_stages
        self.alpha_iters = alpha_iters
        self.stable_iters = stable_iters

    def stage_at(self, it: int) -> tuple[int, float]:
        per_stage = self.alpha_iters + self.stable_iters
        if per_stage <= 0:
            return self.n_stages, 1.0
        idx = it // per_stage  # 0-based stage index
        if idx >= self.n_stages:
            return self.n_stages, 1.0
        stage = idx + 1
        if stage == 1:
            return 1, 1.0  # first stage never fades
        return stage, alpha_schedule(it, idx * per_stage, self.alpha_iters)

    def boundaries(self) -> list[int]:
        per_stage = self.alpha_iters + self.stable_iters
        return [k * per_stage for k in range(1, self.n_stages)]


def count_params(params: torch.nn.Module | Mapping[str, torch.Tensor]) -> int:
    """Number of parameter values of a module or a ``state_dict``."""
    tensors = (params.parameters() if isinstance(params, torch.nn.Module)
               else params.values())
    return sum(int(t.numel()) for t in tensors)
