"""The CPU tests' stand-in for the CUDA-graph primitive
(``mpgan_torch.train.graphed.Graph``), and the small trainer that the
graphed train tests drive.

:class:`StubGraph` behaves as a CUDA graph does where the tests can see
it: the capture runs nothing (it records work without running it, so a
train step is not taken and a registered generator draws nothing), the
first replay runs the captured function, and each later replay runs it
again and writes into the outputs the first returned, as a graph writes
its static outputs: a caller that kept a replay's output sees it
overwritten. Its ``log`` records capture, replay and reset in order, each
as the event's name, or as ``(name, *detail(graph, name))`` where
:func:`install` is given ``detail``.
"""

import torch

from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.train import graphed, recipe


class StubGraph:
    log: list = []
    detail = None

    @staticmethod
    def available(device):
        return True

    def __init__(self, fn, device, generator=None):
        self.fn, self.device, self.generator = fn, torch.device(device), \
            generator
        self.out = None
        self.launches = (0, 0)
        self.counts = {}
        self._note("capture")

    def _note(self, event):
        detail = type(self).detail
        self.log.append(event if detail is None
                        else (event, *detail(self, event)))

    def replay(self):
        self._note("replay")
        new = self.fn()
        if self.out is None:
            self.out = new
        elif isinstance(new, torch.Tensor):
            self.out.copy_(new)
        elif isinstance(new, dict):
            for k, v in new.items():
                if isinstance(v, torch.Tensor):
                    self.out[k].copy_(v)
        else:
            for o, n in zip(self.out, new, strict=True):
                o.copy_(n)
        return self.out

    def reset(self):
        self._note("reset")
        self.out = None


def install(monkeypatch, detail=None) -> type:
    """``graphed.Graph`` replaced by :class:`StubGraph` with an empty log
    (entries with ``detail``, a function of the graph and the event)."""
    monkeypatch.setattr(StubGraph, "log", [])
    monkeypatch.setattr(StubGraph, "detail",
                        None if detail is None else staticmethod(detail))
    monkeypatch.setattr(graphed, "Graph", StubGraph)
    return StubGraph


def small_config(**train_kw):
    """The flagship recipe at base width 8, one res block, batch 2, tiles
    of 4 LR pixels; ``train_kw`` set on its ``train`` section."""
    cfg = recipe.flagship_config("float32", batch=2, tile=4)
    cfg.model.n_base_filters = 8
    cfg.model.n_res_blocks = 1
    cfg.model.disc_base_filters = 8
    for k, v in train_kw.items():
        setattr(cfg.train, k, v)
    return cfg


def tile_creator(device="cpu"):
    """Tiles of 4 LR pixels from a synthetic 8³ dataset at 4x."""
    ds = recipe.synthetic_dataset(size=8, up=4, seed=2)
    return tpipeline.TileCreator(ds, 4, density_threshold=0.0, device=device)
