"""Pipeline-parallel multi-pass inference over a frame stream —
counterpart of ``mpgan_tpu/infer/pipeline.py``.

The device list is split into one group per generator pass. Each group is
slice-data-parallel inside (:func:`mpgan_torch.infer.assemble.
apply_sliced` with the group's devices), and consecutive frames occupy
different stages at once: while stage B refines frame t, stage A runs pass
1 of frame t+1.

Mechanics: every stage runs on its own CUDA stream on its group's first
device. The handoff is a ``non_blocking`` copy onto the next stage's
device, ordered after the producing stage by an event; the host
synchronises nothing, so :meth:`InferencePipeline.submit` returns once the
frame's work is enqueued. A tensor that one stream made and another reads
is marked with ``record_stream`` so that the caching allocator does not
hand its memory out before the reader is done. Stages may share a device
(``[cuda:0] * 2``): their streams still overlap on the one card. On the CPU
the stages run one after another.

A stage replays CUDA graphs on cards, the counterpart of JAX's jitted
``fn1``, ``fn2`` and ``fn3`` (:func:`mpgan_torch.infer.assemble.graphable`).
Where its group is one card (a list that repeats it included), whether or
not the other stages share that card, it runs its pass as a
:class:`~mpgan_torch.infer.assemble.GraphedProgram` per input shape and
dtype (eager at a shape's first frame, captured on its own card at its
second, replayed after; ``MAX_PROGRAMS`` kept), on its own stream. Each
replay's output is copied on that stream before the handoff, so that the
stage's next replay cannot overwrite a frame that the next stage still
reads. A stage spread over several distinct cards runs its pass eagerly
on its first card with each card's share of the slices replayed as that
card's program (:class:`~mpgan_torch.infer.assemble.CardPrograms`, one
per input shape and dtype, ``MAX_PROGRAMS`` kept), as a capture lives on
one device.

Pass 2 runs its convolutions on the full-resolution xy grid, about up_res×
pass 1's work per frame (pass 3 likewise), so :func:`default_split`
assigns devices in proportion to [1, up, up].
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict, deque
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from mpgan_torch.infer import assemble
from mpgan_torch.parallel import mesh as pmesh


def default_split(n_devices: int, n_stages: int, up_res: int
                  ) -> tuple[int, ...]:
    """Devices per stage in proportion to the cost weights [1, up, up, …]
    (JAX ``:43-60``)."""
    if n_devices < n_stages:
        raise ValueError(
            f"pipeline needs >= 1 device per stage: {n_devices} devices for "
            f"{n_stages} stages")
    w = [1.0] + [float(up_res)] * (n_stages - 1)
    total = sum(w)
    split = [max(1, round(n_devices * wi / total)) for wi in w]
    # repair rounding so that the split sums to n_devices: shrink the
    # largest stage, grow the heaviest-weighted one
    while sum(split) > n_devices:
        i = max(range(n_stages), key=lambda j: (split[j], w[j]))
        split[i] -= 1
    while sum(split) < n_devices:
        i = max(range(n_stages), key=lambda j: (w[j], -split[j]))
        split[i] += 1
    return tuple(split)


class _Stage:
    """One pass on a device group: its devices, its pass function
    ``fn(gen, *inputs, programs=None)``, on a card its own stream on the
    group's first device, and on cards its graphed programs."""

    def __init__(self, devices: list[torch.device], fn):
        self.devices = devices
        self.device = devices[0]
        self.fn = fn
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.graphed = assemble.graphable(self.device, devices)
        self.split = assemble.spans_cards(devices)
        # (input shapes and dtypes) → program (CardPrograms where the group
        # spans cards), least recently used first
        self.programs: OrderedDict = OrderedDict()

    def run(self, gen, *xs):
        """The stage's pass over ``xs`` with ``gen`` (its replica on this
        stage's device); graphed on one card, a replay's output is copied
        out on the current stream (call inside :meth:`context`). A program
        holds the replica it captured: a new replica (the generator's
        parameters changed in place) gets a new program."""
        if not self.graphed:
            return self.fn(gen, *xs)
        key = tuple(None if x is None else (tuple(x.shape), x.dtype)
                    for x in xs)
        program = self.programs.get(key)
        if program is not None and program.modules != [gen]:
            program.release()
            del self.programs[key]
        if self.split:
            programs = assemble.cached_program(
                self.programs, key, lambda: assemble.CardPrograms((gen,)))
            return self.fn(gen, *xs, programs=programs)
        program = assemble.cached_program(
            self.programs, key, lambda: assemble.GraphedProgram(
                lambda *ys: self.fn(gen, *ys), (gen,), self.device))
        return assemble.run_copied(program, *xs)

    def release(self) -> None:
        for program in self.programs.values():
            program.release()
        self.programs.clear()

    def context(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def send(self, t: torch.Tensor | None) -> torch.Tensor | None:
        """``t`` on this stage's device. Called inside the *producing*
        stage's context: a copy between cards runs on the source device's
        current stream, which must be the producer's."""
        return None if t is None else t.to(self.device, non_blocking=True)

    def mark(self):
        """An event after the work enqueued on this stage so far (None on
        the CPU)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def receive(self, ts, after):
        """Order this stage after event ``after`` and mark the tensors it
        will read as used on its stream; call inside :meth:`context`."""
        if self.stream is not None:
            self.stream.wait_event(after)
            for t in ts:
                if t is not None:
                    t.record_stream(self.stream)
        return ts


class InferencePipeline:
    """Two- or three-stage pipeline-parallel upscaler over a frame stream.

    Produces the volumes :func:`mpgan_torch.infer.assemble.upscale_volume`
    produces; only the placement differs. ``devices`` defaults to every
    visible card (a list may repeat a device); ``split`` gives the devices
    per stage (:func:`default_split` when None). A stage on cards replays
    CUDA graphs (module docstring); :meth:`release` frees the graphs and
    their pools.
    """

    def __init__(self, gen1, gen2, up_res: int,
                 devices: Sequence | None = None,
                 split: Sequence[int] | None = None, chunk: int = 0,
                 gen3=None, stage: int | None = None):
        if gen2 is None:
            raise ValueError("pipeline parallelism needs a pass-2 generator "
                             "(single-pass inference has one stage)")
        devices = pmesh.make_mesh(devices=devices)
        self.n_stages = 3 if gen3 is not None else 2
        if split is None:
            split = default_split(len(devices), self.n_stages, up_res)
        split = tuple(int(s) for s in split)
        if len(split) != self.n_stages:
            raise ValueError(f"split {split} has {len(split)} entries for "
                             f"{self.n_stages} pipeline stages")
        if sum(split) > len(devices) or min(split) < 1:
            raise ValueError(f"split {split} does not fit {len(devices)} "
                             "devices (>=1 per stage)")
        self.split = split
        offs = [sum(split[:i]) for i in range(self.n_stages + 1)]
        groups = [devices[offs[i]:offs[i + 1]] for i in range(self.n_stages)]
        fns = [
            lambda g, lr, programs=None: assemble.pass1_volume(
                g, lr, stage=stage, chunk=chunk, devices=groups[0],
                programs=programs),
            lambda g, interm, vel, programs=None: assemble.pass2_volume(
                g, interm, vel, stage=stage, chunk=chunk,
                devices=groups[1], programs=programs),
            lambda g, vol, vel, programs=None: assemble.pass3_volume(
                g, vol, vel, chunk=chunk, devices=groups[2],
                programs=programs)]
        self.stages = [_Stage(group, fn) for group, fn in zip(groups, fns)]
        self.gens = [gen1, gen2, gen3][:self.n_stages]
        self.up_res, self.chunk, self.stage = up_res, chunk, stage

    def release(self) -> None:
        """Release every stage's graphs and their memory pools (a later
        frame captures anew)."""
        for st in self.stages:
            st.release()

    def _enqueue(self, lr_vol) -> tuple[torch.Tensor, object]:
        """Enqueue one frame through every stage → (final volume, the
        event after its last stage)."""
        if lr_vol.shape[0] == 1:
            raise ValueError("2D frames (Z == 1) are single-pass; the "
                             "pipeline needs volumetric input")
        st = self.stages
        gens = [assemble.replica(g, s.device)
                for g, s in zip(self.gens, st)]
        three = self.n_stages == 3
        lr = (torch.from_numpy(np.ascontiguousarray(lr_vol,
                                                    dtype=np.float32))
              if isinstance(lr_vol, np.ndarray) else lr_vol)
        with torch.inference_mode():
            if lr.is_cuda and st[0].stream is not None:
                # a frame on a card: after the caller's work on it
                st[0].stream.wait_stream(torch.cuda.current_stream(
                    lr.device))
            with st[0].context():
                lr = st[0].send(lr)
                if lr.is_cuda and st[0].stream is not None:
                    lr.record_stream(st[0].stream)
                interm = st[0].run(gens[0], lr)
                vel = lr[..., 1:4] if lr.shape[-1] >= 4 else None
                to2 = st[1].send(interm), st[1].send(vel)
                vel3 = st[2].send(vel) if three else None
                done = st[0].mark()
            with st[1].context():
                interm, vel = st[1].receive(to2, done)
                out = st[1].run(gens[1], interm, vel)
                if three:
                    out = st[2].send(out)
                done2 = st[1].mark()
            if three:
                with st[2].context():
                    st[2].receive([vel3], done)
                    st[2].receive([out], done2)
                    out = st[2].run(gens[2], out, vel3)
                    done2 = st[2].mark()
        return out, done2

    @staticmethod
    def _handed_over(out: torch.Tensor, done) -> torch.Tensor:
        """Order the caller's current stream after the frame's last stage
        (no host wait) and hand ``out`` to it."""
        if done is not None:
            cur = torch.cuda.current_stream(out.device)
            cur.wait_event(done)
            out.record_stream(cur)
        return out

    def submit(self, lr_vol) -> torch.Tensor:
        """Enqueue one frame (a (Z, Y, X, C) array or tensor) through all
        stages → the final volume on the last stage's device, not yet
        computed: work the caller queues on it, and a fetch, wait for it.
        A frame already on a card is ordered after the caller's stream."""
        return self._handed_over(*self._enqueue(lr_vol))

    def stream(self, frames: Iterable, depth: int | None = None
               ) -> Iterator[torch.Tensor]:
        """Pump frames through the pipeline, yielding HR volumes in order.
        ``depth`` bounds the frames in flight (default n_stages + 1, the
        smallest window that keeps every stage busy)."""
        if depth is None:
            depth = self.n_stages + 1
        inflight: deque = deque()
        for lr in frames:
            inflight.append(self._enqueue(lr))
            if len(inflight) >= depth:
                yield self._handed_over(*inflight.popleft())
        while inflight:
            yield self._handed_over(*inflight.popleft())
