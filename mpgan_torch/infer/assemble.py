"""Full-volume multi-pass inference + slice reassembly.

Counterpart of ``mpgan_tpu/infer/assemble.py`` :29-142 and :219-283:
LR volume (Z, Y, X, C) →
  pass 1: all z-slices (xy planes) through G1 → intermediate
          (Z, Y·s, X·s, 1);
  pass 2: all y-slices (xz planes) of the intermediate volume + the LR
          velocity linearly resized to its grid through G2 → final
          (Z·s, Y·s, X·s, 1);
  pass 3 (optional): x-slices (yz planes) of the final volume through G3.

Channel layouts match the training pipeline: xy slices use [d, vx, vy, vz],
xz slices [d, vx, vz, vy], yz slices [d, vz, vy, vx]. Generators are
:class:`mpgan_torch.models.generator.Generator` modules that own their
parameters. :func:`precompute_intermediates` and :func:`precompute_finals`
sweep a dataset for pass-2 and pass-3 training, and
:func:`upscale_volume_streamed` assembles pass 2 in host memory.

The slice axis is the data-parallel axis (JAX ``:38-55``): with a device
list (:func:`mpgan_torch.parallel.mesh.make_mesh`) each call's slices are
split over the devices, each device runs its own replica of the generator
(:func:`replica`), and the results are gathered on the first device in
slice order. Per-slice 2D convolutions need no halo exchange.

On one card a whole upscale is one device program, as JAX jits it
(:func:`make_graphed_upscaler`, the counterpart of ``make_jitted_upscaler``):
a CUDA graph per input shape, replayed per call (:class:`GraphedProgram`),
and each sweep replays one program over all its volumes; so does each
stage of :class:`mpgan_torch.infer.pipeline.InferencePipeline` on one card.
Over distinct cards a capture cannot hold the call, so each card's share of
each pass is its own program, captured on that card (:class:`CardPrograms`),
and the gather, transposes and velocity resizes between the passes run
eagerly on the first card.
The streamed assembly's chunks run eagerly (JAX jits its ``chunk_fn``):
the host's fetch of each chunk bounds that path, and a capture made anew
per call costs more than its replays save.

Spans (:mod:`mpgan_torch.tracing`): ``upscale.frame``, one call of a
graphed upscaler, timed on its card; ``upscale.pass`` (``pass_no``), one
pass, timed on its card when it runs on one (inside a captured program by
events recorded into the graph, read for the last traced replay). Within a
pass split over several devices, each timed on the stream
its work runs on: ``upscale.scatter`` (``card``), the copy of a share from
the first card; ``upscale.share`` (``card``), a card's call or replay on
its share; ``upscale.gather`` (``card``), the copy of its result back,
which runs on that card (the first card's own share copies nothing);
``upscale.between``, the first card's own work after the gather (the
concatenation, and before pass 2 or 3 the velocity resize), begun after
the waits for the other cards are enqueued. A pass enqueues all its
scatters before any share: PyTorch runs a copy between cards on the
source card's stream, behind whatever is queued there, so a scatter
queued after the first card's share would hold the other cards until
that share ends.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import weakref
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from mpgan_torch import tracing
from mpgan_torch.ops.upsample import resize_volume
from mpgan_torch.parallel.mesh import canonical
from mpgan_torch.train import graphed

# captured programs a graphed upscaler keeps, one per input shape and dtype
# (make_graphed_upscaler): each holds a memory pool somewhat above the
# eager call's peak (2.33 GB against 1.72 GB at 64³→256³ bf16 on an H100,
# chip_smoke.py phase 4)
MAX_PROGRAMS = 2

# generator → {device: (parameter versions, replica on that device)}
_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def replica(gen: torch.nn.Module, device) -> torch.nn.Module:
    """``gen`` itself on its own device; elsewhere a copy on ``device``,
    made once and made again when ``gen``'s parameters change in place."""
    device = canonical(device)
    params = list(gen.parameters())
    if canonical(params[0].device) == device:
        return gen
    version = tuple(p._version for p in params)
    per = _REPLICAS.setdefault(gen, {})
    hit = per.get(device)
    if hit is None or hit[0] != version:
        # outside inference mode: a replica must hold ordinary tensors
        with torch.inference_mode(False), torch.no_grad():
            per[device] = (version, copy.deepcopy(gen).to(device))
    return per[device][1]


def spans_cards(devices) -> bool:
    """Whether a device list names more than one device."""
    return devices is not None and len({canonical(d) for d in devices}) > 1


def _per_device(gen, devices, programs=None, **kw):
    """The per-slice call of ``gen``. With a device list, the call of one
    device's share ``(x, device)``: on the replica of ``gen`` on that
    device, or, given ``programs`` (a :class:`CardPrograms`), as that
    card's captured program."""
    if devices is None or len(devices) <= 1:
        return lambda x: gen(x, **kw)
    if programs is not None:
        return lambda x, dev: programs.run(gen, kw, x, dev)
    return lambda x, dev: replica(gen, dev)(x, **kw)


def _split_apply(share_fn, x: torch.Tensor, devices) -> torch.Tensor:
    """``share_fn(block, device)`` over ``x`` split into one contiguous
    block per device. Every scatter is enqueued before any share, and every
    share before any result is gathered, so the devices overlap. A copy
    between cards runs on the source card's stream behind whatever is
    queued there: a scatter enqueued after the first card's own share
    would start the other cards only when that share ends. Each step is a
    span (module docstring)."""
    first = devices[0]
    parts = []
    for card, (part, dev) in enumerate(zip(
            torch.tensor_split(x, len(devices)), devices)):
        if not part.shape[0]:
            continue
        with tracing.span("upscale.scatter", first, card=card):
            parts.append((card, dev, part.to(dev, non_blocking=True)))
    outs = []
    for card, dev, part in parts:
        with tracing.span("upscale.share", dev, card=card):
            outs.append((card, dev, share_fn(part, dev)))
    gathered = []
    for card, dev, out in outs:
        with tracing.span("upscale.gather", dev, card=card):
            gathered.append(out.to(first, non_blocking=True))
    with tracing.span("upscale.between", first):
        return torch.cat(gathered)


def _between(devices):
    """The span of the first card's own work between the passes of a call
    split over ``devices``; none for a call on one device."""
    if devices is None or len(devices) <= 1:
        return contextlib.nullcontext()
    return tracing.span("upscale.between", devices[0])


def _pass_span(pass_no: int, vol: torch.Tensor, devices):
    """The span of one pass over ``vol``, timed on its card unless the
    pass is split over several."""
    device = None if spans_cards(devices) else vol.device
    return tracing.span("upscale.pass", device, pass_no=pass_no)


def apply_sliced(apply_fn, slices: torch.Tensor, chunk: int = 0,
                 devices=None) -> torch.Tensor:
    """Run a per-slice model over a (N, H, W, C) slice stack.

    chunk = 0 → one batch; otherwise fixed-size chunks, the last one
    zero-padded to the chunk size and trimmed (every call sees one shape),
    written into one preallocated output. ``devices`` (a list, which may
    repeat a device) splits each batch over the devices; ``apply_fn`` then
    takes ``(slices, device)``, the slices on that device (:func:`replica`),
    and the result lies on the first.
    """
    if devices is not None and len(devices) > 1:
        devs = [canonical(d) for d in devices]
        fn = apply_fn
        apply_fn = lambda x: _split_apply(fn, x, devs)  # noqa: E731
    n = slices.shape[0]
    if chunk <= 0 or chunk >= n:
        return apply_fn(slices)
    out = None
    for i in range(0, n, chunk):
        part = slices[i:i + chunk]
        m = part.shape[0]
        if m < chunk:
            pad = part.new_zeros((chunk - m, *part.shape[1:]))
            part = torch.cat([part, pad])
        res = apply_fn(part)[:m]
        if out is None:
            out = res.new_empty((n, *res.shape[1:]))
        out[i:i + m] = res
    return out


def pass1_volume(gen1, lr_vol: torch.Tensor, stage: int | None = None,
                 chunk: int = 0, devices=None,
                 programs=None) -> torch.Tensor:
    """(Z, Y, X, C) → intermediate (Z, Y·s, X·s, 1) via xy slices.
    ``programs`` (a :class:`CardPrograms`) replays each card's share of a
    split over distinct cards."""
    with _pass_span(1, lr_vol, devices):
        return apply_sliced(_per_device(gen1, devices, programs,
                                        stage=stage), lr_vol, chunk, devices)


def _with_velocity(vol: torch.Tensor, lr_vel: torch.Tensor | None,
                   perm: list[int], dtype: torch.dtype) -> torch.Tensor:
    """Stage ``vol`` in the generator's dtype, with the LR velocity resized
    to its grid (values stay in LR units) and permuted for the slice plane."""
    if lr_vel is None:
        return vol.to(dtype)
    vel = resize_volume(lr_vel.to(dtype), tuple(vol.shape[:3]))
    # channel slices, not vel[..., perm]: a list index is a host tensor,
    # whose copy to the card a CUDA graph cannot capture
    return torch.cat([vol.to(dtype)] + [vel[..., i:i + 1] for i in perm],
                     dim=-1)


def pass2_volume(gen2, interm: torch.Tensor, lr_vel: torch.Tensor | None,
                 stage: int | None = None, chunk: int = 0,
                 devices=None, programs=None) -> torch.Tensor:
    """Intermediate (Z, Ys, Xs, 1) [+ LR velocity (Z, Y, X, 3)] →
    final (Z·s, Ys, Xs, 1) via xz slices (z-axis refinement)."""
    with _pass_span(2, interm, devices):
        with _between(devices):
            vol_in = _with_velocity(interm, lr_vel, [0, 2, 1], gen2.dtype)
        slices = vol_in.permute(1, 0, 2, 3)          # (Ys, Z, Xs, C)
        out = apply_sliced(_per_device(gen2, devices, programs, stage=stage),
                           slices, chunk, devices)
    return out.permute(1, 0, 2, 3)                   # (Zs, Ys, Xs, 1)


def pass3_volume(gen3, vol: torch.Tensor, lr_vel: torch.Tensor | None,
                 chunk: int = 0, devices=None,
                 programs=None) -> torch.Tensor:
    """Constant-resolution refinement over yz slices of the full-res volume
    (Zs, Ys, Xs, 1); slice channels [d, v_w=vz, v_h=vy, v_out=vx]."""
    with _pass_span(3, vol, devices):
        with _between(devices):
            vol_in = _with_velocity(vol, lr_vel, [2, 1, 0], gen3.dtype)
        slices = vol_in.permute(2, 1, 0, 3)          # (Xs, Ys, Zs, C)
        out = apply_sliced(_per_device(gen3, devices, programs), slices,
                           chunk, devices)
    return out.permute(2, 1, 0, 3)


def upscale_volume(gen1, gen2, lr_vol: torch.Tensor, up_res: int,
                   stage: int | None = None, chunk: int = 0,
                   gen3=None, devices=None, programs=None) -> torch.Tensor:
    """Full multi-pass SR: (Z, Y, X, C) LR → (Z·s, Y·s, X·s, 1) HR density.

    lr_vol channels [d, vx, vy, vz] (or density only). Z = 1 (2D data)
    returns the pass-1 output. gen2=None → pass 1 with a nearest z-repeat
    standing in for pass 2; a pass-3 refiner still runs after it.
    ``devices`` splits every pass's slices over a device list;
    ``programs`` (a :class:`CardPrograms`) replays each card's shares.
    """
    interm = pass1_volume(gen1, lr_vol, stage=stage, chunk=chunk,
                          devices=devices, programs=programs)
    if lr_vol.shape[0] == 1:
        return interm
    lr_vel = lr_vol[..., 1:4] if lr_vol.shape[-1] >= 4 else None
    if gen2 is None:
        out = interm.repeat_interleave(up_res, dim=0)
    else:
        out = pass2_volume(gen2, interm, lr_vel, stage=stage, chunk=chunk,
                           devices=devices, programs=programs)
    if gen3 is not None:
        out = pass3_volume(gen3, out, lr_vel, chunk=chunk, devices=devices,
                           programs=programs)
    return out


def _velocity_rows(lr_vel: torch.Tensor, y0: int, rows: int, up: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Rows [y0, y0 + rows) of ``resize_volume(lr_vel, (Z, Y·s, X·s))``,
    from a window of LR rows only.

    A resize of an LR sub-block clamps at the sub-block's own edges, so the
    window takes one LR row of margin on each side (clamped at the volume's
    edges, as the full resize is); ``scale_factor=s`` with
    ``recompute_scale_factor=False`` makes each output row's source
    coordinate ``(j + 0.5)/s − 0.5`` with the full resize's 1/s, so the
    window's rows are the full resize's rows.
    """
    y = lr_vel.shape[1]
    lo = max(y0 // up - 1, 0)
    hi = min((y0 + rows - 1) // up + 2, y)
    win = F.interpolate(lr_vel[:, lo:hi].to(dtype).permute(0, 3, 1, 2),
                        scale_factor=(up, up),
                        mode="bilinear", align_corners=False,
                        recompute_scale_factor=False)
    start = y0 - lo * up
    return win[:, :, start:start + rows].permute(0, 2, 3, 1)


def upscale_volume_streamed(gen1, gen2, lr_vol: torch.Tensor, up_res: int,
                            chunk: int, stage: int | None = None,
                            chunk1: int | None = None) -> np.ndarray:
    """Two-pass SR whose output never lies in device memory (JAX
    ``:145-216``): output volumes larger than the card become possible.

    Pass 1 runs on ``lr_vol``'s device in slice chunks of ``chunk1``
    (default ``chunk``); its intermediate (Z, Y·s, X·s, 1) is s× smaller
    than the output and must fit. Pass 2 then runs ``chunk`` xz slices
    (rows of Y·s) at a time, each with its exact velocity window
    (:func:`_velocity_rows`), and each chunk's output goes into a
    preallocated float32 host array. On a card, chunk k is copied to one of
    two pinned host buffers on a second stream while chunk k+1 computes;
    the host then widens it into the array. The result equals a synchronous
    copy's. → (Z·s, Y·s, X·s, 1) float32 numpy.
    """
    interm = pass1_volume(gen1, lr_vol, stage=stage,
                          chunk=chunk if chunk1 is None else chunk1)
    z, y, x, c = lr_vol.shape
    zs, ys, xs = z * up_res, y * up_res, x * up_res
    lr_vel = lr_vol[..., 1:4] if c >= 4 else None
    dt = gen2.dtype
    dev = interm.device
    final = np.empty((zs, ys, xs, 1), np.float32)
    final_t = torch.from_numpy(final)
    on_card = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if on_card else None
    host_bufs = []     # two host buffers, pinned on a card
    pending = None     # (y0, rows, buffer, copy-done event) of chunk k − 1

    def drain(p):
        p_y0, p_rows, buf, done = p
        if done is not None:
            done.synchronize()
        final_t[:, p_y0:p_y0 + p_rows].copy_(buf[:p_rows].transpose(0, 1))

    for k, y0 in enumerate(range(0, ys, chunk)):
        rows = min(chunk, ys - y0)
        slices = interm[:, y0:y0 + rows].to(dt).transpose(0, 1)
        if lr_vel is not None:
            vel = _velocity_rows(lr_vel, y0, rows, up_res, dt)
            slices = torch.cat([slices, vel[..., [0, 2, 1]].transpose(0, 1)],
                               dim=-1)
        out = gen2(slices, stage=stage)                  # (rows, Zs, Xs, 1)
        if len(host_bufs) < 2:
            host_bufs.append(torch.empty((min(chunk, ys), *out.shape[1:]),
                                         dtype=out.dtype, pin_memory=on_card))
        buf = host_bufs[k % 2]
        done = None
        if on_card:
            copy_stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(copy_stream):
                buf[:rows].copy_(out, non_blocking=True)
                out.record_stream(copy_stream)
                done = torch.cuda.Event()
                done.record(copy_stream)
        else:
            buf[:rows].copy_(out)
        if pending is not None:
            drain(pending)
        pending = (y0, rows, buf, done)
    drain(pending)
    return final


def graphable(device, devices=None) -> bool:
    """Whether calls on ``device`` (split over ``devices``) can replay
    captured programs: CUDA graphs exist on every device named. On one
    card (a list that repeats it included) one capture holds the whole
    call; over distinct cards each card's shares are programs of their
    own (:class:`CardPrograms`), since a capture lives on one device."""
    return all(graphed.Graph.available(d) for d in [device, *(devices or ())])


class GraphedProgram:
    """``fn(*xs)`` for inputs of one shape and dtype each as one captured
    CUDA graph (:class:`mpgan_torch.train.graphed.Graph`), by the rule of
    the train step's :class:`~mpgan_torch.train.graphed.Program`: the
    first use runs ``fn`` eagerly (the warm-up: cuDNN's algorithm choice,
    the upsample weights, replicas), the second copies each input into the
    program's static inputs (``xs``, on ``device``, each with its input's
    strides: cuDNN picks a convolution's kernels by its input's layout, and
    a card's share of a split is a strided view on the first card) and
    captures, every later use copies in and replays. From the second use
    on, ``program(*xs)`` returns the graph's static output, which the next
    replay overwrites: a caller that keeps it copies it first
    (:func:`make_graphed_upscaler`). An input may be None (a pass without
    velocity); the captured function then gets None there too.

    An input may lie on the host. A replay raises ``RuntimeError`` when a
    parameter or buffer of ``modules`` no longer lies where it lay at the
    capture (a module moved or its tensors replaced: the graph would read
    the old storage); values changed in place are read by the replay.
    ``generator`` (a ``torch.Generator`` of ``device``) is registered with
    the graph: a replay draws from its state at the call, as an eager call
    does (the caller reseeds it)."""

    def __init__(self, fn, modules, device, generator=None):
        self.fn = fn
        self.modules = [m for m in modules if m is not None]
        self.device = canonical(device)
        self.generator = generator
        self.uses = 0
        self.graph: graphed.Graph | None = None
        self.xs: list[torch.Tensor | None] = []
        self.storage: list[int] = []

    def _storage(self) -> list[int]:
        return [t.data_ptr() for m in self.modules
                for t in itertools.chain(m.parameters(), m.buffers())]

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, *xs: torch.Tensor | None) -> torch.Tensor:
        self.uses += 1
        if self.uses == 1:
            return self.fn(*(None if x is None else x.to(self.device)
                             for x in xs))
        if self.graph is None:
            self.xs = [None if x is None else torch.empty_strided(
                x.shape, x.stride(), dtype=x.dtype, device=self.device)
                for x in xs]
            self._fill(xs)
            self.storage = self._storage()
            self.graph = graphed.Graph(lambda: self.fn(*self.xs),
                                       self.device, self.generator)
        elif self._storage() != self.storage:
            raise RuntimeError(
                "a generator's parameters were moved or replaced since its "
                "CUDA graph was captured; make the upscaler or pipeline anew")
        else:
            self._fill(xs)
        return self.graph.replay()

    def _fill(self, xs) -> None:
        for static, x in zip(self.xs, xs, strict=True):
            if static is not None:
                static.copy_(x)

    def release(self) -> None:
        """Release the graph, its memory pool and the static inputs."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = None
        self.xs = []


class CardPrograms:
    """The shares of calls split over distinct cards as captured programs:
    the counterpart of ``make_jitted_upscaler`` over a mesh, whose one
    program spans every device. A capture lives on one card, so each
    card's share of a pass is a :class:`GraphedProgram` of its own, one per
    (generator, its keywords, card, share shape, dtype), run on the
    generator's replica on that card (:func:`replica`; a new replica gets a
    new program) and captured on that card at its second use. Each
    replay's output is copied on the card's stream before the first card
    gathers it (:func:`run_copied`): a device list that repeats a card
    replays one program for several of its shares. ``modules`` are the
    caller's generators (a pipeline stage makes a new ``CardPrograms`` for
    a new replica); :meth:`release` frees every graph."""

    def __init__(self, modules=()):
        self.modules = list(modules)
        self.programs: dict[tuple, GraphedProgram] = {}

    def run(self, gen, kw: dict, x: torch.Tensor, device) -> torch.Tensor:
        """``gen``'s call with keywords ``kw`` on the share ``x``, which
        lies on ``device``, as that card's program."""
        device = canonical(device)
        rep = replica(gen, device)
        key = (gen, tuple(sorted(kw.items())), device, tuple(x.shape),
               x.dtype)
        program = self.programs.get(key)
        if program is None or program.modules != [rep]:
            if program is not None:
                program.release()
            program = self.programs[key] = GraphedProgram(
                lambda y: rep(y, **kw), (rep,), device)
        return run_copied(program, x)

    def release(self) -> None:
        for program in self.programs.values():
            program.release()
        self.programs.clear()


class GraphedUpscaler:
    """``lr (Z, Y, X, C) → HR (Z·s, Y·s, X·s, 1)`` over a pass chain, one
    :class:`GraphedProgram` per ``(input shape, dtype)``, or over distinct
    cards one :class:`CardPrograms` per ``(input shape, dtype)``
    (:func:`make_graphed_upscaler`)."""

    def __init__(self, gen1, gen2, up_res: int, stage: int | None = None,
                 chunk: int = 0, gen3=None, devices=None):
        self.device = canonical(next(gen1.parameters()).device)
        if not graphable(self.device, devices):
            raise ValueError(
                "a graphed upscaler captures each program on one CUDA card; "
                f"got {self.device} split over {devices}")
        self.modules = (gen1, gen2, gen3)
        self.split = spans_cards(devices)

        def fn(lr_vol, programs=None):
            return upscale_volume(gen1, gen2, lr_vol, up_res, stage=stage,
                                  chunk=chunk, gen3=gen3, devices=devices,
                                  programs=programs)
        self.fn = fn
        # least recently used first
        self.programs: OrderedDict[tuple, GraphedProgram | CardPrograms] = \
            OrderedDict()

    def __call__(self, lr_vol) -> torch.Tensor:
        with tracing.span("upscale.frame", self.device):
            return self._call(lr_vol)

    def _call(self, lr_vol) -> torch.Tensor:
        lr_vol = torch.as_tensor(lr_vol)
        key = (tuple(lr_vol.shape), lr_vol.dtype)
        if self.split:
            programs = cached_program(self.programs, key, CardPrograms)
            with torch.inference_mode():
                # the gather makes a fresh tensor per call
                return self.fn(lr_vol.to(self.device), programs)
        program = cached_program(
            self.programs, key,
            lambda: GraphedProgram(self.fn, self.modules, self.device))
        with torch.inference_mode():
            # a server fetches a result outside its device lock, while the
            # next request may replay
            return run_copied(program, lr_vol)


def cached_program(programs: OrderedDict, key, make):
    """The program of ``key`` in ``programs`` (least recently used first;
    a :class:`GraphedProgram` or a :class:`CardPrograms`), made by
    ``make()`` when absent and made the most recent; beyond
    ``MAX_PROGRAMS`` the least recently used one's graphs and memory pools
    are released and it is dropped."""
    program = programs.pop(key, None)
    if program is None:
        program = make()
    programs[key] = program
    if len(programs) > MAX_PROGRAMS:
        programs.popitem(last=False)[1].release()
    return program


def run_copied(program: GraphedProgram, *xs) -> torch.Tensor:
    """``program(*xs)``, a replay's output copied on the device: the
    program's next replay overwrites its own output, so every caller gets
    a fresh tensor, as JAX hands out a fresh buffer per call."""
    out = program(*xs)
    return out.clone() if program.captured else out


def make_graphed_upscaler(gen1, gen2, up_res: int, stage: int | None = None,
                          chunk: int = 0, gen3=None,
                          devices=None) -> GraphedUpscaler:
    """:func:`upscale_volume` over the chain as one device program per
    input shape: the counterpart of ``make_jitted_upscaler``
    (``mpgan_tpu/infer/assemble.py:219-246``), whose ``jax.jit`` compiles
    one program per shape and dtype.

    → ``upscale(lr)``: ``lr`` (Z, Y, X, C), a tensor on the host or the
    generators' card (or an array), → a fresh (Z·s, Y·s, X·s, 1) tensor on
    the card, under inference mode. Per ``(shape, dtype)`` a
    :class:`GraphedProgram`: eager at its first use, captured at its
    second, replayed after; each replay's output is copied out on the
    device (one 32 MB copy at 256³ bf16), so no returned tensor is ever
    overwritten by a later call. The cache keeps the ``MAX_PROGRAMS`` (2)
    most recently used shapes; using a third releases the least recently
    used one's graph and memory pool (2.33 GB each at 64³→256³ bf16 on
    an H100), and that shape starts again from an eager use. ``devices``
    may repeat the generators' card (one capture holds both shares). Over
    distinct cards each card's share of each pass is its own program
    (:class:`CardPrograms`, the shapes of ``MAX_PROGRAMS`` inputs kept per
    card), and the gather and the steps between the passes run eagerly on
    the first card; each call returns a fresh tensor there too. A device
    without CUDA graphs (the CPU) raises ``ValueError``."""
    return GraphedUpscaler(gen1, gen2, up_res, stage=stage, chunk=chunk,
                           gen3=gen3, devices=devices)


def _sweep(fn, lr_vols: torch.Tensor, modules, devices) -> torch.Tensor:
    """``fn(volume, programs=None)`` over each volume of ``lr_vols`` under
    inference mode, each result cast to float32 into one output tensor
    allocated once (as the JAX package's single-allocation ``lax.map``: a
    list and a stack would hold the sweep twice). Where it can
    (:func:`graphable`), ``fn`` replays, since the volumes share one shape
    (JAX's one ``jit(lax.map)``): on one card as one
    :class:`GraphedProgram`, over distinct cards each card's shares as
    :class:`CardPrograms`; released at the end."""
    program, one = None, fn
    if graphable(lr_vols.device, devices):
        if spans_cards(devices):
            program = CardPrograms()
            one = lambda v: fn(v, program)  # noqa: E731
        else:
            program = one = GraphedProgram(fn, modules, lr_vols.device)
    n = lr_vols.shape[0]
    try:
        with torch.inference_mode():
            first = one(lr_vols[0])
        # allocated outside inference mode: the sweep feeds training, where
        # an inference tensor could not take part in autograd
        out = torch.empty((n, *first.shape), dtype=torch.float32,
                          device=first.device)
        with torch.inference_mode():
            out[0] = first
            for i in range(1, n):
                out[i] = one(lr_vols[i])
    finally:
        if program is not None:
            program.release()
    return out


def precompute_intermediates(gen1, lr_vols: torch.Tensor,
                             stage: int | None = None, chunk: int = 0,
                             devices=None) -> torch.Tensor:
    """Frozen-G1 sweep over a dataset: (N, Z, Y, X, C) LR volumes →
    (N, Z, Y·s, X·s, 1) float32 intermediate volumes, the pass-2 training
    inputs when G2 trains on G1 outputs (JAX ``:245-261``)."""
    return _sweep(lambda v, programs=None: pass1_volume(
        gen1, v, stage=stage, chunk=chunk, devices=devices,
        programs=programs), lr_vols, (gen1,), devices)


def precompute_finals(gen1, gen2, lr_vols: torch.Tensor, up_res: int,
                      chunk: int = 0, devices=None) -> torch.Tensor:
    """Frozen two-pass sweep: (N, Z, Y, X, C) LR → (N, Z·s, Y·s, X·s, 1)
    float32 full-res volumes, the pass-3 training inputs (JAX
    ``:264-275``)."""
    return _sweep(lambda v, programs=None: upscale_volume(
        gen1, gen2, v, up_res, chunk=chunk, devices=devices,
        programs=programs), lr_vols, (gen1, gen2), devices)


def psnr_volume(fake, real, peak: float = 1.0) -> float:
    """PSNR in float32 of two volumes (numpy arrays or tensors)."""
    def f32(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a).astype(np.float32, copy=False)
    mse = float(np.mean((f32(fake) - f32(real)) ** 2))
    return float(10.0 * np.log10(peak ** 2 / max(mse, 1e-12)))
