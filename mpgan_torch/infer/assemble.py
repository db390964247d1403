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
The streamed assembly's chunks run eagerly (JAX jits its ``chunk_fn``):
the host's fetch of each chunk bounds that path, and a capture made anew
per call costs more than its replays save.
"""

from __future__ import annotations

import copy
import itertools
import weakref
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

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


def _per_device(gen, devices, **kw):
    """The per-slice call of ``gen``: on the replica of the slices' device
    when a device list is given."""
    if devices is None or len(devices) <= 1:
        return lambda x: gen(x, **kw)
    return lambda x: replica(gen, x.device)(x, **kw)


def _split_apply(apply_fn, x: torch.Tensor, devices) -> torch.Tensor:
    """``apply_fn`` over ``x`` split into one contiguous block per device;
    every launch is enqueued before any result is gathered, so the
    devices overlap."""
    outs = [apply_fn(part.to(dev, non_blocking=True))
            for part, dev in zip(torch.tensor_split(x, len(devices)),
                                 devices) if part.shape[0]]
    return torch.cat([o.to(devices[0], non_blocking=True) for o in outs])


def apply_sliced(apply_fn, slices: torch.Tensor, chunk: int = 0,
                 devices=None) -> torch.Tensor:
    """Run a per-slice model over a (N, H, W, C) slice stack.

    chunk = 0 → one batch; otherwise fixed-size chunks, the last one
    zero-padded to the chunk size and trimmed (every call sees one shape),
    written into one preallocated output. ``devices`` (a list, which may
    repeat a device) splits each batch over the devices; ``apply_fn`` then
    takes slices on any of them (:func:`replica`) and the result lies on
    the first.
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
                 chunk: int = 0, devices=None) -> torch.Tensor:
    """(Z, Y, X, C) → intermediate (Z, Y·s, X·s, 1) via xy slices."""
    return apply_sliced(_per_device(gen1, devices, stage=stage), lr_vol,
                        chunk, devices)


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
                 devices=None) -> torch.Tensor:
    """Intermediate (Z, Ys, Xs, 1) [+ LR velocity (Z, Y, X, 3)] →
    final (Z·s, Ys, Xs, 1) via xz slices (z-axis refinement)."""
    vol_in = _with_velocity(interm, lr_vel, [0, 2, 1], gen2.dtype)
    slices = vol_in.permute(1, 0, 2, 3)              # (Ys, Z, Xs, C)
    out = apply_sliced(_per_device(gen2, devices, stage=stage), slices,
                       chunk, devices)
    return out.permute(1, 0, 2, 3)                   # (Zs, Ys, Xs, 1)


def pass3_volume(gen3, vol: torch.Tensor, lr_vel: torch.Tensor | None,
                 chunk: int = 0, devices=None) -> torch.Tensor:
    """Constant-resolution refinement over yz slices of the full-res volume
    (Zs, Ys, Xs, 1); slice channels [d, v_w=vz, v_h=vy, v_out=vx]."""
    vol_in = _with_velocity(vol, lr_vel, [2, 1, 0], gen3.dtype)
    slices = vol_in.permute(2, 1, 0, 3)              # (Xs, Ys, Zs, C)
    out = apply_sliced(_per_device(gen3, devices), slices, chunk, devices)
    return out.permute(2, 1, 0, 3)


def upscale_volume(gen1, gen2, lr_vol: torch.Tensor, up_res: int,
                   stage: int | None = None, chunk: int = 0,
                   gen3=None, devices=None) -> torch.Tensor:
    """Full multi-pass SR: (Z, Y, X, C) LR → (Z·s, Y·s, X·s, 1) HR density.

    lr_vol channels [d, vx, vy, vz] (or density only). Z = 1 (2D data)
    returns the pass-1 output. gen2=None → pass 1 with a nearest z-repeat
    standing in for pass 2; a pass-3 refiner still runs after it.
    ``devices`` splits every pass's slices over a device list.
    """
    interm = pass1_volume(gen1, lr_vol, stage=stage, chunk=chunk,
                          devices=devices)
    if lr_vol.shape[0] == 1:
        return interm
    lr_vel = lr_vol[..., 1:4] if lr_vol.shape[-1] >= 4 else None
    if gen2 is None:
        out = interm.repeat_interleave(up_res, dim=0)
    else:
        out = pass2_volume(gen2, interm, lr_vel, stage=stage, chunk=chunk,
                           devices=devices)
    if gen3 is not None:
        out = pass3_volume(gen3, out, lr_vel, chunk=chunk, devices=devices)
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
    """Whether calls on ``device`` (split over ``devices``) can run as one
    captured program: CUDA graphs exist there, and the device list names
    one card (a list that repeats it included: one capture holds every
    share). A capture lives on one device, and a split over distinct
    cards copies between them."""
    return graphed.Graph.available(device) and (
        devices is None or len({canonical(d) for d in devices}) == 1)


class GraphedProgram:
    """``fn(*xs)`` for inputs of one shape and dtype each as one captured
    CUDA graph (:class:`mpgan_torch.train.graphed.Graph`), by the rule of
    the train step's :class:`~mpgan_torch.train.graphed.Program`: the
    first use runs ``fn`` eagerly (the warm-up: cuDNN's algorithm choice,
    the upsample weights, replicas), the second copies each input into the
    program's static inputs (``xs``, contiguous, on ``device``) and
    captures, every later use copies in and replays. From the second use
    on, ``program(*xs)`` returns the graph's static output, which the next
    replay overwrites: a caller that keeps it copies it first
    (:func:`make_graphed_upscaler`). An input may be None (a pass without
    velocity); the captured function then gets None there too.

    An input may lie on the host. A replay raises ``RuntimeError`` when a
    parameter or buffer of ``modules`` no longer lies where it lay at the
    capture (a module moved or its tensors replaced: the graph would read
    the old storage); values changed in place are read by the replay."""

    def __init__(self, fn, modules, device):
        self.fn = fn
        self.modules = [m for m in modules if m is not None]
        self.device = canonical(device)
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
            self.xs = [None if x is None else torch.empty(
                x.shape, dtype=x.dtype, device=self.device) for x in xs]
            self._fill(xs)
            self.storage = self._storage()
            self.graph = graphed.Graph(lambda: self.fn(*self.xs),
                                       self.device)
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


class GraphedUpscaler:
    """``lr (Z, Y, X, C) → HR (Z·s, Y·s, X·s, 1)`` over a pass chain, one
    :class:`GraphedProgram` per ``(input shape, dtype)``
    (:func:`make_graphed_upscaler`)."""

    def __init__(self, gen1, gen2, up_res: int, stage: int | None = None,
                 chunk: int = 0, gen3=None, devices=None):
        self.device = canonical(next(gen1.parameters()).device)
        if not graphable(self.device, devices):
            raise ValueError(
                f"a graphed upscaler runs on one CUDA card; got {self.device}"
                f" split over {devices}")
        self.modules = (gen1, gen2, gen3)

        def fn(lr_vol):
            return upscale_volume(gen1, gen2, lr_vol, up_res, stage=stage,
                                  chunk=chunk, gen3=gen3, devices=devices)
        self.fn = fn
        # least recently used first
        self.programs: OrderedDict[tuple, GraphedProgram] = OrderedDict()

    def __call__(self, lr_vol) -> torch.Tensor:
        lr_vol = torch.as_tensor(lr_vol)
        program = cached_program(
            self.programs, (tuple(lr_vol.shape), lr_vol.dtype),
            lambda: GraphedProgram(self.fn, self.modules, self.device))
        with torch.inference_mode():
            # a server fetches a result outside its device lock, while the
            # next request may replay
            return run_copied(program, lr_vol)


def cached_program(programs: OrderedDict, key, make) -> GraphedProgram:
    """The program of ``key`` in ``programs`` (least recently used first),
    made by ``make()`` when absent and made the most recent; beyond
    ``MAX_PROGRAMS`` the least recently used one's graph and memory pool
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
    an H100), and that shape starts again from an eager use. ``devices`` may repeat the generators' card (one capture holds
    both shares); distinct cards raise ``ValueError``, since a capture
    lives on one device: there :func:`upscale_volume` runs eagerly."""
    return GraphedUpscaler(gen1, gen2, up_res, stage=stage, chunk=chunk,
                           gen3=gen3, devices=devices)


def _sweep(fn, lr_vols: torch.Tensor, modules, devices) -> torch.Tensor:
    """``fn`` over each volume of ``lr_vols`` under inference mode, each
    result cast to float32 into one output tensor allocated once (as the
    JAX package's single-allocation ``lax.map``: a list and a stack would
    hold the sweep twice). Where it can (:func:`graphable`), ``fn`` is one
    :class:`GraphedProgram` replayed over every volume, since they share
    one shape (JAX's one ``jit(lax.map)``), released at the end."""
    program = (GraphedProgram(fn, modules, lr_vols.device)
               if graphable(lr_vols.device, devices) else None)
    one = program or fn
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
    return _sweep(lambda v: pass1_volume(gen1, v, stage=stage, chunk=chunk,
                                         devices=devices), lr_vols, (gen1,),
                  devices)


def precompute_finals(gen1, gen2, lr_vols: torch.Tensor, up_res: int,
                      chunk: int = 0, devices=None) -> torch.Tensor:
    """Frozen two-pass sweep: (N, Z, Y, X, C) LR → (N, Z·s, Y·s, X·s, 1)
    float32 full-res volumes, the pass-3 training inputs (JAX
    ``:264-275``)."""
    return _sweep(lambda v: upscale_volume(gen1, gen2, v, up_res,
                                           chunk=chunk, devices=devices),
                  lr_vols, (gen1, gen2), devices)


def psnr_volume(fake, real, peak: float = 1.0) -> float:
    """PSNR in float32 of two volumes (numpy arrays or tensors)."""
    def f32(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu", torch.float32).numpy()
        return np.asarray(a).astype(np.float32, copy=False)
    mse = float(np.mean((f32(fake) - f32(real)) ** 2))
    return float(10.0 * np.log10(peak ** 2 / max(mse, 1e-12)))
