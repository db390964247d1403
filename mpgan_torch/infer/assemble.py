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
a CUDA graph per input shape, replayed per call, and each sweep replays one
program over all its volumes; so does each stage of
:class:`mpgan_torch.infer.pipeline.InferencePipeline` on one card. Over
distinct cards a capture cannot hold the call, so each card's share of
each pass is its own program, captured on that card, and the gather,
transposes and velocity resizes between the passes run eagerly on the
first card (the programs: :mod:`mpgan_torch.train.graphed`).
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
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from mpgan_torch import tracing
from mpgan_torch.ops.upsample import resize_volume
from mpgan_torch.parallel.mesh import canonical
from mpgan_torch.train import graphed

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


def _per_device(gen, devices, programs=None, **kw):
    """The per-slice call of ``gen``. With a device list, the call of one
    device's share ``(x, device)``: on the replica of ``gen`` on that
    device, or, given ``programs`` (a ``graphed.CardPrograms``), as that
    card's captured program."""
    if devices is None or len(devices) <= 1:
        return lambda x: gen(x, **kw)
    if programs is not None:
        return lambda x, dev: programs.share(gen, kw, x, dev,
                                             replica(gen, dev))
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
    device = None if graphed.spans_cards(devices) else vol.device
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
    ``programs`` (a ``graphed.CardPrograms``) replays each card's share of
    a split over distinct cards."""
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
    ``programs`` (a ``graphed.CardPrograms``) replays each card's shares.
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


class GraphedUpscaler:
    """``lr (Z, Y, X, C) → HR (Z·s, Y·s, X·s, 1)`` over a pass chain, its
    programs by ``(input shape, dtype)`` in a ``graphed.ProgramCache``
    (:func:`make_graphed_upscaler`)."""

    def __init__(self, gen1, gen2, up_res: int, stage: int | None = None,
                 chunk: int = 0, gen3=None, devices=None):
        self.device = canonical(next(gen1.parameters()).device)
        if not graphed.graphable(self.device, devices):
            raise ValueError(
                "a graphed upscaler captures each program on one CUDA card; "
                f"got {self.device} split over {devices}")
        self.modules = tuple(g for g in (gen1, gen2, gen3) if g is not None)

        def fn(lr_vol, programs=None):
            return upscale_volume(gen1, gen2, lr_vol, up_res, stage=stage,
                                  chunk=chunk, gen3=gen3, devices=devices,
                                  programs=programs)
        self.fn = fn
        self.programs = graphed.ProgramCache(self.device, devices)

    def __call__(self, lr_vol) -> torch.Tensor:
        with tracing.span("upscale.frame", self.device):
            return self._call(lr_vol)

    def _call(self, lr_vol) -> torch.Tensor:
        lr_vol = torch.as_tensor(lr_vol)
        with torch.inference_mode():
            # a fresh tensor per call: a server fetches a result outside
            # its device lock, while the next request may replay
            return self.programs.run((tuple(lr_vol.shape), lr_vol.dtype),
                                     self.fn, self.modules, lr_vol)


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
    ``graphed.GraphedProgram``: eager at its first use, captured at its
    second, replayed after; each replay's output is copied out on the
    device (one 32 MB copy at 256³ bf16), so no returned tensor is ever
    overwritten by a later call. The cache keeps the ``MAX_PROGRAMS`` (2)
    most recently used shapes; using a third releases the least recently
    used one's graph and memory pool (2.33 GB each at 64³→256³ bf16 on
    an H100), and that shape starts again from an eager use. ``devices``
    may repeat the generators' card (one capture holds both shares). Over
    distinct cards each card's share of each pass is its own program
    (``graphed.CardPrograms``, the shapes of ``MAX_PROGRAMS`` inputs kept
    per card), and the gather and the steps between the passes run
    eagerly on the first card; each call returns a fresh tensor there
    too. A device without CUDA graphs (the CPU) raises ``ValueError``."""
    return GraphedUpscaler(gen1, gen2, up_res, stage=stage, chunk=chunk,
                           gen3=gen3, devices=devices)


def _sweep(fn, lr_vols: torch.Tensor, modules, devices) -> torch.Tensor:
    """``fn(volume, programs=None)`` over each volume of ``lr_vols`` under
    inference mode, each result cast to float32 into one output tensor
    allocated once (as the JAX package's single-allocation ``lax.map``: a
    list and a stack would hold the sweep twice). Where it can, ``fn``
    replays as one key's programs, since the volumes share one shape
    (JAX's one ``jit(lax.map)``), released at the end; each result goes
    into the output at once, so a replay's is not copied out first."""
    programs, one = None, fn
    if graphed.graphable(lr_vols.device, devices):
        programs = graphed.ProgramCache(lr_vols.device, devices)
        one = lambda v: programs.run(None, fn, modules, v,  # noqa: E731
                                     copied=False)
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
        if programs is not None:
            programs.release()
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
