"""The semi-Lagrangian warp as CUDA kernels, with their plain versions and
differentiable wrappers.

Counterpart of ``mpgan_tpu/ops/warp_pallas.py``; ``csrc/warp.cu`` holds the
kernels (see the note at its top for the bounds and the design):

- :func:`advect_2d_kernel` launches the single-field warp, the counterpart
  of the TPU kernel ``advect_2d_pallas``;
- :func:`align_triplet_kernel` launches the fused alignment of a triplet,
  ``[warp(prev, +1), cur, warp(nxt, −1)]`` in one launch, which is what
  ``align_triplet(use_pallas=True)`` computes with two kernel calls and a
  concatenation;
- :func:`advect_2d_kernel_bwd` and :func:`align_triplet_kernel_bwd` launch
  the backward kernel (the VJP of the JAX ``custom_vjp``), for one field or
  for both fields of a triplet.

:func:`advect_2d_clamped_ref` is the plain PyTorch version of the warp (the
JAX package's ``_clamped_xla_reference``); its autograd is the plain
version of the backward. :func:`advect_2d_fast` and
:func:`align_triplet_fast` are the differentiable entry points: kernels
both ways for CUDA tensors (:class:`AdvectFast`, :class:`AlignTripletFast`),
the plain version and its autograd for CPU tensors. There is no fallback:
on CUDA tensors a failed build or launch raises.

The forward wrappers make one call into C++ per launch: each calls an
operator registered with PyTorch's dispatcher (``csrc/warp_ops.cpp``,
``torch.ops.mpgan_warp``, built against the stable ABI and loaded at first
use by :func:`mpgan_torch._build.load_ops`), which checks the tensors,
allocates the output and launches on the current stream, as
``grid_sample`` does. The wrapper picks the tile (:func:`fwd_tile`: 32x64
tiles with staged windows at bandwidth-bound shapes, one thread per pixel
at latency-bound ones such as the trainer's) and, when the operator
refuses its inputs, finds which and raises the ``ValueError``
(:func:`_refuse`). A CPU tensor is refused before the operator is built.
The backwards stay on ctypes: one pass of checks over the tensors (the
detailed checks with their messages run only for what is refused),
outputs from ``new_empty``, the current stream's raw handle from
``torch._C._cuda_getCurrentRawStream``
(``torch.cuda.current_stream(...).cuda_stream`` where torch lacks it,
decided once at import; :data:`STREAM_SOURCE` says which), and the device
made current inside the C entry only when it is not. The backward's tile is
chosen here (:func:`bwd_tile`); its gradients are fixed-point sums, the
same bits on every call (the note at the top of ``csrc/warp.cu``).
Each backward of :class:`AdvectFast` and :class:`AlignTripletFast` is a
span, ``warp.bwd`` (:mod:`mpgan_torch.tracing`).
"""

from __future__ import annotations

import functools

import torch

from mpgan_torch import _build, tracing
from mpgan_torch.ops.warp import advect_2d

# Cells; per-frame backtrace bound, shared with LossConfig.warp_max_disp.
DEFAULT_MAX_DISP = 8

# Kernel launches since the last reset, incremented only where a kernel is
# launched: forward kernels (single-field and triplet) and backward
# kernels. A CUDA graph's replay launches the kernels it captured and adds
# them here; its capture, which records them without launching, leaves
# the counts as they were (mpgan_torch.train.graphed). chip_smoke.py
# resets them before driving each path.
launches = 0
bwd_launches = 0

_lib = None
_ops = None  # the forward operators' builtins, once loaded

# the text of the operators' refusal (csrc/warp_ops.cpp kRefused)
REFUSED = "mpgan_warp: inputs refused"


def _kernels():
    """The warp library, built and loaded at first use."""
    global _lib
    if _lib is None:
        _lib = _build.load("warp")
    return _lib


def _operators():
    """(warp2d, warp2d_triplet): the forward operators as the builtins that
    ``torch.ops.mpgan_warp.<name>.default`` calls, built, linked to the warp
    library and registered with PyTorch's dispatcher at first use."""
    global _ops
    if _ops is None:
        _build.load_ops("warp_ops")
        ns = torch.ops.mpgan_warp
        _ops = (ns.warp2d.default._op, ns.warp2d_triplet.default._op)
    return _ops


def _clamp_limit(dt: float, max_disp: int) -> float:
    """The velocity clamp ±max_disp/|dt| of the plain version."""
    return max_disp / max(abs(dt), 1e-9)


def advect_2d_clamped_ref(field: torch.Tensor, vel: torch.Tensor,
                          dt: float = 1.0,
                          max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Plain warp with the kernel's displacement clamp: velocity clipped to
    ±max_disp/|dt|, then :func:`mpgan_torch.ops.warp.advect_2d`."""
    lim = _clamp_limit(dt, max_disp)
    return advect_2d(field, vel.clamp(-lim, lim), dt)


def align_triplet_ref(prev: torch.Tensor, cur: torch.Tensor,
                      nxt: torch.Tensor, vel: torch.Tensor,
                      max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Plain version of :func:`align_triplet_kernel`: the clamped warp of
    prev (dt = +1) and nxt (dt = −1), stacked around cur → (B, H, W, 3)."""
    f32 = torch.float32
    return torch.cat([advect_2d_clamped_ref(prev.to(f32), vel, 1.0, max_disp),
                      cur.to(f32),
                      advect_2d_clamped_ref(nxt.to(f32), vel, -1.0, max_disp)],
                     dim=-1)


_F32 = torch.float32

# the raw handle of the current stream of a device index, decided once
if hasattr(torch._C, "_cuda_getCurrentRawStream"):
    _stream = torch._C._cuda_getCurrentRawStream
    STREAM_SOURCE = "torch._C._cuda_getCurrentRawStream"
else:
    def _stream(index: int) -> int:
        return torch.cuda.current_stream(index).cuda_stream
    STREAM_SOURCE = "torch.cuda.current_stream"

# The forwards' tile (rows, columns), taken where the batch gives at least
# FWD_MIN_BLOCKS[fields] blocks of it: the bandwidth-bound shapes, several
# waves on an H100's 132 SMs. Elsewhere (0, 0): one thread per pixel, the
# design for latency-bound shapes. The counts are where the tiled kernel
# overtook one thread per pixel on the H100 (PERF.md §6): a triplet's
# tile holds 74 KB of shared memory, three blocks per SM, and needs more
# waves than one field's 33 KB. The width is a power of 2 (16-byte copies
# of whole rows).
FWD_TILE = (32, 64)
FWD_MIN_BLOCKS = {1: 1024, 2: 4096}


@functools.lru_cache(maxsize=64)
def fwd_tile(b: int, h: int, w: int, fields: int) -> tuple[int, int]:
    """The tile (rows, columns) a block of the forward kernel owns for
    ``b`` images of ``h`` x ``w`` and 1 field or a triplet (``fields`` 2,
    prev and nxt), or (0, 0) for one thread per pixel."""
    th, tw = FWD_TILE
    if b * -(-h // th) * -(-w // tw) >= FWD_MIN_BLOCKS[fields]:
        return th, tw
    return 0, 0


@functools.lru_cache(maxsize=64)
def _tile_of(shape: torch.Size, fields: int) -> tuple[int, int]:
    """:func:`fwd_tile` for ``vel.shape``; any tile for a shape the
    operator will refuse."""
    return fwd_tile(*shape[:3], fields) if len(shape) == 4 else (0, 0)


# The backward's tiles (rows, columns) for one field and for a triplet's
# two, largest first: the first that gives at least BWD_MIN_BLOCKS blocks
# (two per SM of an H100) is taken, else the last. A triplet's 64x64
# window would not fit one staged chunk at two blocks per SM, so its
# largest tile is 32x64.
BWD_TILES = {1: ((64, 64), (16, 32)), 2: ((32, 64), (16, 32))}
BWD_MIN_BLOCKS = 2 * 132


@functools.lru_cache(maxsize=64)
def bwd_tile(b: int, h: int, w: int, fields: int) -> tuple[int, int]:
    """The tile (rows, columns) a block of the backward kernel owns for
    ``b`` images of ``h`` x ``w`` and 1 or 2 ``fields``."""
    tiles = BWD_TILES[fields]
    for th, tw in tiles:
        if b * -(-h // th) * -(-w // tw) >= BWD_MIN_BLOCKS:
            return th, tw
    return tiles[-1]


def _refuse(name: str, vel: torch.Tensor, fields, names) -> None:
    """Raise the error that :func:`_check` found: ``vel`` (B, H, W, 2) and
    every field (B, H, W, 1) must be contiguous float32 tensors on one CUDA
    device."""
    dev = vel.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got vel on {dev}")
    if vel.dim() != 4 or vel.shape[-1] != 2:
        raise ValueError(f"vel must be (B, H, W, 2), got {tuple(vel.shape)}")
    b, h, w, _ = vel.shape
    for k, t in zip((*names, "vel"), (*fields, vel)):
        if t.device != dev or t.dtype != _F32:
            raise ValueError(f"{name} needs float32 tensors on {dev}, got "
                             f"{k} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
        if k != "vel" and t.shape != (b, h, w, 1):
            raise ValueError(f"{k} must be {(b, h, w, 1)}, got "
                             f"{tuple(t.shape)}")
    if 3 * b * h * w >= 2 ** 31 or b > 65535:
        raise ValueError(f"{b}x{h}x{w} pixels exceed the kernel's indices")
    if vel.data_ptr() % 8:
        raise ValueError("vel must be 8-byte aligned (read as float2)")
    raise ValueError(f"{name}: inputs the kernel does not take")


def _check(name: str, vel: torch.Tensor, fields, names):
    """(B, H, W, device index) of ``vel`` (B, H, W, 2); raises (through
    :func:`_refuse`) unless ``vel`` and every field (B, H, W, 1) are
    contiguous float32 tensors on one CUDA device."""
    shape = vel.shape
    if (not vel.is_cuda or vel.dtype is not _F32 or len(shape) != 4
            or shape[3] != 2 or not vel.is_contiguous()
            or vel.data_ptr() % 8):
        _refuse(name, vel, fields, names)
    b, h, w, _ = shape
    dev = vel.get_device()
    want = (b, h, w, 1)
    for t in fields:
        if (not t.is_cuda or t.get_device() != dev or t.dtype is not _F32
                or t.shape != want or not t.is_contiguous()):
            _refuse(name, vel, fields, names)
    if 3 * b * h * w >= 2 ** 31 or b > 65535:
        _refuse(name, vel, fields, names)
    return b, h, w, dev


def _check_grad(g: torch.Tensor, shape: tuple, vel: torch.Tensor) -> None:
    if (not g.is_cuda or g.get_device() != vel.get_device()
            or g.dtype is not _F32 or g.shape != shape):
        raise ValueError(f"the gradient must be float32 {shape} on "
                         f"{vel.device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")


def _failed(fn, err: int) -> None:
    raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _load(name: str, vel: torch.Tensor, fields, names):
    """The forward operators, loaded at a wrapper's first call; a CPU
    ``vel`` is refused before anything is built."""
    if not vel.is_cuda:
        _refuse(name, vel, fields, names)
    return _operators()


def advect_2d_kernel(field: torch.Tensor, vel: torch.Tensor, dt: float = 1.0,
                     max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Launch the CUDA warp: field (B, H, W, 1), vel (B, H, W, 2) as
    (v_w, v_h), contiguous float32 on one CUDA device → (B, H, W, 1)
    float32. Raises on anything the kernel does not take."""
    global launches
    ops = _ops or _load("advect_2d_kernel", vel, (field,), ("field",))
    try:
        out = ops[0](field, vel, float(dt), int(max_disp),
                     *_tile_of(vel.shape, 1))
    except RuntimeError as e:  # a refusal, or no CUDA tensor among them
        if not (REFUSED in str(e) or isinstance(e, NotImplementedError)):
            raise
        _refuse("advect_2d_kernel", vel, (field,), ("field",))
    launches += 1
    return out


def advect_2d_kernel_bwd(g: torch.Tensor, field: torch.Tensor,
                         vel: torch.Tensor, dt: float = 1.0,
                         max_disp: int = DEFAULT_MAX_DISP,
                         field_grad: bool = True, vel_grad: bool = False):
    """Launch the backward kernel of :func:`advect_2d_kernel` for the
    gradient ``g`` (B, H, W, 1) float32 of any strides → (d_field, d_vel),
    each None unless asked for. The same inputs give the same bits."""
    global bwd_launches
    b, h, w, dev = _check("advect_2d_kernel_bwd", vel, (field,), ("field",))
    _check_grad(g, (b, h, w, 1), vel)
    if not (field_grad or vel_grad):
        return None, None
    d_field = vel.new_empty((b, h, w, 1)) if field_grad else None
    d_vel = vel.new_empty((b, h, w, 2)) if vel_grad else None
    sb, sy, sx, _ = g.stride()
    th, tw = bwd_tile(b, h, w, 1)
    fn = _kernels().mpgan_warp2d_bwd
    err = fn(g.data_ptr(), sb, sy, sx, field.data_ptr(), vel.data_ptr(),
             d_field.data_ptr() if field_grad else None,
             d_vel.data_ptr() if vel_grad else None, b, h, w, th, tw,
             float(dt), _clamp_limit(dt, max_disp), dev, _stream(dev))
    if err:
        _failed(fn, err)
    bwd_launches += 1
    return d_field, d_vel


def align_triplet_kernel(prev: torch.Tensor, cur: torch.Tensor,
                         nxt: torch.Tensor, vel: torch.Tensor,
                         max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Launch the fused triplet warp: prev, cur, nxt (B, H, W, 1) and vel
    (B, H, W, 2) as (v_w, v_h), contiguous float32 on one CUDA device →
    (B, H, W, 3) float32 ``[warp(prev, +1), cur, warp(nxt, −1)]``, the
    displacement clamped to ±max_disp. Raises on anything the kernel does
    not take."""
    global launches
    names = ("prev", "cur", "nxt")
    ops = _ops or _load("align_triplet_kernel", vel, (prev, cur, nxt), names)
    try:
        out = ops[1](prev, cur, nxt, vel, int(max_disp),
                     *_tile_of(vel.shape, 2))
    except RuntimeError as e:  # a refusal, or no CUDA tensor among them
        if not (REFUSED in str(e) or isinstance(e, NotImplementedError)):
            raise
        _refuse("align_triplet_kernel", vel, (prev, cur, nxt), names)
    launches += 1
    return out


def align_triplet_kernel_bwd(g: torch.Tensor, prev: torch.Tensor,
                             nxt: torch.Tensor, vel: torch.Tensor,
                             max_disp: int = DEFAULT_MAX_DISP,
                             field_grads: bool = True,
                             vel_grad: bool = False):
    """Launch the backward kernel of :func:`align_triplet_kernel` for the
    gradient ``g`` (B, H, W, 3) float32 of any strides → (d_prev, d_nxt,
    d_vel), None where not asked for (d_prev and d_nxt together). The
    gradient of cur is ``g[..., 1:2]`` and needs no launch. The same inputs
    give the same bits."""
    global bwd_launches
    b, h, w, dev = _check("align_triplet_kernel_bwd", vel, (prev, nxt),
                          ("prev", "nxt"))
    _check_grad(g, (b, h, w, 3), vel)
    d_prev = d_nxt = d_vel = None
    if not (field_grads or vel_grad):
        return d_prev, d_nxt, d_vel
    if field_grads:  # both planes in one allocation
        d_prev, d_nxt = vel.new_empty((2, b, h, w, 1)).unbind()
    if vel_grad:
        d_vel = vel.new_empty((b, h, w, 2))
    sb, sy, sx, sc = g.stride()
    th, tw = bwd_tile(b, h, w, 2)
    fn = _kernels().mpgan_warp2d_triplet_bwd
    err = fn(g.data_ptr(), sb, sy, sx, sc, prev.data_ptr(), nxt.data_ptr(),
             vel.data_ptr(), d_prev.data_ptr() if field_grads else None,
             d_nxt.data_ptr() if field_grads else None,
             d_vel.data_ptr() if vel_grad else None, b, h, w, th, tw,
             float(max_disp), dev, _stream(dev))
    if err:
        _failed(fn, err)
    bwd_launches += 1
    return d_prev, d_nxt, d_vel


class AdvectFast(torch.autograd.Function):
    """The single-field warp on CUDA tensors: the forward kernel, and the
    backward kernel for the gradient."""

    @staticmethod
    def forward(ctx, field, vel, dt, max_disp):
        field, vel = field.to(torch.float32).contiguous(), vel.contiguous()
        ctx.save_for_backward(field, vel)
        ctx.dt, ctx.max_disp = dt, max_disp
        return advect_2d_kernel(field, vel, dt, max_disp)

    @staticmethod
    def backward(ctx, g):
        field, vel = ctx.saved_tensors
        need_f, need_v = ctx.needs_input_grad[:2]
        with tracing.span("warp.bwd"):
            gf, gv = advect_2d_kernel_bwd(g, field, vel, ctx.dt,
                                          ctx.max_disp, need_f, need_v)
        return gf, gv, None, None


def advect_2d_fast(field: torch.Tensor, vel: torch.Tensor, dt: float = 1.0,
                   max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Differentiable clamped warp (B, H, W, 1) × (B, H, W, 2) → (B, H, W, 1)
    float32: the kernels for CUDA tensors, the plain version and its
    autograd for CPU ones."""
    if field.device.type == "cpu":
        return advect_2d_clamped_ref(field.to(torch.float32), vel, dt,
                                     max_disp)
    return AdvectFast.apply(field, vel, float(dt), int(max_disp))


class AlignTripletFast(torch.autograd.Function):
    """The triplet alignment on CUDA tensors: the fused forward kernel, and
    the backward kernel for the gradients of prev, nxt and vel (cur's is a
    view of the incoming gradient)."""

    @staticmethod
    def forward(ctx, prev, cur, nxt, vel, max_disp):
        prev, cur, nxt, vel = (t.contiguous() for t in (prev, cur, nxt, vel))
        ctx.save_for_backward(prev, nxt, vel)
        ctx.max_disp = max_disp
        return align_triplet_kernel(prev, cur, nxt, vel, max_disp)

    @staticmethod
    def backward(ctx, g):
        prev, nxt, vel = ctx.saved_tensors
        need_p, need_c, need_n, need_v = ctx.needs_input_grad[:4]
        with tracing.span("warp.bwd"):
            d_prev, d_nxt, d_vel = align_triplet_kernel_bwd(
                g, prev, nxt, vel, ctx.max_disp, need_p or need_n, need_v)
        return (d_prev if need_p else None,
                g[..., 1:2] if need_c else None,
                d_nxt if need_n else None, d_vel, None)


def align_triplet_fast(prev: torch.Tensor, cur: torch.Tensor,
                       nxt: torch.Tensor, vel: torch.Tensor,
                       max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Differentiable ``[warp(prev, +1), cur, warp(nxt, −1)]`` →
    (B, H, W, 3) float32, displacement clamped to ±max_disp: one forward
    and one backward kernel for CUDA tensors, the plain version
    (:func:`align_triplet_ref`) and its autograd for CPU ones."""
    if vel.device.type == "cpu":
        return align_triplet_ref(prev, cur, nxt, vel, max_disp)
    return AlignTripletFast.apply(prev, cur, nxt, vel, int(max_disp))
