"""The slice generator's convolutions as CUDA kernels over NHWC
activations, with their epilogues, and their plain versions.

``csrc/conv.cu`` holds the kernels (see the note at its top: they replace
no Pallas kernel, the JAX package leaves its convolutions to XLA; they
were added because cuDNN's layout copies, bias adds and ReLUs around its
NHWC convolutions took most of a frame's device time; each is bound by
bytes). Each function takes a bf16 NHWC tensor ``(B, H, W, C)`` at any
strides with unit channel stride (pass 2's and pass 3's permuted slice
views are read in place) and the ``nn.Conv2d`` modules whose float32
parameters it applies, rounded to bf16 inside each call, so a replay of a
captured program reads parameters updated in place:

- :func:`conv_relu`: ``relu(conv(x) + b)``, the stem and each ResBlock's
  ``conv1`` (epilogue a);
- :func:`conv_residual`: ``relu(conv2(h) + b2 + skip)``, ``skip`` the
  block's input ``x`` or its 1x1 ``proj`` computed in the same kernel
  (epilogue b);
- :func:`conv_head`: ``conv(h) + b`` with one output channel, plus the
  global density skip (the generator's input density upsampled
  bilinearly), in the output dtype (epilogue c).

The kernels take input widths 4, 8, 16 and 32 and output widths 1, 8, 16
and 32 (:data:`RELU`, :data:`RESIDUAL`, :data:`HEAD`). The plain versions (``*_ref``) compute the same function
in float32 with PyTorch's convolution, the parameters rounded to the
activations' dtype first, and round once; a CPU tensor takes them. A
CUDA tensor launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mpgan_torch import _build
from mpgan_torch.ops.upsample import upsample_nchw

# (input width, output width) of conv_relu's kernels
RELU = frozenset((i, o) for i in (4, 8, 16, 32) for o in (8, 16, 32))
# (width, skip width) of conv_residual's kernels (conv2 keeps its width)
RESIDUAL = frozenset((c, x) for c in (8, 16, 32) for x in (8, 16, 32))
# input widths of conv_head's kernels (one output channel)
HEAD = frozenset((8, 16, 32))

# Kernel launches since the last reset, incremented only where a kernel
# is launched. A CUDA graph's replay launches the kernels it captured and
# adds them here; its capture, which records them without launching,
# leaves the count as it was (mpgan_torch.train.graphed).
launches = 0

_lib = None

_MODE_RELU, _MODE_RESIDUAL, _MODE_HEAD = 0, 1, 2


def _kernels():
    """The conv library, built and loaded at first use."""
    global _lib
    if _lib is None:
        _lib = _build.load("conv")
    return _lib


def _acc(dtype: torch.dtype) -> torch.dtype:
    return (torch.float32 if dtype in (torch.float16, torch.bfloat16)
            else dtype)


def _param(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A parameter rounded to the activations' dtype, in the sum's."""
    return p.to(dtype).to(_acc(dtype))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).to(_acc(x.dtype))


def _conv_ref(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(_nchw(x), _param(conv.weight, x.dtype),
                    _param(conv.bias, x.dtype), padding=conv.padding)


def conv_relu_ref(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Plain version of :func:`conv_relu`."""
    return _conv_ref(x, conv).relu().permute(0, 2, 3, 1).to(x.dtype)


def conv_residual_ref(h: torch.Tensor, conv2: nn.Conv2d, x: torch.Tensor,
                      proj: nn.Conv2d | None) -> torch.Tensor:
    """Plain version of :func:`conv_residual`."""
    skip = _nchw(x) if proj is None else _conv_ref(x, proj)
    return ((_conv_ref(h, conv2) + skip).relu().permute(0, 2, 3, 1)
            .to(h.dtype))


def conv_head_ref(h: torch.Tensor, head: nn.Conv2d,
                  dens: torch.Tensor | None = None,
                  factors: tuple[int, int] = (1, 1),
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of :func:`conv_head`."""
    out = _conv_ref(h, head)
    if dens is not None:
        out = out + upsample_nchw(_nchw(dens), *factors)
    return out.permute(0, 2, 3, 1).to(out_dtype)


def _aligned(t: torch.Tensor, elems: int) -> bool:
    """Whether the kernel's copies of ``elems`` bf16 values can read ``t``:
    unit channel stride, the base and the other strides on their size."""
    return (t.stride(-1) == 1 and t.data_ptr() % (2 * elems) == 0
            and all(s % elems == 0 for s in t.stride()[:-1]))


def _readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it in place, else a
    contiguous copy."""
    if _aligned(t, 8 if t.shape[-1] >= 8 else 4):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _check(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"{name} needs a (B, H, W, C) bfloat16 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _launch(mode: int, x: torch.Tensor, conv: nn.Conv2d, out: torch.Tensor,
            skip: torch.Tensor | None = None, proj: nn.Conv2d | None = None,
            dens_hw: tuple[int, int] = (0, 0),
            slice_major: torch.Tensor | None = None) -> torch.Tensor:
    global launches
    b, h, w, cin = x.shape
    cout = conv.out_channels
    wt = conv.weight.detach().float().contiguous()
    bias = conv.bias.detach().float().contiguous()
    cx, ks, wp, bp = 0, (0, 0, 0), None, None
    if skip is not None:
        cx, ks = skip.shape[-1], skip.stride()[:3]
        if mode == _MODE_HEAD:
            cx = 0
    if proj is not None:
        wp = proj.weight.detach().float().contiguous()
        bp = proj.bias.detach().float().contiguous()
    for t in (wt, bias, wp, bp, skip):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv kernels need every tensor on {x.device}, "
                             f"got one on {t.device}")
    # tiles slice-fastest where the strided input's slices lie closer than
    # its pixels (pass 3's yz slices)
    sm = slice_major if slice_major is not None else x
    slice_fastest = int(abs(sm.stride(0)) < abs(sm.stride(2)))
    dev = x.device
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _kernels().mpgan_conv(
        mode, cin, cout if mode != _MODE_HEAD else 1, cx,
        x.data_ptr(), *x.stride()[:3], b, h, w, wt.data_ptr(),
        bias.data_ptr(), ptr(skip), *ks, ptr(wp), ptr(bp), *dens_hw,
        out.data_ptr(), int(out.dtype == torch.float32), slice_fastest,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err == -1:
        raise ValueError(f"no conv kernel for mode {mode}, widths "
                         f"{cin} -> {cout} (skip {cx})")
    if err != 0:
        raise RuntimeError(f"mpgan_conv launch failed: CUDA error {err}")
    launches += 1
    return out


def conv_relu(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``relu(conv(x) + b)`` → a contiguous ``(B, H, W, C_out)`` tensor in
    ``x``'s dtype: a kernel for a CUDA tensor (bf16, widths in
    :data:`RELU`), the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return conv_relu_ref(x, conv)
    _check("conv_relu", x)
    if (x.shape[-1], conv.out_channels) not in RELU:
        raise ValueError(f"conv_relu has no kernel for widths "
                         f"{x.shape[-1]} -> {conv.out_channels}")
    out = x.new_empty((*x.shape[:3], conv.out_channels))
    return _launch(_MODE_RELU, _readable(x), conv, out)


def conv_residual(h: torch.Tensor, conv2: nn.Conv2d, x: torch.Tensor,
                  proj: nn.Conv2d | None) -> torch.Tensor:
    """A ResBlock's second half: ``relu(conv2(h) + b2 + skip)`` with
    ``skip`` = ``proj(x)`` (a 1x1 conv) or ``x`` itself when ``proj`` is
    None → ``(B, H, W, C)`` in ``h``'s dtype. Kernel or plain version as
    :func:`conv_relu`; widths in :data:`RESIDUAL`."""
    if h.device.type == "cpu":
        return conv_residual_ref(h, conv2, x, proj)
    _check("conv_residual", h)
    _check("conv_residual", x)
    c, cx = h.shape[-1], x.shape[-1]
    if (conv2.in_channels, conv2.out_channels) != (c, c) or (
            (c, cx) not in RESIDUAL) or (proj is None and cx != c) or (
            x.shape[:3] != h.shape[:3]):
        raise ValueError(f"conv_residual has no kernel for widths {c} with "
                         f"skip {tuple(x.shape)} (proj {proj is not None})")
    out = h.new_empty(h.shape)
    return _launch(_MODE_RESIDUAL, _readable(h), conv2, out,
                   skip=_readable(x), proj=proj)


def conv_head(h: torch.Tensor, head: nn.Conv2d,
              dens: torch.Tensor | None = None,
              factors: tuple[int, int] = (1, 1),
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The output head: ``conv(h) + b`` (one channel) plus, given ``dens``
    ``(B, H/fh, W/fw, 1)``, its bilinear ``factors`` upsample (the global
    skip) → ``(B, H, W, 1)`` in ``out_dtype``, summed in float32 and
    rounded once. Kernel or plain version as :func:`conv_relu`; input
    widths in :data:`HEAD`."""
    if h.device.type == "cpu":
        return conv_head_ref(h, head, dens, factors, out_dtype)
    _check("conv_head", h)
    if head.out_channels != 1 or h.shape[-1] not in HEAD:
        raise ValueError(f"conv_head has no kernel for widths "
                         f"{h.shape[-1]} -> {head.out_channels}")
    kernel_dtype = (out_dtype if out_dtype in (torch.float32, torch.bfloat16)
                    else torch.float32)
    out = h.new_empty((*h.shape[:3], 1), dtype=kernel_dtype)
    dens_hw, slice_major = (0, 0), None
    if dens is not None:
        _check("conv_head", dens)
        fh, fw = factors
        if (dens.shape[0], dens.shape[1] * fh, dens.shape[2] * fw) != \
                tuple(h.shape[:3]):
            raise ValueError(f"density {tuple(dens.shape)} upsampled by "
                             f"{factors} is not h's {tuple(h.shape[:3])}")
        dens_hw, slice_major = (dens.shape[1], dens.shape[2]), dens
    out = _launch(_MODE_HEAD, _readable(h), head, out, skip=dens,
                  dens_hw=dens_hw, slice_major=slice_major)
    return out.to(out_dtype)
