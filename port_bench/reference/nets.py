"""Plain float32 reference of the generator and the two discriminators.

A frozen copy of the equations of the Multi-pass GAN's slice generator and
of tempoGAN's spatial and temporal discriminators as this benchmark's
configurations state them, written from the architecture alone: it imports
nothing of the program. Parameters are a flat ``{name: tensor}`` dict whose
names and shapes are given by :func:`generator_layout` and
:func:`discriminator_layout` (the names are the published checkpoints').

``quant`` (None, or a callable applied to every operand and result of a
convolution or dense layer and to the network's output) turns the
reference into the lower-precision control: see :func:`fp8_quant`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn
FP8_E5M2_MAX = 57344.0  # the largest finite float8_e5m2


def _round8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` with a per-tensor scale (its
    absolute maximum onto ``top``), back in ``x``'s dtype."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8(torch.autograd.Function):
    """Forward in float8 e4m3, backward in float8 e5m2, each tensor with a
    scale of its own, as fp8 training and inference scale them. The
    backward is made of differentiable operations (its own derivative is
    the identity), so a double backward (R1) goes through it."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return g + (_round8(g.detach(), torch.float8_e5m2, FP8_E5M2_MAX)
                    - g).detach()


def fp8_quant(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: every operand and result of a convolution
    or dense layer, and every network output, in float8 (e4m3 forward,
    e5m2 backward, a per-tensor scale each): the step below bfloat16."""
    return _FP8.apply(x)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back, the gradient passed straight
    through: the configurations' own precision, as a yardstick of the
    rounding error that precision makes (``frame_err_ratio``)."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


def conv(x, w, b, quant=None, **kw):
    if quant is None:
        return F.conv2d(x, w, b, **kw)
    return quant(F.conv2d(quant(x), quant(w), b, **kw))


def up(x: torch.Tensor, fh: int, fw: int) -> torch.Tensor:
    """Half-pixel, edge-clamped linear upsample of an NCHW tensor."""
    if fh == 1 and fw == 1:
        return x
    h, w = x.shape[-2:]
    return F.interpolate(x, size=(h * fh, w * fw), mode="bilinear",
                         align_corners=False)


# ---------------------------------------------------------------- generator

def _gen_widths(base: int, min_filters: int, k: int) -> int:
    return max(base // (2 ** (k + 1)), min_filters)


def generator_layout(g: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every parameter of a generator described by ``g``
    (keys ``in_channels``, ``factors``, ``base_filters``, ``min_filters``,
    ``n_res_blocks``, ``out_channels``)."""
    out = []

    def c(name, cin, cout, k):
        out.extend([(f"{name}.weight", (cout, cin, k, k)),
                    (f"{name}.bias", (cout,))])
    base = g["base_filters"]
    c("stem", g["in_channels"], base, 3)
    width = base
    for k in range(len(g["factors"])):
        f = _gen_widths(base, g["min_filters"], k)
        for i in range(g["n_res_blocks"]):
            c(f"block_{k}_{i}.conv1", width, f, 3)
            c(f"block_{k}_{i}.conv2", f, f, 3)
            if width != f:
                c(f"block_{k}_{i}.proj", width, f, 1)
            width = f
        c(f"head_{k}", width, g["out_channels"], 3)
    return out


def generator(p: dict, g: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """The generator at its last stage, no fade: (B, H, W, C) →
    (B, H·Πfh, W·Πfw, out) float32, with the global skip of the input
    density."""
    x = x.to(torch.float32).permute(0, 3, 1, 2)
    dens = x[:, 0:1]

    def cv(name, t, pad=1):
        return conv(t, p[f"{name}.weight"], p[f"{name}.bias"], quant,
                    padding=pad)
    h = F.relu(cv("stem", x))
    out = None
    for k, (fh, fw) in enumerate(g["factors"]):
        h = up(h, fh, fw)
        for i in range(g["n_res_blocks"]):
            blk = f"block_{k}_{i}"
            r = cv(f"{blk}.conv2", F.relu(cv(f"{blk}.conv1", h)))
            s = cv(f"{blk}.proj", h, 0) if f"{blk}.proj.weight" in p else h
            h = F.relu(s + r)
        out = cv(f"head_{k}", h)
    fh = math.prod(f[0] for f in g["factors"])
    fw = math.prod(f[1] for f in g["factors"])
    out = out + up(dens, fh, fw)
    if quant is not None:
        out = quant(out)
    return out.permute(0, 2, 3, 1)


# ----------------------------------------------------------- discriminator

def _disc_widths(d: dict, k: int) -> int:
    return min(max(d["base_filters"] // (2 ** k), d["min_filters"]),
               d["max_filters"])


def discriminator_layout(d: dict) -> list[tuple[str, tuple[int, ...]]]:
    """(name, shape) of every parameter of a discriminator described by
    ``d`` (keys ``in_channels``, ``in_hw``, ``factors``, ``base_filters``,
    ``min_filters``, ``max_filters``), at its last stage."""
    out = []
    stage = len(d["factors"])

    def c(name, cin, cout):
        out.extend([(f"{name}.weight", (cout, cin, 3, 3)),
                    (f"{name}.bias", (cout,))])
    for k in range(stage - 1, -1, -1):
        c(f"from_in_{k}", d["in_channels"], _disc_widths(d, k + 1))
    h, w = d["in_hw"]
    for k in range(stage - 1, -1, -1):
        fh, fw = d["factors"][k]
        c(f"down_{k}", _disc_widths(d, k + 1), _disc_widths(d, k))
        c(f"conv_{k}", _disc_widths(d, k), _disc_widths(d, k))
        h, w = math.ceil(h / fh), math.ceil(w / fw)
    out.extend([("out.weight", (1, h * w * _disc_widths(d, 0))),
                ("out.bias", (1,))])
    return out


def _same(n: int, stride: int) -> tuple[int, int]:
    total = max((math.ceil(n / stride) - 1) * stride + 3 - n, 0)
    return total // 2, total - total // 2


def discriminator(p: dict, d: dict, x: torch.Tensor, quant=None,
                  features: bool = False):
    """The discriminator at its last stage, no fade: (B, H, W, C) → logits
    (B, 1) [, the output of every down and conv layer, NHWC]. Convolutions
    pad as XLA's ``SAME`` (a strided one on an even size pads 0 before and
    1 after); activations are leaky ReLU 0.2; the dense head reads the last
    map flattened in NHWC order."""
    stage = len(d["factors"])
    x = x.to(torch.float32).permute(0, 3, 1, 2)

    def cv(name, t, stride=(1, 1)):
        ph, pw = _same(t.shape[-2], stride[0]), _same(t.shape[-1], stride[1])
        t = F.pad(t, (*pw, *ph))
        return F.leaky_relu(conv(t, p[f"{name}.weight"], p[f"{name}.bias"],
                                 quant, stride=stride), 0.2)
    h = cv(f"from_in_{stage - 1}", x)
    feats = []
    for k in range(stage - 1, -1, -1):
        h = cv(f"down_{k}", h, tuple(d["factors"][k]))
        feats.append(h)
        h = cv(f"conv_{k}", h)
        feats.append(h)
    flat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    if quant is None:
        logits = F.linear(flat, p["out.weight"], p["out.bias"])
    else:
        logits = quant(F.linear(quant(flat), quant(p["out.weight"]),
                                p["out.bias"]))
    if features:
        return logits, [f.permute(0, 2, 3, 1) for f in feats]
    return logits


# ------------------------------------------------------------------ weights

def fan_in(shape: tuple[int, ...]) -> int:
    return math.prod(shape[1:])


def make_weights(layout, generator: torch.Generator, device,
                 bias_std: float = 0.05) -> dict[str, torch.Tensor]:
    """Float32 parameters for ``layout`` from one draw of ``generator`` on
    ``device``: kernels lecun-normal (σ = 1/√fan_in, cut at ±2σ), biases
    normal with ``bias_std`` (not the zeros a fresh model starts from, so
    that the bias path is compared too)."""
    sizes = [math.prod(s) for _, s in layout]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out = {}
    for (name, shape), part in zip(layout, flat.split(sizes)):
        if name.endswith(".bias"):
            t = part * bias_std
        else:
            std = 1.0 / math.sqrt(fan_in(shape))
            t = part.clamp(-2.0, 2.0) * std
        out[name] = t.view(shape)
    return out
