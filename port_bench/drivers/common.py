"""What the drivers share: the generators made from the seed, the devices,
the readings of memory, and the comparisons."""

from __future__ import annotations

import contextlib
import time

import torch

from port_bench.reference import nets


def mark(ctx: dict, phase: str) -> None:
    """Note the seconds from the run's start to the end of a set-up
    phase (printed to standard error, before the checks)."""
    note(ctx, f"setup {phase} at {time.perf_counter() - ctx['t0']:.3f} s")


def note(ctx: dict, line: str) -> None:
    ctx.setdefault("notes", []).append(line)


def generator_desc(g: dict) -> dict:
    return {**g, "factors": [tuple(f) for f in g["factors"]]}


def port_generator(desc: dict, pass_no: int, params: dict, dtype,
                   out_dtype, device):
    """The program's generator of pass ``pass_no`` with the widths of
    ``desc``, holding ``params`` (the benchmark's own tensors, copied)."""
    from mpgan_torch.models import generator as G
    stages = len(desc["factors"])
    kw = dict(base_filters=desc["base_filters"],
              n_res_blocks=desc["n_res_blocks"], dtype=dtype,
              out_dtype=out_dtype, in_channels=desc["in_channels"])
    gen = (G.make_pass1 if pass_no == 1 else G.make_pass2)(stages, **kw)
    gen = gen.to(device)
    gen.load_state_dict(params, strict=True)
    return gen


def frame_weights(config: dict, seed: int, device):
    """(p1, desc1, p2, desc2): the two passes' parameters, drawn on
    ``device`` from ``seed`` in one call each."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d1 = generator_desc(config["generator_pass1"])
    d2 = generator_desc(config["generator_pass2"])
    p1 = nets.make_weights(nets.generator_layout(d1), gen, device)
    p2 = nets.make_weights(nets.generator_layout(d2), gen, device)
    return p1, d1, p2, d2


def lr_frames(n: int, size: int, vel: float, gen: torch.Generator,
              device) -> torch.Tensor:
    """(n, size, size, size, 4) float32: density uniform in [0, 1),
    velocity uniform in [−vel, vel) LR cells per frame."""
    x = torch.rand((n, size, size, size, 4), generator=gen, device=device)
    x[..., 1:].mul_(2 * vel).sub_(vel)
    return x


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[name]


def memory_peak(devices) -> int:
    if devices[0].type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in devices)


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matrix products and convolutions while the block runs
    (the reference's precision), the caller's flags restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rel_rms(out: torch.Tensor, ref: torch.Tensor) -> float:
    """‖out − ref‖ / ‖ref‖ over every voxel, in float64."""
    a = out.to(ref.device, torch.float64)
    b = ref.to(torch.float64)
    return float(((a - b).square().sum() / b.square().sum()).sqrt())


def leaf_gaps(prog: dict, ref: dict, include=None) -> dict[str, float]:
    """Per leaf the gap of norms: |‖prog[k]‖ − ‖ref[k]‖| over the larger of
    ‖ref[k]‖ and the median leaf's ‖ref‖ (of the leaves in ``include``,
    all when None)."""
    keys = [k for k in ref if include is None or k in include]
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = sorted(rn.values())[len(rn) // 2]
    return {k: abs(float(prog[k].double().norm()) - rn[k])
            / max(rn[k], med, 1e-30) for k in keys}


def leaf_diffs(prog: dict, ref: dict, include=None) -> dict[str, float]:
    """Per leaf ‖prog[k] − ref[k]‖ over the larger of ‖ref[k]‖ and the
    median leaf's ‖ref‖ (of the leaves in ``include``, all when None)."""
    keys = [k for k in ref if include is None or k in include]
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = sorted(rn.values())[len(rn) // 2]
    return {k: float((prog[k].double() - ref[k].double()).norm())
            / max(rn[k], med, 1e-30) for k in keys}
