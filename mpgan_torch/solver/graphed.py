"""The solver's step as CUDA graphs — the port's counterpart of the JAX
package's jitted ``smoke.step`` and ``smoke2d.step``
(``@partial(jax.jit, static_argnames=("params",))``,
``mpgan_tpu/solver/smoke.py:225-226``, ``smoke2d.py:99-100``).

JAX compiles one program per (state shape, ``params``, inflow given or
not); :class:`GraphedStep` keeps one
:class:`~mpgan_torch.train.graphed.GraphedProgram` per such key, by the
rule of the port's other programs: eager at its first use, captured at its
second (on the state's card), replayed after. The step waits on nothing
from the host (the CG freeze is ``torch.where`` on 0-d tensors), so its
whole work is one graph; anything that did synchronise would make the
capture raise, and nothing falls back to eager. Datagen's per-frame
programs (inflow noise + step, and the downsampled outputs) are made the
same way in :mod:`mpgan_torch.solver.datagen`.
"""

from __future__ import annotations

import torch

from mpgan_torch.solver import smoke
from mpgan_torch.train import graphed


class GraphedStep:
    """``graphed(state, params, inflow_density, inflow_mask)`` → the state
    ``step(state, params, inflow_density, inflow_mask)`` returns, bit for
    bit, with ``step`` :func:`mpgan_torch.solver.smoke.step` (the default)
    or :func:`mpgan_torch.solver.smoke2d.step`.

    One program per (state shape, ``params``, inflow given or not), the
    ``MAX_PROGRAMS`` most recently used kept. The state's density,
    velocity and solid and the inflow density and mask are the program's
    static inputs, copied in at each call. From a program's second use
    on, the returned density and velocity are the graph's static outputs,
    which the next replay overwrites: a caller that keeps a state across
    calls clones it. The
    returned solid is the one the caller passed. Raises ``ValueError`` on
    a device without CUDA graphs (the CPU, where ``step`` itself runs)."""

    def __init__(self, step=smoke.step):
        self.step = step
        self.programs = graphed.ProgramCache()

    def __call__(self, state, params: smoke.SmokeParams,
                 inflow_density: torch.Tensor | None = None,
                 inflow_mask: torch.Tensor | None = None):
        device = state.density.device
        if not graphed.graphable(device):
            raise ValueError(f"a graphed solver step runs on a CUDA card; "
                             f"got {device}")
        if inflow_density is None or inflow_mask is None:
            inflow_density = inflow_mask = None
        cls = type(state)

        def run(density, velocity, solid, src, mask):
            new = self.step(cls(density, velocity, solid), params, src, mask)
            return new.density, new.velocity
        program = self.programs.program(
            (cls, tuple(state.density.shape), params, inflow_mask is not None),
            lambda: graphed.GraphedProgram(run, (), device))
        density, velocity = program(state.density, state.velocity,
                                    state.solid, inflow_density, inflow_mask)
        return cls(density, velocity, state.solid)

    def release(self) -> None:
        """Release every program's graph and memory pool."""
        self.programs.release()
