"""The train step as CUDA graphs — the port's counterpart of the JAX
package's jitted step (``mpgan_tpu/train/loop.py`` ``make_train_step``).

JAX compiles one device program per (stage, fade) pair and runs the whole
step in it: sampling, the D and Dt updates, lazy R1 as a ``lax.cond``,
the G update and the EMA. Here one :class:`Program` holds one such program
of a stage runtime, with lazy R1 chosen per program (a graph has no
branches, and ``lax.cond`` runs one branch anyway), so a runtime has up to
four: fade or stable, R1 or not (:class:`Programs`).

A program's first use steps eagerly: it is the warm-up (cuDNN picks its
algorithms, constants and the optimizer's moments are made, the kernels
are built), and a real step. Its second use captures
:meth:`mpgan_torch.train.loop.TrainStep.run` into a graph with its own
memory pool and replays it, since capture records work without running
it; every later use replays. Per program it holds:

- the fade weight, a 0-d float64 tensor filled before each replay
  (:func:`mpgan_torch.models.growing.fade_blend`);
- the trainer's sampling generator, registered with the graph, so that
  the seed the trainer sets before each iteration decides what a replay
  draws, as it decides an eager step's draws;
- the graph's output tensors, the step's metrics, which the next replay
  overwrites;
- the graph and its memory pool, released with the runtime at a growth
  boundary or a restore.

A replay reads nothing from the host and waits on nothing: per step the
host fills the fade weight, reseeds the generator and launches the graph.
The warp and conv kernels' Python counters
(:mod:`mpgan_torch.ops.warp_kernel`, :mod:`mpgan_torch.ops.conv_kernel`)
run only where a wrapper is called; the launches that a capture records
do not run then, so the counters are put back after a capture, and each
replay adds the launches its graph holds. A failed capture or replay
raises; nothing falls back to an eager step.

Inside an NCCL process group (a data-parallel rank, JAX's step jitted
over the mesh with its ``psum`` inside) the graph holds the step's
collectives too: the gradient all-reduce of each update and the metric
all-reduce (:func:`mpgan_torch.parallel.mesh.all_reduce_mean`).
``ProcessGroupNCCL`` runs them on its own stream, which joins the capture
through the events it orders the streams with, so a replay runs them
where an eager step does. The communicator exists before any capture:
the state's broadcast at the runtime's start makes it, and every
program's eager first use all-reduces. A gloo group's collectives run on
the host, which a graph cannot hold, so there the trainer steps eagerly
(:class:`mpgan_torch.train.loop.Trainer`). Every rank picks the same
program at each step, as the choice is a function of the step counter
and the schedule, which the ranks share.

:class:`Graph` is also the capture primitive of the inference programs
(:class:`mpgan_torch.infer.assemble.GraphedProgram`), which draw nothing
and so register no generator, and of the solver's step and datagen frame
(:mod:`mpgan_torch.solver.graphed`, :mod:`mpgan_torch.solver.datagen`),
whose inflow noise draws from a registered generator.

Spans (:mod:`mpgan_torch.tracing`): ``graph.capture``, every capture;
``train.replay``, the host's launch of a train program's replay, with the
replay's interval on the card. A span given a card inside a captured
function (the upscaler's passes) is timed on the card at every replay by
events recorded into the graph, read for the last traced replay.
"""

from __future__ import annotations

import gc

import torch

from mpgan_torch import tracing
from mpgan_torch.ops import conv_kernel, warp_kernel


class Graph:
    """A function captured once as a CUDA graph and replayed: the capture
    primitive of :class:`Program` and of the inference programs.

    ``Graph(fn, device, generator)`` captures ``fn()`` on the card
    ``device`` with ``generator`` (a CUDA ``torch.Generator``, or None for
    a function that draws nothing) registered; :meth:`replay` runs it and
    returns the outputs the capture returned, which every replay
    overwrites; :meth:`reset` releases the graph and its memory pool.
    ``launches`` is (forward, backward) warp kernel launches in the graph,
    ``conv_launches`` its generator convolution kernels
    (:mod:`mpgan_torch.ops.conv_kernel`);
    ``spans`` (a :class:`mpgan_torch.tracing.Captured`) the events that
    the spans inside ``fn`` given a card recorded into it, which each
    replay records again and :func:`mpgan_torch.tracing.spans` reads for
    the last traced replay.

    The capture runs on a new stream of ``device`` with ``device`` current.
    ``torch.cuda.graph``'s own side stream is made once per process, on
    the card current at the first capture: a later capture of work on
    another card would record nothing on it, while that work ran eagerly
    on its own card's stream.

    The capture holds only the capturing thread to CUDA's capture rules
    (``thread_local``): other threads of the process go on working, such
    as a server's request threads fetching earlier results and the NCCL
    watchdog querying its events. Python's cyclic garbage collector is
    held off during the capture: a dropped upscaler or pipeline leaves its
    graphs in reference cycles, and a collection on the capturing thread
    would reset them there, which CUDA refuses and which invalidates the
    capture.
    """

    @staticmethod
    def available(device: torch.device) -> bool:
        return torch.device(device).type == "cuda"

    def __init__(self, fn, device, generator: torch.Generator | None = None):
        device = torch.device(device)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"torch {torch.__version__} cannot register a generator "
                    "with a CUDA graph (CUDAGraph.register_generator_state), "
                    "which the graphed train step draws its batches from")
            graph.register_generator_state(generator)
        n0 = (warp_kernel.launches, warp_kernel.bwd_launches)
        c0 = conv_kernel.launches
        collecting = gc.isenabled()
        gc.disable()
        try:
            with tracing.capture() as self.spans, \
                    tracing.span("graph.capture"), torch.cuda.device(device), \
                    torch.cuda.graph(graph, stream=torch.cuda.Stream(device),
                                     capture_error_mode="thread_local"):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
        self.launches = (warp_kernel.launches - n0[0],
                         warp_kernel.bwd_launches - n0[1])
        self.conv_launches = conv_kernel.launches - c0
        # capture recorded these launches; they run at each replay
        warp_kernel.launches, warp_kernel.bwd_launches = n0
        conv_kernel.launches = c0
        self.graph = graph

    def replay(self):
        with tracing.replay(self.spans):
            self.graph.replay()
        warp_kernel.launches += self.launches[0]
        warp_kernel.bwd_launches += self.launches[1]
        conv_kernel.launches += self.conv_launches
        return self.out

    def reset(self) -> None:
        self.graph.reset()
        self.graph = self.out = None


class Program:
    """One device program of a stage runtime: ``step`` (a
    :class:`~mpgan_torch.train.loop.TrainStep`) with lazy R1 on or off.
    ``program(alpha) → metrics``; eager at its first use, captured at its
    second, replayed after (module docstring). Does not advance the step
    counter."""

    def __init__(self, step, r1: bool, generator: torch.Generator):
        self.step, self.r1, self.generator = step, r1, generator
        self.alpha = torch.zeros((), dtype=torch.float64, device=step.device)
        self.uses = 0
        self.graph: Graph | None = None

    def _run(self) -> dict:
        return self.step.run(self.alpha, self.generator, self.r1)

    def __call__(self, alpha: float) -> dict:
        if self.step.fade:
            self.alpha.fill_(alpha)
        self.uses += 1
        if self.uses == 1:
            return self.step.run_checked(self.alpha, self.generator, self.r1)
        if self.graph is None:
            self.graph = Graph(self._run, self.step.device, self.generator)
            self.step.check_launches(self.graph.launches)
        with tracing.span("train.replay", self.step.device):
            return dict(self.graph.replay())

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


class Programs:
    """The programs of one stage runtime, by (fade, lazy R1), made at
    first use. ``programs(fade, alpha) → metrics`` runs the step the
    runtime's step counter calls for and advances the counter; the
    caller seeds the generator before each call."""

    def __init__(self, rt, generator: torch.Generator):
        self.rt, self.generator = rt, generator
        self.programs: dict[tuple[bool, bool], Program] = {}

    def __call__(self, fade: bool, alpha: float) -> dict:
        step = self.rt.step_fade if fade else self.rt.step_stable
        key = (fade, step.r1_due())
        if key not in self.programs:
            self.programs[key] = Program(step, key[1], self.generator)
        metrics = self.programs[key](alpha)
        self.rt.step += 1
        return metrics

    def release(self) -> None:
        """Release every program's graph and memory pool."""
        for program in self.programs.values():
            program.release()
        self.programs.clear()
