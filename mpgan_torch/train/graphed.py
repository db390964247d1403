"""The port's captured programs: CUDA graphs of the train step, the
upscaler, the pipeline's stages, the solver's step and datagen's frames,
the counterparts of the JAX package's jitted functions.

One rule makes every program (:class:`GraphedProgram`): its first use runs
the function eagerly (the warm-up: cuDNN picks its algorithms, constants,
moments and replicas are made, the kernels are built); its second copies
the inputs into static ones and captures the function into a graph
(:class:`Graph`) with its own memory pool, since capture records work
without running it, and replays it; every later use copies in and
replays. A replay overwrites the graph's static outputs. A failed capture
or replay raises; nothing falls back to eager.

The train step (JAX's ``make_train_step``, one program per (stage, fade)):
one :class:`Program` per stage runtime, fade or stable, and lazy R1 or not,
as a graph has no branches (:class:`Programs`). It has no inputs: the fade
weight is a 0-d float64 tensor filled before each use, and the trainer's
sampling generator is registered with the graph, so that the seed set
before each iteration decides what a replay draws, as it decides an eager
step's. A replay reads nothing from the host and waits on nothing. In an
NCCL process group the graph holds the step's all-reduces too:
``ProcessGroupNCCL`` runs them on its own stream, which joins the capture
through the events it orders the streams with, and the communicator exists
before any capture (the state's broadcast makes it). A gloo group's
collectives run on the host, which a graph cannot hold, so there the
trainer steps eagerly (:class:`mpgan_torch.train.loop.Trainer`). Every rank
picks the same program at each step, a function of the step counter and
the schedule.

Inference (JAX's ``jit`` per input shape and dtype): a
:class:`ProgramCache` turns an owner's calls on a device list into
programs by one rule. On one card, or a list that repeats it, a call is one
program per input key, each replay's output copied out
(:func:`run_copied`), as JAX hands out a fresh buffer per call; over
distinct cards a capture cannot hold the call, so it runs eagerly on the
first card with each card's share of each pass a program of its own,
captured on that card (:class:`CardPrograms`).

Launch counters (:data:`mpgan_torch.tracing.COUNTERS`) count where a
kernel wrapper is called; a capture's launches do not run then, so
:class:`Graph` puts the counters back after it, and each replay adds its
graph's launches.

Spans (:mod:`mpgan_torch.tracing`): ``graph.capture``, every capture;
``train.replay`` (attribute ``r1``: the program's lazy R1), the host's
launch of a train program's replay, with its interval on the card. A
span given a card inside a captured function (the upscaler's passes, the
train step's D-run, G-run and batches) is timed on the card at every
replay by events recorded into the graph, read for the last traced
replay.
"""

from __future__ import annotations

import gc
import itertools
from collections import OrderedDict

import torch

from mpgan_torch import tracing
from mpgan_torch.parallel.mesh import canonical

# programs a cache keeps: each holds a memory pool somewhat above the
# eager call's peak (2.33 GB against 1.72 GB at 64³→256³ bf16 on an H100,
# chip_smoke.py phase 4)
MAX_PROGRAMS = 2


class Graph:
    """A function captured once as a CUDA graph and replayed: the capture
    primitive of :class:`GraphedProgram`.

    ``Graph(fn, device, generator)`` captures ``fn()`` on the card
    ``device`` with ``generator`` (a CUDA ``torch.Generator``, or None for
    a function that draws nothing) registered; :meth:`replay` runs it and
    returns the outputs the capture returned (``out``), which every replay
    overwrites; :meth:`reset` releases the graph and its memory pool.
    ``counts`` are the graph's launches by registered counter,
    ``launches`` the (forward, backward) warp ones (``warp``,
    ``warp_bwd``), which the train step checks; ``spans`` (a
    :class:`mpgan_torch.tracing.Captured`) the events that the spans
    inside ``fn`` given a card recorded into it, which each replay records
    again and :func:`mpgan_torch.tracing.spans` reads for the last traced
    replay.

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
        held = {name: getattr(mod, attr)
                for name, (mod, attr) in tracing.COUNTERS.items()}
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
        # capture recorded these launches; they run at each replay
        self.counts = {}
        for name, (mod, attr) in tracing.COUNTERS.items():
            n = getattr(mod, attr) - held.get(name, 0)
            if n:
                self.counts[name] = n
                setattr(mod, attr, held.get(name, 0))
        self.launches = (self.counts.get("warp", 0),
                         self.counts.get("warp_bwd", 0))
        self.graph = graph

    def replay(self):
        with tracing.replay(self.spans):
            self.graph.replay()
        for name, n in self.counts.items():
            mod, attr = tracing.COUNTERS[name]
            setattr(mod, attr, getattr(mod, attr) + n)
        return self.out

    def reset(self) -> None:
        self.graph.reset()
        self.graph = self.out = None


def spans_cards(devices) -> bool:
    """Whether a device list names more than one device."""
    return devices is not None and len({canonical(d) for d in devices}) > 1


def graphable(device, devices=None) -> bool:
    """Whether calls on ``device`` (split over ``devices``) can replay
    captured programs: CUDA graphs exist on every device named. On one
    card (a list that repeats it included) one capture holds the whole
    call; over distinct cards each card's shares are programs of their
    own (:class:`CardPrograms`), since a capture lives on one device."""
    return all(Graph.available(d) for d in [device, *(devices or ())])


class GraphedProgram:
    """``fn(*xs)`` for inputs of one shape and dtype each as one captured
    CUDA graph, by the rule of the module docstring: eager at the first
    use (the inputs moved to ``device``), captured at the second, replayed
    after. The static inputs ``xs`` lie on ``device``, each with its
    input's strides: cuDNN picks a convolution's kernels by its input's
    layout, and a card's share of a split is a strided view on the first
    card. From the second use on, ``program(*xs)`` returns the graph's
    static output: a caller that keeps it copies it first
    (:func:`run_copied`). An input may be None (a pass without velocity);
    the captured function then gets None there too.

    An input may lie on the host. A replay raises ``RuntimeError`` when a
    parameter or buffer of ``modules`` no longer lies where it lay at the
    capture (a module moved or its tensors replaced: the graph would read
    the old storage); values changed in place are read by the replay.
    ``generator`` (a ``torch.Generator`` of ``device``) is registered with
    the graph: a replay draws from its state at the call, as an eager call
    does (the caller reseeds it)."""

    def __init__(self, fn, modules, device, generator=None):
        self.fn = fn
        self.modules = tuple(modules)
        self.device = canonical(device)
        self.generator = generator
        self.uses = 0
        self.graph: Graph | None = None
        self.xs: list[torch.Tensor | None] = []
        self.storage: list[int] = []

    def _storage(self) -> list[int]:
        return [t.data_ptr() for m in self.modules
                for t in itertools.chain(m.parameters(), m.buffers())]

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, *xs: torch.Tensor | None):
        self.uses += 1
        if self.uses == 1:
            return self.warm_up(*xs)
        if self.graph is None:
            self.capture(xs)
        elif self.modules and self._storage() != self.storage:
            raise RuntimeError(
                "a generator's parameters were moved or replaced since its "
                "CUDA graph was captured; make the upscaler or pipeline anew")
        else:
            self._fill(xs)
        return self.replay()

    def warm_up(self, *xs):
        """The eager first use."""
        return self.fn(*(None if x is None else x.to(self.device)
                         for x in xs))

    def capture(self, xs) -> None:
        self.xs = [None if x is None else torch.empty_strided(
            x.shape, x.stride(), dtype=x.dtype, device=self.device)
            for x in xs]
        self._fill(xs)
        self.storage = self._storage()
        self.graph = Graph(self._run_static, self.device, self.generator)

    def _run_static(self):
        return self.fn(*self.xs)

    def replay(self):
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


def run_copied(program: GraphedProgram, *xs) -> torch.Tensor:
    """``program(*xs)``, a replay's output copied on the device: the
    program's next replay overwrites its own output, so every caller gets
    a fresh tensor, as JAX hands out a fresh buffer per call."""
    out = program(*xs)
    return out.clone() if program.captured else out


class ProgramCache(OrderedDict):
    """An owner's programs by key, least recently used first, for its
    calls on ``device`` split over ``devices`` (module docstring). Beyond
    ``limit`` (None keeps all) the least recently used one's graphs and
    memory pools are released and it is dropped: that key starts again
    from an eager use."""

    limit: int | None = MAX_PROGRAMS

    def __init__(self, device=None, devices=None):
        super().__init__()
        self.device = None if device is None else canonical(device)
        self.split = spans_cards(devices)

    def program(self, key, make, modules=()):
        """The program of ``key``, made by ``make()`` when absent or made
        over other ``modules`` (a new replica: the old program is
        released), and made the most recently used."""
        program = self.get(key)
        if program is None or program.modules != modules:
            if program is not None:
                program.release()
            program = self[key] = make()
        self.move_to_end(key)
        if self.limit is not None and len(self) > self.limit:
            self.popitem(last=False)[1].release()
        return program

    def run(self, key, fn, modules, *xs, copied: bool = True):
        """``fn(*xs, programs=None)`` over ``modules``: on one card as
        ``key``'s program, a replay's output copied out unless ``copied``
        is false (a caller that copies it at once); over distinct cards on
        the inputs moved to the first card, with ``key``'s
        :class:`CardPrograms` as ``programs``."""
        if self.split:
            cards = self.program(key, lambda: CardPrograms(modules), modules)
            return fn(*(None if x is None else x.to(self.device)
                        for x in xs), programs=cards)
        program = self.program(
            key, lambda: GraphedProgram(fn, modules, self.device), modules)
        return run_copied(program, *xs) if copied else program(*xs)

    def release(self) -> None:
        for program in self.values():
            program.release()
        self.clear()


class CardPrograms(ProgramCache):
    """The shares of one key's calls split over distinct cards (JAX's
    one program over the mesh): a :class:`GraphedProgram` per (generator,
    its keywords, card, share shape, dtype), run on the generator's
    replica on that card (a new replica gets a new program) and captured
    there. Each replay's output is copied on the card's stream before the
    first card gathers it: a device list that repeats a card replays one
    program for several of its shares. ``modules`` are the owner's."""

    limit = None

    def __init__(self, modules=()):
        super().__init__()
        self.modules = tuple(modules)

    def share(self, gen, kw: dict, x: torch.Tensor, device, rep):
        """``gen``'s call with keywords ``kw`` on the share ``x``, which
        lies on ``device``, as that card's program over ``rep``, ``gen``'s
        replica there."""
        key = (gen, tuple(sorted(kw.items())), device, tuple(x.shape),
               x.dtype)
        program = self.program(key, lambda: GraphedProgram(
            lambda y: rep(y, **kw), (rep,), device), (rep,))
        return run_copied(program, x)


class Program(GraphedProgram):
    """One device program of a stage runtime: ``step`` (a
    :class:`~mpgan_torch.train.loop.TrainStep`) with lazy R1 on or off,
    over no inputs and no modules (a replay walks no parameters);
    ``program(alpha) → metrics``. Its eager first use and its capture
    check the warp launches; a replay is a ``train.replay`` span. Does not
    advance the step counter."""

    def __init__(self, step, r1: bool, generator: torch.Generator):
        super().__init__(self._run, (), step.device, generator)
        self.step, self.r1 = step, r1
        self.alpha = torch.zeros((), dtype=torch.float64, device=step.device)

    def _run(self) -> dict:
        return self.step.run(self.alpha, self.generator, self.r1)

    def __call__(self, alpha: float) -> dict:
        if self.step.fade:
            self.alpha.fill_(alpha)
        return super().__call__()

    def warm_up(self) -> dict:
        return self.step.run_checked(self.alpha, self.generator, self.r1)

    def capture(self, xs) -> None:
        super().capture(xs)
        self.step.check_launches(self.graph.launches)

    def replay(self) -> dict:
        with tracing.span("train.replay", self.step.device, r1=self.r1):
            return dict(self.graph.replay())


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
