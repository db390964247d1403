"""The graphed upscaler and sweeps (mpgan_torch.infer.assemble
``make_graphed_upscaler``, ``GraphedProgram``) on the CPU, where the
capture primitive is replaced by a stub, and on a card (marked ``cuda``;
skipped without one).

The stub (:class:`AliasingGraph`) is stricter than the train step's
``StubGraph`` (tests/test_torch_graphed.py): its capture runs the function
once and fills the outputs with NaN (a capture records work without
running it), and each replay writes into those same output tensors, as a
CUDA graph writes its static outputs. A caller that handed out a replay's
output would see it overwritten by the next replay.

- The graphed upscaler over a small 2-stage chain (base 8, one res block,
  4x, float32) equals JAX's ``make_jitted_upscaler`` over its eager,
  capture and replay uses (atol 1e-5, as tests/test_torch_infer.py).
- Calls of two shapes interleaved keep every returned tensor intact, each
  equal to a direct eager ``upscale_volume`` bit for bit; a third shape
  evicts the least recently used program and releases it; a replaced
  parameter makes a replay raise.
- ``precompute_intermediates`` / ``precompute_finals`` replay one program
  over the sweep and equal JAX's (1e-5, as tests/test_torch_pass3.py).
- ``InferenceServer`` over ``serve.make_upscaler`` round-trips requests of
  two interleaved shapes, the warmed one replayed from its first request.
- On a card: graphed frames equal eager ones bit for bit, float32 and
  bf16, under cuDNN's deterministic mode. That test imports no JAX.
"""

import os
import tempfile
import threading

import numpy as np
import pytest
import torch

from mpgan_torch import serve
from mpgan_torch.infer import assemble as TA
from mpgan_torch.models import generator as TG
from mpgan_torch.train import graphed

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

ATOL = 1e-5  # random-weight chains against JAX (tests/test_torch_infer.py)


class AliasingGraph:
    """The capture primitive's stand-in (module docstring): logs capture,
    replay and reset in ``log``."""

    log: list = []

    @staticmethod
    def available(device):
        return True

    def __init__(self, fn, device, generator=None):
        self.fn, self.device = fn, device
        self.out = fn().fill_(float("nan"))
        self.launches = (0, 0)
        self.log.append("capture")

    def replay(self):
        self.out.copy_(self.fn())
        self.log.append("replay")
        return self.out

    def reset(self):
        self.log.append("reset")
        self.out = None


@pytest.fixture
def stub(monkeypatch):
    AliasingGraph.log = []
    monkeypatch.setattr(graphed, "Graph", AliasingGraph)
    return AliasingGraph


@pytest.fixture(scope="module")
def jax_chain():
    """Random flax generators (2 stages, base 8, one res block) and their
    port counterparts, converted."""
    import jax
    import jax.numpy as jnp
    from mpgan_torch import convert
    from mpgan_tpu.models import generator as JG

    def port(params, tgen):
        tgen.load_state_dict(convert.flax_to_state_dict(
            jax.tree.map(np.asarray, params)))
        return tgen.eval()

    jg1, jg2 = JG.make_pass1(2, 8, 1), JG.make_pass2(2, 8, 1)
    p1 = jg1.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    p2 = jg2.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32, 4)))
    return ((jg1, p1, port(p1, TG.make_pass1(2, 8, 1))),
            (jg2, p2, port(p2, TG.make_pass2(2, 8, 1))))


def _chain(seed=0):
    torch.manual_seed(seed)
    return TG.make_pass1(2, 8, 1).eval(), TG.make_pass2(2, 8, 1).eval()


def _vols(shape, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.random(shape, dtype=np.float32) for _ in range(n)]


def _eager(g1, g2, lr):
    with torch.inference_mode():
        return TA.upscale_volume(g1, g2, torch.from_numpy(lr), 4)


def test_graphed_upscaler_matches_jitted_upscaler(stub, jax_chain):
    import jax.numpy as jnp
    from mpgan_tpu.infer import assemble as JA

    (jg1, p1, t1), (jg2, p2, t2) = jax_chain
    jitted = JA.make_jitted_upscaler(jg1, p1, jg2, p2, 4)
    upscale = TA.make_graphed_upscaler(t1, t2, 4)
    vols = _vols((6, 8, 8, 4), 4, 1)
    got = [upscale(v) for v in vols]
    # eager, then captured and replayed, then replayed twice
    assert stub.log == ["capture", "replay", "replay", "replay"]
    for v, g in zip(vols, got):
        assert g.shape == (24, 32, 32, 1) and g.is_inference()
        np.testing.assert_allclose(g.numpy(), np.asarray(jitted(
            jnp.asarray(v))), rtol=0, atol=ATOL)


def test_interleaved_shapes_keep_their_results(stub):
    g1, g2 = _chain()
    upscale = TA.make_graphed_upscaler(g1, g2, 4)
    a, b = _vols((3, 4, 4, 4), 4, 2), _vols((4, 6, 5, 4), 4, 3)
    order = [a[0], b[0], a[1], b[1], a[2], b[2], a[3], b[3]]
    got = [upscale(torch.from_numpy(v)) for v in order]
    assert stub.log.count("capture") == 2 and stub.log.count("replay") == 6
    assert len({g.data_ptr() for g in got}) == len(got)
    for v, g in zip(order, got):
        assert torch.equal(g, _eager(g1, g2, v))
    assert [p.captured for p in upscale.programs.values()] == [True, True]


def test_a_third_shape_evicts_the_least_recent_program(stub):
    g1, g2 = _chain()
    upscale = TA.make_graphed_upscaler(g1, g2, 4)
    a, b, c = (_vols(s, 1, i)[0] for i, s in enumerate(
        [(2, 4, 4, 4), (3, 4, 4, 4), (2, 4, 8, 4)]))
    for v in (a, a, b, b, a):
        upscale(v)
    assert stub.log == ["capture", "replay", "capture", "replay", "replay"]
    prog_a, prog_b = (upscale.programs[(v.shape, torch.float32)]
                      for v in (a, b))
    upscale(c)
    # b was used less recently than a: released and dropped
    assert stub.log[-1] == "reset" and TA.MAX_PROGRAMS == 2
    assert prog_b.graph is None and prog_a.captured
    assert list(upscale.programs) == [(a.shape, torch.float32),
                                      (c.shape, torch.float32)]
    # b starts again from an eager use, and a is released in its turn
    assert torch.equal(upscale(b), _eager(g1, g2, b))
    assert stub.log.count("reset") == 2 and prog_a.graph is None
    assert not upscale.programs[(b.shape, torch.float32)].captured


def test_replaced_parameters_refuse_a_replay(stub):
    g1, g2 = _chain()
    v = _vols((2, 4, 4, 4), 1, 4)[0]
    upscale = TA.make_graphed_upscaler(g1, g2, 4)
    upscale(v)
    upscale(v)
    # values changed in place are read by the replay
    with torch.no_grad():
        for q in g1.parameters():
            q.mul_(0.5)
    assert torch.equal(upscale(v), _eager(g1, g2, v))
    # a replaced parameter is not: the graph would read the old storage
    with torch.no_grad():
        p = next(g2.parameters())
        p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="moved or replaced"):
        upscale(v)


def test_graphed_upscaler_needs_one_card():
    g1, g2 = _chain()
    with pytest.raises(ValueError, match="one CUDA card"):
        TA.make_graphed_upscaler(g1, g2, 4)
    assert not TA.graphable("cpu")


def test_graphable_device_lists(monkeypatch):
    monkeypatch.setattr(graphed.Graph, "available",
                        staticmethod(lambda device: True))
    cpu = torch.device("cpu")
    assert TA.graphable(cpu) and TA.graphable(cpu, [cpu] * 2)
    assert not TA.graphable(cpu, [cpu, torch.device("cuda", 1)])


@pytest.mark.parametrize("which", ["intermediates", "finals"])
def test_precompute_replays_one_program_and_matches_jax(stub, jax_chain,
                                                        which):
    import jax.numpy as jnp
    from mpgan_tpu.infer import assemble as JA

    (jg1, p1, t1), (jg2, p2, t2) = jax_chain
    lr = np.random.default_rng(5).random((4, 6, 6, 6, 4), dtype=np.float32)
    if which == "intermediates":
        want = JA.precompute_intermediates(jg1, p1, jnp.asarray(lr))
        got = TA.precompute_intermediates(t1, torch.from_numpy(lr))
    else:
        want = JA.precompute_finals(jg1, p1, jg2, p2, jnp.asarray(lr), 4)
        got = TA.precompute_finals(t1, t2, torch.from_numpy(lr), 4, chunk=5)
    # volume 0 eager, volume 1 captured, every volume after replayed; the
    # program released at the end
    assert stub.log == ["capture", "replay", "replay", "replay", "reset"]
    assert got.dtype == torch.float32 and not got.is_inference()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_server_round_trips_interleaved_shapes(stub, monkeypatch):
    g1, g2 = _chain(1)
    upscale = serve.make_upscaler((g1, g2, None), "cpu", up_res=4)
    a, b = _vols((3, 4, 4, 4), 3, 6), _vols((4, 6, 5, 4), 3, 7)
    with tempfile.TemporaryDirectory() as d:  # AF_UNIX paths are short
        sock = os.path.join(d, "m.sock")
        server = serve.InferenceServer(upscale, sock, expect_channels=4)
        server.warm((3, 4, 4, 4))
        # the warm-up ran the shape eagerly and captured it
        assert stub.log == ["capture", "replay"]
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            with serve.Client(sock, timeout=60) as c:
                got = [(v, c.upscale(v)) for pair in zip(a, b) for v in pair]
                c.shutdown_server()
        finally:
            th.join(timeout=60)
        assert not th.is_alive()
    # the warmed shape replays from its first request; the other runs
    # eagerly, then is captured
    assert stub.log == ["capture", "replay", "replay", "replay", "capture",
                        "replay", "replay", "replay"]
    for v, hr in got:
        assert np.array_equal(hr, serve._to_host(_eager(g1, g2, v)))


# ------------------------------------------------------------------ card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_graphed_frames_equal_eager_bit_for_bit(monkeypatch, dtype):
    """Interleaved shapes through the graphed upscaler on the card equal
    eager ``upscale_volume`` calls bit for bit under cuDNN's deterministic
    mode, and every returned tensor stays intact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    dev = torch.device("cuda")
    torch.manual_seed(0)
    g1 = TG.make_pass1(2, 16, 2, dtype=dtype).to(dev).eval()
    g2 = TG.make_pass2(2, 16, 2, dtype=dtype).to(dev).eval()
    upscale = TA.make_graphed_upscaler(g1, g2, 4)
    vols = [v for pair in zip(_vols((16, 16, 16, 4), 3, 8),
                              _vols((8, 16, 12, 4), 3, 9)) for v in pair]
    got = [upscale(v) for v in vols]
    assert all(p.captured for p in upscale.programs.values())
    for v, g in zip(vols, got):
        with torch.inference_mode():
            want = TA.upscale_volume(g1, g2, torch.from_numpy(v).to(dev), 4)
        assert torch.equal(g, want)
