"""Pipeline-parallel inference of the port (``mpgan_torch.infer.pipeline``)
against the JAX package's on the CPU: ``default_split`` exactly, and the
streamed volumes of ``InferencePipeline`` over ``[cpu] * 8`` against
JAX's pipeline on its 8-device virtual mesh, with the JAX gens' weights
converted (1e-5: the same float32 convolutions summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import convert
from mpgan_torch.infer import assemble as TA
from mpgan_torch.infer import pipeline as TPP
from mpgan_torch.models import generator as TG
from mpgan_tpu.infer import pipeline as JPP
from mpgan_tpu.models import generator as JG

torch.set_num_threads(1)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def gens():
    """JAX's ``gens`` of ``tests/test_pipeline_parallel.py`` and the port's
    generators with their converted weights."""
    g1 = JG.make_pass1(2, base_filters=8, n_res_blocks=1)
    g2 = JG.make_pass2(2, base_filters=8, n_res_blocks=1)
    g3 = JG.make_pass3(base_filters=8, n_res_blocks=1)
    p1 = g1.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    p2 = g2.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32, 4)))
    p3 = g3.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 4)))
    ported = []
    for make, p in ((TG.make_pass1, p1), (TG.make_pass2, p2),
                    (TG.make_pass3, p3)):
        t = (make(2, base_filters=8, n_res_blocks=1) if make is not
             TG.make_pass3 else make(base_filters=8, n_res_blocks=1))
        t.load_state_dict(convert.flax_to_state_dict(
            jax.tree.map(np.asarray, p)))
        ported.append(t.eval())
    return (g1, p1, g2, p2, g3, p3), ported


def _frames(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.random((8, 8, 8, 4), dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize("n_devices", [1, 2, 3, 5, 7, 8, 16])
@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("up_res", [2, 4, 8])
def test_default_split_equals_jax(n_devices, n_stages, up_res):
    if n_devices < n_stages:
        for fn in (JPP.default_split, TPP.default_split):
            with pytest.raises(ValueError):
                fn(n_devices, n_stages, up_res)
        return
    assert TPP.default_split(n_devices, n_stages, up_res) == \
        JPP.default_split(n_devices, n_stages, up_res)


def test_two_stage_stream_equals_jax(gens):
    (g1, p1, g2, p2, _, _), (t1, t2, _) = gens
    frames = _frames(3)
    jp = JPP.InferencePipeline(g1, p1, g2, p2, up_res=4)
    tp = TPP.InferencePipeline(t1, t2, up_res=4, devices=CPU8)
    assert tp.split == jp.split == (2, 6)
    want = [np.asarray(o) for o in jp.stream(frames)]
    got = list(tp.stream(frames))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape == (32, 32, 32, 1)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5)


def test_three_stage_with_pass3_equals_jax(gens):
    (g1, p1, g2, p2, g3, p3), (t1, t2, t3) = gens
    frame = _frames(1, seed=7)[0]
    jp = JPP.InferencePipeline(g1, p1, g2, p2, up_res=4, gen3=g3,
                               params3=p3)
    tp = TPP.InferencePipeline(t1, t2, up_res=4, devices=CPU8, gen3=t3)
    assert tp.n_stages == 3 and tp.split == jp.split
    np.testing.assert_allclose(tp.submit(frame).numpy(),
                               np.asarray(jp.submit(frame)),
                               rtol=0, atol=1e-5)


def test_explicit_split_and_chunking_equal_upscale_volume(gens):
    _, (t1, t2, _) = gens
    frame = _frames(1, seed=11)[0]
    tp = TPP.InferencePipeline(t1, t2, up_res=4, devices=CPU8, split=(4, 4),
                               chunk=8)
    with torch.inference_mode():
        want = TA.upscale_volume(t1, t2, torch.from_numpy(frame), 4)
    torch.testing.assert_close(tp.submit(frame), want, rtol=0, atol=1e-5)


def test_stream_keeps_order(gens):
    _, (t1, t2, _) = gens
    frames = _frames(5, seed=13)
    tp = TPP.InferencePipeline(t1, t2, up_res=4, devices=CPU8)
    got = [float(o.sum()) for o in tp.stream(frames, depth=2)]
    with torch.inference_mode():
        want = [float(TA.upscale_volume(t1, t2, torch.from_numpy(f), 4).sum())
                for f in frames]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_rejects_bad_configs(gens):
    _, (t1, t2, _) = gens
    with pytest.raises(ValueError, match="pass-2"):
        TPP.InferencePipeline(t1, None, up_res=4, devices=CPU8)
    with pytest.raises(ValueError, match="does not fit"):
        TPP.InferencePipeline(t1, t2, up_res=4, devices=CPU8, split=(8, 2))
    with pytest.raises(ValueError, match="entries"):
        TPP.InferencePipeline(t1, t2, up_res=4, devices=CPU8,
                              split=(2, 2, 4))
    tp = TPP.InferencePipeline(t1, t2, up_res=4, devices=CPU8)
    with pytest.raises(ValueError, match="volumetric"):
        tp.submit(np.zeros((1, 8, 8, 4), np.float32))
