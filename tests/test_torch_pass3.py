"""Pass-3 data and the dataset sweeps of the port vs the JAX package (CPU,
float32): the yz-plane pass-3 batch assembly on injected draws (with and
without temporal neighbours), the tile creator's ``interm``/``final``
sources (shape checks, lazy placement, fallbacks to ``hrz``/``hr``), and
``precompute_intermediates``/``precompute_finals`` against JAX's.

Tolerances: 1e-6 for sample assembly (as tests/test_torch_pipeline.py),
1e-5 for the generator sweeps (as tests/test_torch_infer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import convert
from mpgan_torch.data import pipeline as tpipeline
from mpgan_torch.infer import assemble as TA
from mpgan_torch.models import generator as TG
from mpgan_tpu.data import pipeline as jpipeline
from mpgan_tpu.infer import assemble as JA
from mpgan_tpu.models import generator as JG
from test_torch_pipeline import _datasets, _injected, _jax_sample

torch.set_num_threads(1)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("temporal", [True, False])
def test_sample_pass3_assembly_matches_jax(monkeypatch, temporal):
    tds, jds = _datasets()
    final = np.random.default_rng(11).random(tds.hr.shape, dtype=np.float32)
    tc = tpipeline.TileCreator(tds, 4, density_threshold=0.0, device="cpu",
                               final=final)
    jc = jpipeline.TileCreator(jds, 4, density_threshold=0.0,
                               final=jnp.asarray(final))
    draws = _injected(tc, 3, 12, temporal)
    got = tpipeline.assemble_pass3(tc.lr, tc.final, tc.hr, tc._idx(temporal),
                                   draws, "yz", temporal, tc.st)
    want = _jax_sample(monkeypatch, jpipeline._sample_pass3, draws, jc.lr,
                       jc.final, jc.hr, jc._idx(temporal),
                       jax.random.PRNGKey(0), 3, "yz", temporal, jc.st)
    assert set(got) == set(want)
    assert len(want) == (9 if temporal else 3)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert got["final"].shape == got["hr"].shape == (3, 16, 16, 1)
    assert got["lr_vel"].shape == (3, 16, 16, 3)
    assert not torch.equal(got["final"], got["hr"])


def test_interm_and_final_sources_check_shapes_and_fall_back():
    tds, _ = _datasets()
    n, z = tds.lr.shape[:2]
    hrz_shape = (n, z, *tds.hr.shape[2:])
    with pytest.raises(ValueError, match="interm shape"):
        tpipeline.TileCreator(tds, 4, device="cpu",
                              interm=np.zeros(tds.hr.shape, np.float32))
    with pytest.raises(ValueError, match="final shape"):
        tpipeline.TileCreator(tds, 4, device="cpu",
                              final=torch.zeros(hrz_shape))
    # no sources: interm is hrz, final is hr, and nothing is placed early
    tc = tpipeline.TileCreator(tds, 4, device="cpu")
    assert tc.interm is tc.hrz and tc.final is tc.hr
    interm = torch.rand(hrz_shape, generator=torch.Generator().manual_seed(0))
    final = np.random.default_rng(1).random(tds.hr.shape, dtype=np.float32)
    tc = tpipeline.TileCreator(tds, 4, device="cpu", interm=interm,
                               final=final)
    assert tc._dev == {}                                 # lazy
    assert torch.equal(tc.interm, interm)
    np.testing.assert_array_equal(tc.final.numpy(), final)
    assert "hrz" not in tc._dev
    b = tc.sample_pass2(torch.Generator().manual_seed(2), 2)
    assert b["interm"].shape == (2, 4, 16, 1)
    b = tc.sample_pass3(torch.Generator().manual_seed(3), 2, temporal=True)
    assert b["final_next"].shape == (2, 16, 16, 1)


@pytest.fixture(scope="module")
def chain():
    """Flax G1/G2 at base 8, one res block, 4x, and the port's copies."""
    jg1, jg2 = JG.make_pass1(2, 8, 1), JG.make_pass2(2, 8, 1)
    p1 = jg1.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    p2 = jg2.init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 32, 4)))
    t1, t2 = TG.make_pass1(2, 8, 1), TG.make_pass2(2, 8, 1)
    t1.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, p1)))
    t2.load_state_dict(convert.flax_to_state_dict(
        jax.tree.map(np.asarray, p2)))
    lr = np.random.default_rng(4).random((3, 6, 6, 6, 4), dtype=np.float32)
    return jg1, p1, jg2, p2, t1.eval(), t2.eval(), lr


@pytest.mark.parametrize("stage", [None, 1])
def test_precompute_intermediates_matches_jax(chain, stage):
    jg1, p1, _, _, t1, _, lr = chain
    want = np.asarray(JA.precompute_intermediates(jg1, p1, jnp.asarray(lr),
                                                  stage=stage))
    got = TA.precompute_intermediates(t1, torch.from_numpy(lr), stage=stage)
    assert got.dtype == torch.float32 and not got.is_inference()
    hw = 6 * 2 ** (stage or 2)
    assert got.shape == want.shape == (3, 6, hw, hw, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_precompute_finals_matches_jax(chain):
    jg1, p1, jg2, p2, t1, t2, lr = chain
    want = np.asarray(JA.precompute_finals(jg1, p1, jg2, p2, jnp.asarray(lr),
                                           4))
    got = TA.precompute_finals(t1, t2, torch.from_numpy(lr), 4, chunk=5)
    assert got.dtype == torch.float32 and not got.is_inference()
    assert got.shape == want.shape == (3, 24, 24, 24, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
