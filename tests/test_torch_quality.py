"""Every bundled checkpoint in the port, on the CPU in float32.

- each bundle's export in ``mpgan_torch/weights`` equals its orbax bundle
  bit for bit (the JAX generator rebuilt at the pass and stage the export's
  sidecar records, so a wrong sidecar fails the restore);
- each bundle's chain (the pass chain of the gate that loads it) on an 8³
  LR crop of the gate's frame equals the JAX chain to 1e-4;
- every bundle that ``tests/test_quality.py`` gates has an export and a
  port gate (``mpgan_torch.quality.GATES``) over the same chain;
- the port's gates whose frames are small enough for the CPU (sim_3020,
  16³ → 64³) pass their floors at full frame. The others upscale to 128³,
  seconds a frame on a CPU, and run on the card (``chip_smoke.py`` phase
  9).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from mpgan_torch import convert, quality
from mpgan_torch.infer import assemble as TA
from mpgan_torch.infer import load as TL
from mpgan_tpu.infer import assemble as JA
from mpgan_tpu.models import generator as JG

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CKPT_DIR = os.path.join(ROOT, "examples", "checkpoints")
BUNDLES = sorted(d for d in os.listdir(CKPT_DIR)
                 if os.path.isdir(os.path.join(CKPT_DIR, d)))
CPU_GATES = ("test_4x_diverse_model_temporal_coherence",
             "test_4x_diverse_model_ood_generalization_floor")
_RESTORED = {}


def _orbax_restore(name):
    """(JAX generator, params) of bundle ``name`` at the pass and stage of
    its export's sidecar; cached for the module."""
    if name not in _RESTORED:
        _, meta = convert.load_npz(TL.bundled_weights(name))
        pass_no, stage, up = meta["pass_no"], meta["stage"], meta["up_res"]
        if pass_no == 1:
            g, shape = JG.make_pass1(stage, 32, 2), (1, 16, 16, 4)
        elif pass_no == 2:
            g, shape = JG.make_pass2(stage, 32, 2), (1, 16, 16 * up, 4)
        else:
            g, shape = JG.make_pass3(32, 2), (1, 128, 128, 4)
        template = g.init(jax.random.PRNGKey(0), jnp.zeros(shape))
        abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
        params = ocp.StandardCheckpointer().restore(
            os.path.abspath(os.path.join(CKPT_DIR, name)), abstract)
        _RESTORED[name] = (g, params)
    return _RESTORED[name]


def _gate_of(name):
    """(gate, chain) of the first port gate whose chains hold ``name``."""
    for gate in quality.GATES.values():
        for chain in gate.chains:
            if name in chain:
                return gate, chain
    raise KeyError(name)


@pytest.mark.parametrize("name", BUNDLES)
def test_export_equals_orbax_bundle(name):
    _, params = _orbax_restore(name)
    flat, meta = convert.load_npz(TL.bundled_weights(name))
    want = convert.flatten_params(jax.tree.map(np.asarray, params))
    assert set(flat) == set(want)
    for k in want:
        assert flat[k].dtype == np.float32
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)
    gate, _ = _gate_of(name)
    assert meta["up_res"] == gate.up
    if meta["pass_no"] != 3:
        assert 2 ** meta["stage"] == gate.up


@pytest.mark.parametrize("name", BUNDLES)
def test_chain_on_a_crop_matches_jax(name):
    gate, names = _gate_of(name)
    lr, _ = quality.read_frame(gate.sim, gate.frames[0])
    c = [(n - 8) // 2 for n in lr.shape[:3]]
    lr = np.ascontiguousarray(lr[c[0]:c[0] + 8, c[1]:c[1] + 8, c[2]:c[2] + 8])
    jax_chain = [_orbax_restore(n) for n in names] + [(None, None)]
    (jg1, p1), (jg2, p2), (jg3, p3) = jax_chain[:3]
    want = np.asarray(JA.upscale_volume(jg1, p1, jg2, p2, jnp.asarray(lr),
                                        up_res=gate.up, gen3=jg3, params3=p3))
    chain = quality.load_chain(names, "cpu")
    with torch.inference_mode():
        got = TA.upscale_volume(chain[0], chain[1], torch.from_numpy(lr),
                                gate.up, gen3=chain[2]).numpy()
    assert got.shape == want.shape == (8 * gate.up,) * 3 + (1,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_every_gated_bundle_is_exported_and_gated_by_the_port():
    spec = importlib.util.spec_from_file_location(
        "jax_quality_gates", os.path.join(ROOT, "tests", "test_quality.py"))
    jq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jq)
    assert set(jq.GATED_CKPTS) == set(BUNDLES) == set(TL.bundled_names())
    for name, gate_name in jq.GATED_CKPTS.items():
        gate = quality.GATES[gate_name]
        assert any(name in chain for chain in gate.chains), (name, gate_name)
        assert TL.load_bundled(name, device="cpu") is not None
    assert set(quality.GATES) == set(jq.GATED_CKPTS.values()) | {
        "test_4x_diverse_model_temporal_coherence"}


@pytest.mark.parametrize("name", CPU_GATES)
def test_port_gate_passes_at_full_frame(name):
    records = quality.run_gate(name, "cpu")
    assert records
    for rec in records:
        for floor in rec["floors"]:
            assert floor["ok"], (name, rec["chain"], floor)
