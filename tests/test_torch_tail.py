"""The port's tail tools on the CPU: the TF1 checkpoint import
(``mpgan_torch.utils.tf1_import``, ``python -m mpgan_torch.import_tf1``)
mirrors ``tests/test_tf1_import.py`` on a TF1 Saver checkpoint it writes
itself, and the imported port generator's output equals the JAX import's
(1e-5, float32); ``python -m mpgan_torch.make_gif`` mirrors
``tests/test_make_gif.py``, in process. The TF1 tests skip where
TensorFlow is absent.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpgan_torch import import_tf1, make_gif
from mpgan_torch.config import Config
from mpgan_torch.infer import load
from mpgan_torch.io import uni
from mpgan_torch.models import generator as TG
from mpgan_torch.utils import tf1_import as T
from mpgan_tpu.models import generator as JG

torch.set_num_threads(1)

# a TF1-scoped tiny G1 (stages 2, filters 8, 1 block, 4 input channels)
# whose names sort in the flax leaves' order (tests/test_tf1_import.py)
TF1_VARS = {
    "gen/a_block0/c1/kernel": (3, 3, 8, 8),
    "gen/a_block0/c1/bias": (8,),
    "gen/a_block0/c2/kernel": (3, 3, 8, 8),
    "gen/a_block0/c2/bias": (8,),
    "gen/b_block1/c1/kernel": (3, 3, 8, 8),
    "gen/b_block1/c1/bias": (8,),
    "gen/b_block1/c2/kernel": (3, 3, 8, 8),
    "gen/b_block1/c2/bias": (8,),
    "gen/c_head0/kernel": (3, 3, 8, 1),
    "gen/c_head0/bias": (1,),
    "gen/c_head1/kernel": (3, 3, 8, 1),
    "gen/c_head1/bias": (1,),
    "gen/d_stem/kernel": (3, 3, 4, 8),
    "gen/d_stem/bias": (8,),
}


@pytest.fixture(scope="module")
def tf1_ckpt(tmp_path_factory):
    """A tf.compat.v1 Saver checkpoint, with Adam slots to skip."""
    tf = pytest.importorskip("tensorflow")
    d = tmp_path_factory.mktemp("tf1")
    rng = np.random.default_rng(7)
    values = {n: rng.normal(size=s).astype(np.float32)
              for n, s in TF1_VARS.items()}
    g = tf.Graph()
    with g.as_default():
        tfv = tf.compat.v1
        for name, val in values.items():
            tfv.get_variable(name, initializer=val)
        tfv.get_variable("gen/d_stem/kernel/Adam",
                         initializer=np.zeros((3, 3, 4, 8), np.float32))
        tfv.get_variable("beta1_power", initializer=np.float32(0.9))
        saver = tfv.train.Saver()
        with tfv.Session() as sess:
            sess.run(tfv.global_variables_initializer())
            path = saver.save(sess, os.path.join(str(d), "model.ckpt"))
    return path, values


def _g1():
    return TG.make_pass1(2, base_filters=8, n_res_blocks=1)


def test_reader_excludes_optimizer_slots(tf1_ckpt):
    path, values = tf1_ckpt
    got = T.read_tf1_variables(path)
    assert set(got) == set(values)
    for n, v in values.items():
        np.testing.assert_array_equal(got[n], v)


def test_auto_match_equals_jax_and_reports_ties(tf1_ckpt):
    from mpgan_tpu.utils import tf1_import as J

    path, _ = tf1_ckpt
    tf_vars = T.read_tf1_variables(path)
    gen = JG.make_pass1(2, base_filters=8, n_res_blocks=1)
    params = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    template = T.convert.state_dict_to_flax(_g1().state_dict())
    got = T.auto_match(tf_vars, template)
    assert got == J.auto_match(tf_vars, params)
    mapping, ambiguous = got
    assert "block_0_0/conv1/kernel" in ambiguous
    assert mapping["stem/kernel"] == "gen/d_stem/kernel"
    assert mapping["block_1_0/conv2/bias"] == "gen/b_block1/c2/bias"


def test_imported_generator_equals_jax_import(tf1_ckpt):
    """The port's imported G1 on a seeded input equals JAX's imported G1
    (1e-5). The checkpoint's unit-normal kernels are scaled by 1/√fan-in
    first, so that the outputs are of order one and 1e-5 is a tight
    bound."""
    from mpgan_tpu.utils import tf1_import as J

    path, values = tf1_ckpt
    tf_vars = {n: (v / np.sqrt(np.prod(v.shape[:-1])) if v.ndim > 1
                   else v * 0.1).astype(np.float32)
               for n, v in T.read_tf1_variables(path).items()}
    gen = _g1()
    sd, mapping, _ = T.import_state_dict(tf_vars, gen)
    gen.load_state_dict(sd)
    np.testing.assert_array_equal(
        gen.stem.weight.detach().numpy(),
        tf_vars["gen/d_stem/kernel"].transpose(3, 2, 0, 1))
    jgen = JG.make_pass1(2, base_filters=8, n_res_blocks=1)
    template = jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)))
    jparams, jmapping, _ = J.import_params(tf_vars, template)
    assert mapping == jmapping
    x = np.random.default_rng(1).random((2, 8, 8, 4), dtype=np.float32)
    want = np.asarray(jgen.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 32, 1) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_name_map_overrides_auto(tf1_ckpt):
    path, values = tf1_ckpt
    tf_vars = T.read_tf1_variables(path)
    nm = {"head_0/kernel": "gen/c_head1/kernel",
          "head_1/kernel": "gen/c_head0/kernel"}
    sd, mapping, _ = T.import_state_dict(tf_vars, _g1(), nm)
    np.testing.assert_array_equal(
        sd["head_0.weight"].numpy(),
        values["gen/c_head1/kernel"].transpose(3, 2, 0, 1))
    assert mapping["head_1/kernel"] == "gen/c_head0/kernel"


def test_mismatches_fail_loudly(tf1_ckpt):
    path, _ = tf1_ckpt
    tf_vars = T.read_tf1_variables(path)
    with pytest.raises(ValueError, match="no same-shape TF variable"):
        T.import_state_dict(tf_vars, TG.make_pass1(2, base_filters=16,
                                                   n_res_blocks=1))
    with pytest.raises(KeyError):
        T.import_state_dict(tf_vars, _g1(), {"stem/kernel": "not/in/ckpt"})
    with pytest.raises(ValueError, match="shape mismatch"):
        T.import_state_dict(tf_vars, _g1(),
                            {"stem/kernel": "gen/c_head0/kernel"})
    with pytest.raises(KeyError, match="not in the param template"):
        T.import_state_dict(tf_vars, _g1(), {"typo/conv1/kernel":
                                             "gen/d_stem/kernel"})


def test_auto_match_tiebreak_ignores_dict_order():
    template = {"a/kernel": np.zeros((2, 2), np.float32)}
    for order in (("z/w", "a/w"), ("a/w", "z/w")):
        tf_vars = {n: np.ones((2, 2), np.float32) for n in order}
        assert T.auto_match(tf_vars, template) == ({"a/kernel": "a/w"},
                                                   ["a/kernel"])


def test_import_entry_point_writes_a_loadable_run(tf1_ckpt, tmp_path,
                                                  capsys):
    """``python -m mpgan_torch.import_tf1`` (in process) writes a run
    whose gen_0000 the port's loader restores bit for bit."""
    path, values = tf1_ckpt
    run = import_tf1.main(["ckpt", path, "genPass", "1", "testPath",
                           f"{tmp_path}/runs/", "upRes", "4", "tileSizeLow",
                           "8", "useVelocities", "1", "genFilters", "8",
                           "genBlocks", "1", "dtype", "float32"])
    assert "imported ->" in capsys.readouterr().out
    cfg = Config()
    cfg.train.test_path = f"{tmp_path}/runs/"
    cfg.model.n_base_filters, cfg.model.n_res_blocks = 8, 1
    cfg.model.dtype = "float32"
    gen = load.load_generator(cfg, 1, 0, 0, device="cpu")
    np.testing.assert_array_equal(
        gen.stem.weight.numpy(),
        values["gen/d_stem/kernel"].transpose(3, 2, 0, 1))
    with open(os.path.join(run, "tf1_import_map.json")) as f:
        assert json.load(f)["mapping"]["stem/kernel"] == "gen/d_stem/kernel"


@pytest.fixture()
def sweep_dir(tmp_path):
    rng = np.random.default_rng(0)
    for f in range(3):
        vol = rng.random((6, 8, 10, 1)).astype(np.float32)
        uni.write_density(str(tmp_path / f"source_1000_{f:04d}.uni"),
                          vol[..., 0])
    return tmp_path


def test_gif_from_sweep(sweep_dir):
    from PIL import Image

    out = str(sweep_dir / "anim.gif")
    assert make_gif.main(["dir", str(sweep_dir), "out", out, "axis", "y",
                          "fps", "10"]) == out
    with Image.open(out) as im:
        assert im.n_frames == 3
        assert (im.width, im.height) == (10, 6)  # y-slice of (6, 8, 10)


def test_gif_typo_flag_aborts(sweep_dir, capsys):
    with pytest.raises(SystemExit):
        make_gif.main(["dir", str(sweep_dir), "fpss", "10"])
    assert "fpss" in capsys.readouterr().out


def test_gif_empty_dir_clear_error(tmp_path):
    with pytest.raises(SystemExit, match="no volumes"):
        make_gif.main(["dir", str(tmp_path)])
