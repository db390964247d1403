#!/usr/bin/env python
"""Export bundled generator checkpoints to the PyTorch port's ``.npz`` format.

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py [names...]

Restores each orbax bundle ``examples/checkpoints/<name>`` the way
``tests/test_quality.py`` does (architecture from the bundle's JSON sidecar:
pass, stage and factor; base 32, 2 residual blocks, as every bundle was
trained) and writes ``mpgan_torch/weights/<name>.npz`` (flat
``stem/kernel``-style float32 arrays) plus ``<name>.json`` (``pass_no``,
``stage``, ``up_res``). Default names: the canonical 4x L1 pair
``g1_l1_4x g2_l1_4x``.

This script is JAX-side: the port (``mpgan_torch``) never imports it and
reads only the files it writes.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from mpgan_tpu.utils.platform import honor_jax_platforms_env  # noqa: E402

honor_jax_platforms_env()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402

from mpgan_torch import convert  # noqa: E402
from mpgan_tpu.models import generator as G  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
CKPT_DIR = os.path.join(ROOT, "examples", "checkpoints")
OUT_DIR = os.path.join(ROOT, "mpgan_torch", "weights")
DEFAULT_NAMES = ("g1_l1_4x", "g2_l1_4x")


def restore(name: str):
    """→ (flax params as numpy, sidecar dict) of bundle ``name``."""
    with open(os.path.join(CKPT_DIR, f"{name}.json")) as f:
        meta = json.load(f)
    pass_no, stage, up = meta["pass_no"], meta["stage"], meta["up_res"]
    if pass_no == 1:
        gen, shape = G.make_pass1(stage, 32, 2), (1, 16, 16, 4)
    elif pass_no == 2:
        gen, shape = G.make_pass2(stage, 32, 2), (1, 16, 16 * up, 4)
    else:
        gen, shape = G.make_pass3(32, 2), (1, 128, 128, 4)
    template = gen.init(jax.random.PRNGKey(0), jnp.zeros(shape))
    abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct, template)
    params = ocp.StandardCheckpointer().restore(
        os.path.join(CKPT_DIR, name), abstract)
    return jax.tree.map(np.asarray, params), meta


def export(name: str, out_dir: str = OUT_DIR) -> str:
    params, meta = restore(name)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.npz")
    convert.save_npz(path, params, {
        "pass_no": meta["pass_no"], "stage": meta["stage"],
        "up_res": meta["up_res"], "source": f"examples/checkpoints/{name}"})
    return path


def main(argv=None):
    names = (sys.argv[1:] if argv is None else argv) or DEFAULT_NAMES
    for name in names:
        print(export(name))


if __name__ == "__main__":
    main()
