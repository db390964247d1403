#!/usr/bin/env python
"""Export bundled generator checkpoints to the PyTorch port's ``.npz`` format.

    JAX_PLATFORMS=cpu python scripts/export_torch_weights.py [names...]

Restores each orbax bundle ``examples/checkpoints/<name>`` the way
``tests/test_quality.py`` does (architecture from the bundle's JSON sidecar:
pass, stage and factor; base 32, 2 residual blocks, as every bundle was
trained) and writes ``mpgan_torch/weights/<name>.npz`` (flat
``stem/kernel``-style float32 arrays) plus ``<name>.json`` (``pass_no``,
``stage``, ``up_res``). Eight older bundles have no sidecar; their pass,
stage and factor are those of the quality gate that loads them
(``NO_SIDECAR``). Default names: every bundle in ``examples/checkpoints``.

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
# bundles without a JSON sidecar: (pass_no, stage, up_res) as the gate of
# tests/test_quality.py that restores each builds it (pass 3 records stage
# 1, as the sidecars of the pass-3 bundles do)
NO_SIDECAR = {
    "g1_l1": (1, 2, 4), "g2_l1": (2, 2, 4),            # :67-81
    "g1_gan": (1, 2, 4),                               # :235-243
    "g1_div": (1, 2, 4), "g2_div": (2, 2, 4),          # :245-316
    "g1_gan8": (1, 3, 8), "g2_gan8": (2, 3, 8),        # :381-391
    "g3_l18": (3, 1, 8),                               # :403-405
}


def bundle_names() -> list[str]:
    return sorted(d for d in os.listdir(CKPT_DIR)
                  if os.path.isdir(os.path.join(CKPT_DIR, d)))


def bundle_meta(name: str) -> dict:
    """The bundle's sidecar (``pass_no``, ``stage``, ``up_res``)."""
    if name in NO_SIDECAR:
        return dict(zip(("pass_no", "stage", "up_res"), NO_SIDECAR[name]))
    with open(os.path.join(CKPT_DIR, f"{name}.json")) as f:
        return json.load(f)


def restore(name: str):
    """→ (flax params as numpy, sidecar dict) of bundle ``name``."""
    meta = bundle_meta(name)
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
    names = (sys.argv[1:] if argv is None else argv) or bundle_names()
    for name in names:
        print(export(name))


if __name__ == "__main__":
    main()
