"""Import a reference TF1 ``tf.train.Saver`` checkpoint as a generator run
(counterpart of ``scripts/import_tf1.py``).

    python -m mpgan_torch.import_tf1 ckpt /path/to/model.ckpt genPass 1 \\
        testPath runs/ upRes 4 tileSizeLow 16 useVelocities 1 \\
        [nameMap map.json]   # flax "block_0_0/conv1/kernel" -> TF name

It writes ``<testPath>/test_%04d/gen_0000`` (the ``.npz`` + sidecar that
``python -m mpgan_torch.cli out 1`` and :func:`mpgan_torch.infer.load.
load_generator` read), ``params.json`` and ``tf1_import_map.json``.
Without ``nameMap`` the variables are auto-matched by shape (ties are
printed for review; pin them with a map). The model flags (``stages``,
``genFilters``, ``genBlocks``, ``upRes``, …) must describe the reference
architecture. A host tool: it needs TensorFlow and no card.
"""

from __future__ import annotations

import json
import os
import sys

from mpgan_torch.utils import params as ph


def main(argv: list[str] | None = None) -> str:
    if argv is not None:
        ph.setParams(argv)
    ckpt_path = str(ph.getParam("ckpt", ""))
    pass_no = int(ph.getParam("genPass", 1))
    name_map_path = str(ph.getParam("nameMap", ""))
    if not ckpt_path:
        sys.exit("usage: python -m mpgan_torch.import_tf1 ckpt "
                 "<tf1-ckpt-prefix> genPass <1|2|3> testPath <dir> "
                 "[model/data flags] [nameMap map.json]")

    from mpgan_torch import config as cfgmod
    from mpgan_torch.infer.load import input_channels
    from mpgan_torch.models import generator as G
    from mpgan_torch.train import checkpoint as ckpt
    from mpgan_torch.utils import tf1_import

    cfg = cfgmod.from_cli(None)
    mcfg = cfg.model
    kw = dict(base_filters=mcfg.n_base_filters,
              n_res_blocks=mcfg.n_res_blocks,
              in_channels=input_channels(cfg, pass_no))
    if pass_no == 1:
        gen = G.make_pass1(mcfg.stages, **kw)
    elif pass_no == 2:
        gen = G.make_pass2(mcfg.stages, **kw)
    else:
        gen = G.make_pass3(**kw)

    name_map = None
    if name_map_path:
        with open(name_map_path) as f:
            name_map = json.load(f)
    tf_vars = tf1_import.read_tf1_variables(ckpt_path)
    print(f"checkpoint {ckpt_path}: {len(tf_vars)} model variables")
    sd, mapping, ambiguous = tf1_import.import_state_dict(tf_vars, gen,
                                                          name_map)
    for key in ambiguous:
        print(f"  ambiguous (shape-tied, first-name match): {key} <- "
              f"{mapping[key]}")
    gen.load_state_dict(sd, strict=True)

    run = ckpt.next_run_dir(cfg.train.test_path)
    stage = 1 if pass_no == 3 else mcfg.stages
    ckpt.save_gen(run, 0, gen.state_dict(),
                  dict(pass_no=pass_no, stage=stage, up_res=cfg.data.up_res))
    ckpt.save_param_log(run, cfg, sys.argv[1:] if argv is None else argv)
    ckpt.write_json(os.path.join(run, "tf1_import_map.json"),
                    {"source": os.path.abspath(ckpt_path), "pass": pass_no,
                     "mapping": mapping})
    idx = int(os.path.basename(run).split("_")[1])
    suffix = "" if pass_no == 1 else str(pass_no)
    print(f"imported -> {run}/gen_0000 (pass {pass_no}); use e.g. "
          f"`out 1 load_model_test{suffix} {idx} load_model_no{suffix} 0`")
    return run


if __name__ == "__main__":
    main()
