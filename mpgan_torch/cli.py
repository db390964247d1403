"""Reference-style command line of the port — counterpart of
``scripts/multipass_gan.py``.

Training (pass 1, 2 or 3), into a new run dir ``<testPath>/test_%04d``::

    python -m mpgan_torch.cli out 0 basePath data/ fromSim 1000 toSim 1009 \\
        upRes 4 tileSizeLow 16 trainingIters 10000 batchSize 16 \\
        saveInterval 1000 firstNN 1 useTempoD 1 randSeed 42

Inference (checkpoints → full 3D volumes as ``.uni``)::

    python -m mpgan_torch.cli out 1 basePath data/ fromSim 1000 toSim 1000 \\
        load_model_test 0 load_model_test2 1 outFrameMin 0 outFrameMax 20

Flags take the reference's names (:func:`mpgan_torch.config.from_cli` and
those read in :func:`main`); an unknown flag aborts. ``device`` (``cuda``
by default) is the only way to the CPU. Flags of pieces not ported yet are
refused by name: ``retryOnError`` and ``hangTimeout`` (the supervisor),
``coordinator``, ``numProcesses`` and ``processId`` (multi-host).
``pipelineSplit`` is parsed and, as in the JAX package on one device, has
no effect; ``compileCache`` names a JAX compile cache and has no effect
here.

The run-dir layout is :mod:`mpgan_torch.train.checkpoint`'s.
"""

from __future__ import annotations

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from mpgan_torch import config as cfgmod
from mpgan_torch import convert
from mpgan_torch.device import resolve_device
from mpgan_torch.train import checkpoint as ckpt
from mpgan_torch.utils import params as ph

# flag → what it belongs to, for the pieces not ported yet; each is refused
# unless it holds its "off" value
_NOT_PORTED = {"retryOnError": "the retryOnError/hangTimeout supervisor",
               "hangTimeout": "the retryOnError/hangTimeout supervisor",
               "coordinator": "multi-host training",
               "numProcesses": "multi-host training",
               "processId": "multi-host training"}
_OFF = {"", "0", "0.0", "-1"}


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    ph.setParams(argv)
    for flag, what in _NOT_PORTED.items():
        if ph.hasParam(flag) and ph.getParam(flag, "") not in _OFF:
            sys.exit(f"{flag}: {what} is not ported to mpgan_torch yet")
    ph.getParam("compileCache", "")          # a JAX compile cache: no effect
    device = ph.getParam("device", "cuda")
    # flags of this entry point, read before from_cli's checkUnusedParams
    load_test2 = int(ph.getParam("load_model_test2", -1))
    load_no2 = int(ph.getParam("load_model_no2", -1))
    load_test3 = int(ph.getParam("load_model_test3", -1))
    load_no3 = int(ph.getParam("load_model_no3", -1))
    pass2_source = ph.getParam("pass2Source", "gt")  # gt | g1
    # trainPass 3 trains the yz refiner; pass3Source model feeds it the
    # frozen two-pass outputs (load_model_test/no = G1, *_2 = G2)
    train_pass = int(ph.getParam("trainPass", 0))    # 0 = use firstNN
    pass3_source = ph.getParam("pass3Source", "gt")  # gt | model
    # resume (pass-2/3 training uses load_model_test/no for the frozen
    # upstream generators, so resume has its own flags)
    resume_test = int(ph.getParam("resumeTest", -1))
    resume_no = int(ph.getParam("resumeNo", -1))
    # the newest same-pass checkpoint under testPath
    resume_latest = int(ph.getParam("resumeLatest", 0))
    # "this training owns run dir test_k": resume it to its original
    # budget, revive it if it died before its first save, or create it
    resume_index = int(ph.getParam("resumeIndex", -1))
    # generator-only warm start from a saved run
    warm_test = int(ph.getParam("warmStartTest", -1))
    warm_no = int(ph.getParam("warmStartNo", -1))
    cfg = cfgmod.from_cli(None)              # parses the installed argv
    if pass2_source not in ("gt", "g1"):
        sys.exit(f"pass2Source {pass2_source!r}: expected gt or g1")
    if pass3_source not in ("gt", "model"):
        sys.exit(f"pass3Source {pass3_source!r}: expected gt or model")
    dev = resolve_device(device)

    if cfg.infer.output_only:
        run_inference(cfg, dev, load_test2, load_no2, load_test3, load_no3)
        return
    pno = train_pass if train_pass else (1 if cfg.train.first_gen_run else 2)
    resume_total = False
    # a supervisor's restarts are scoped to run dirs of its own launch
    resume_min = int(os.environ.get("MPGAN_RESUME_MIN", "-1"))
    run_override = None
    if resume_index >= 0:
        rdir = ckpt.run_dir(cfg.train.test_path, resume_index)
        found = ckpt.latest_resumable(cfg.train.test_path, pass_no=pno,
                                      min_index=resume_index,
                                      max_index=resume_index)
        if found is not None:
            resume_test, resume_no = found
            resume_total = True
            run_override = rdir
            # a complete run exits here, before the dataset load
            meta = ckpt.read_json(ckpt.model_dir(rdir, found[1]) + ".json")
            meta = meta or {}
            total = int(meta.get("total_iters")
                        or cfg.train.training_iters)
            if int(meta.get("it", -1)) >= total:
                print(f"resumeIndex {resume_index}: budget complete "
                      f"(model_{found[1]:04d} at iter {meta['it']}) — "
                      "nothing to do")
                return
            print(f"resumeIndex {resume_index}: resuming "
                  f"model_{found[1]:04d}")
        elif ckpt.latest_model_no(rdir) is not None:
            sys.exit(f"resumeIndex {resume_index}: {rdir} holds checkpoints "
                     f"of another pass (expected pass {pno}) — wrong "
                     "testPath/index")
        else:
            os.makedirs(rdir, exist_ok=True)
            run_override = rdir
            print(f"resumeIndex {resume_index}: fresh start in "
                  f"{os.path.basename(rdir)}")
    elif resume_latest and (resume_test < 0 or resume_min >= 0):
        found = ckpt.latest_resumable(cfg.train.test_path, pass_no=pno,
                                      min_index=resume_min)
        if found is not None:
            resume_test, resume_no = found
            resume_total = True
            # recovery continues in the found run dir, so run indices that
            # later stages pinned stay put
            run_override = ckpt.run_dir(cfg.train.test_path, resume_test)
            print(f"resumeLatest: test_{resume_test:04d}/"
                  f"model_{resume_no:04d}")
        elif resume_test >= 0:
            print(f"resumeLatest: no in-scope checkpoint — honoring "
                  f"explicit resumeTest {resume_test}")
        else:
            # died before its first save: restart into the dead run dir
            run_override = ckpt.recover_run_dir(cfg.train.test_path, pno,
                                                min_index=resume_min)
            if run_override is not None:
                print("resumeLatest: no prior checkpoint — fresh start "
                      f"reusing {os.path.basename(run_override)} (died "
                      "before its first save)")
            else:
                print("resumeLatest: no prior checkpoint — fresh start")
    run_training(cfg, argv, dev, pass2_source, resume_test, resume_no,
                 warm_test, warm_no, train_pass, pass3_source, load_test2,
                 load_no2, resume_total=resume_total,
                 run_override=run_override)


def _preview_batch(tc, pass_no: int, rng: torch.Generator):
    """(generator input, target) of a 4-sample preview batch."""
    from mpgan_torch.train import loop

    sample = {1: tc.sample_pass1, 2: tc.sample_pass2,
              3: tc.sample_pass3}[pass_no]
    b = sample(rng, 4)
    return loop.g_input(b, pass_no), b["hr"]


def run_training(cfg, argv, dev: torch.device, pass2_source: str = "gt",
                 resume_test: int = -1, resume_no: int = -1,
                 warm_test: int = -1, warm_no: int = -1,
                 train_pass: int = 0, pass3_source: str = "gt",
                 load_test2: int = -1, load_no2: int = -1,
                 resume_total: bool = False,
                 run_override: str | None = None) -> str:
    """Train one pass into a run dir (``multipass_gan.py:330-542``):
    periodic checkpoints every ``saveInterval`` iterations and a final one,
    each sidecar with the run's ``total_iters``; metrics and preview grids
    every ``outputInterval``. → the run dir."""
    from mpgan_torch.data.loader import FluidDataLoader
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.infer import assemble
    from mpgan_torch.infer.load import load_generator
    from mpgan_torch.train.loop import Trainer
    from mpgan_torch.utils import preview

    dcfg = cfg.data
    ds = FluidDataLoader(dcfg.base_path, dcfg.from_sim, dcfg.to_sim,
                         dcfg.frame_min, dcfg.frame_max, dcfg.use_velocities,
                         dcfg.data_fraction,
                         use_vorticities=dcfg.use_vorticities,
                         mac_recenter=dcfg.mac_recenter).get()
    pass_no = train_pass if train_pass else (
        1 if cfg.train.first_gen_run else 2)

    final = interm = None
    if (pass_no == 2 and pass2_source == "g1"
            or pass_no == 3 and pass3_source == "model"):
        gen1 = load_generator(cfg, 1, cfg.train.load_model_test,
                              cfg.train.load_model_no, dev)
        lr = torch.from_numpy(ds.lr).to(dev)
        if pass_no == 2:
            # G2 on frozen-G1 outputs: one sweep makes the pass-2 inputs
            interm = assemble.precompute_intermediates(gen1, lr)
            print(f"precomputed {interm.shape[0]} G1 intermediate volumes")
        else:
            gen2 = load_generator(cfg, 2, load_test2, load_no2, dev)
            final = assemble.precompute_finals(gen1, gen2, lr, dcfg.up_res)
            print(f"precomputed {final.shape[0]} two-pass output volumes")
        del lr

    tc = TileCreator(ds, dcfg.tile_size_low, dcfg.density_threshold,
                     dcfg.augment, dcfg.rot_mode, dcfg.scale_min,
                     dcfg.scale_max, device=dev, interm=interm, final=final)
    run = run_override or ckpt.next_run_dir(cfg.train.test_path)
    run_file = os.environ.get("MPGAN_RUN_FILE")
    if run_file:
        # tell a supervisor which run dir this attempt owns
        with open(run_file, "w") as f:
            f.write(run)
    ckpt.save_param_log(run, cfg, argv, pass_no=pass_no)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"run dir: {run}; device: {dev} ({name}); pass {pass_no}")

    # the sidecars record the absolute target, known after the resume logic
    budget = {"total_iters": cfg.train.training_iters}

    def on_checkpoint(trainer, it):
        no = it // cfg.train.save_interval
        trainer.save(run, no, it, total_iters=budget["total_iters"])
        print(f"  saved model_{no:04d} at iter {it}")

    writer = preview.MetricsWriter(run)
    preview_rng = torch.Generator(device=dev).manual_seed(12345)

    def on_log(trainer, metrics):
        print("  " + " ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                              f"{k}={v}" for k, v in sorted(metrics.items())))
        writer.write(metrics)
        # [input | generated | target] patch grid
        rt = trainer.rt
        x_in, hr = _preview_batch(tc, trainer.pass_no, preview_rng)
        with torch.no_grad():
            fake = rt.gen(x_in, stage=rt.stage)

        def host(t):
            return t.detach().to("cpu", torch.float32).numpy()
        preview.save_patch_grid(
            os.path.join(run, f"preview_{metrics['it'] + 1:06d}.png"),
            [host(x_in[..., 0:1]), host(fake), host(hr)])

    tr = Trainer(cfg, tc, device=dev, pass_no=pass_no)
    start_it = 0
    if warm_test >= 0:
        # fresh optimizers and discriminators, the generator's weights from
        # a saved run
        prev_run = ckpt.run_dir(cfg.train.test_path, warm_test)
        no = warm_no if warm_no >= 0 else ckpt.latest_model_no(prev_run)
        if no is None:
            sys.exit(f"warmStartTest {warm_test}: no saved checkpoints in "
                     f"{prev_run}")
        rt = tr.rt = tr._init_stage(tr.n_stages, None)
        flat, _ = convert.load_npz(ckpt.gen_path(prev_run, no))
        rt.gen.load_state_dict(convert.flax_to_state_dict(flat))
        for k, p in rt.gen.named_parameters():  # restart the average
            if k in rt.ema:
                rt.ema[k].copy_(p.detach())
        print(f"warm-started generator from {prev_run}/gen_{no:04d}")
    if pass_no == 1 and warm_test < 0 and resume_test < 0 \
            and cfg.train.load_model_test >= 0:
        # pass 1: load_model_* resumes training (the reference's meaning);
        # for passes 2/3 they name the frozen upstream generators
        resume_test, resume_no = (cfg.train.load_model_test,
                                  cfg.train.load_model_no)
    total_iters = cfg.train.training_iters
    if resume_test >= 0:
        prev_run = ckpt.run_dir(cfg.train.test_path, resume_test)
        no = resume_no if resume_no >= 0 else ckpt.latest_model_no(prev_run)
        if no is None:
            sys.exit(f"resume from test_{resume_test:04d}: no saved "
                     f"checkpoints in {prev_run}")
        start_it = tr.restore(prev_run, no)
        if resume_total:
            # recovery finishes the original budget, which the dead run's
            # sidecar records
            meta = ckpt.read_json(ckpt.model_dir(prev_run, no) + ".json")
            recorded = int((meta or {}).get("total_iters", -1))
            total_iters = (recorded if recorded > 0
                           else max(cfg.train.training_iters, start_it))
        else:
            total_iters = start_it + cfg.train.training_iters  # additional
        print(f"resumed from {prev_run}/model_{no:04d} at iter {start_it}; "
              f"training to {total_iters}")
    budget["total_iters"] = total_iters
    try:
        last = tr.fit(iters=total_iters, on_log=on_log, start_it=start_it,
                      on_checkpoint=on_checkpoint)
    finally:
        writer.close()
    latest = ckpt.latest_model_no(run)
    if not last and latest is not None:
        # no iteration ran, and the dir already holds this state
        print(f"budget already complete (model_{latest:04d}); no new "
              "checkpoint")
        print(f"done: {last}")
        return run
    # the final checkpoint: the next free number after the periodic ones
    no = latest + 1 if latest is not None else 0
    tr.save(run, no, total_iters, total_iters=budget["total_iters"])
    print(f"done: {last}")
    return run


def run_inference(cfg, dev: torch.device, load_test2: int, load_no2: int,
                  load_test3: int = -1, load_no3: int = -1) -> str:
    """Checkpoints → full-volume SR sweep (``multipass_gan.py:552-677``):
    frame f+1 is read in a reader thread while the card upscales frame f,
    and the atomic ``.uni``/PNG writes drain through a writer thread. With
    ``writeTest k`` the sweep writes into ``test_k`` and skips frames whose
    outputs all exist. → the output run dir."""
    from mpgan_torch.infer.load import (load_pass_chain,
                                        make_default_upscaler, read_lr_frame)
    from mpgan_torch.io import uni
    from mpgan_torch.serve import _to_host
    from mpgan_torch.utils import preview

    chain = load_pass_chain(cfg, load_test2, load_no2, load_test3, load_no3,
                            device=dev)
    if cfg.infer.write_test >= 0:
        out_dir = ckpt.run_dir(cfg.train.test_path, cfg.infer.write_test)
        os.makedirs(out_dir, exist_ok=True)
    else:
        out_dir = ckpt.next_run_dir(cfg.train.test_path)
    upscale = make_default_upscaler(cfg, chain, dev)

    def read_frame(sim, f):
        return read_lr_frame(cfg, os.path.join(cfg.data.base_path,
                                               f"sim_{sim:04d}"), f)

    def write_frame(out, hr):
        if cfg.infer.write_uni:
            uni.write_density(out, hr[..., 0])
        if cfg.infer.write_png:
            mid = hr[hr.shape[0] // 2, :, :, 0]
            preview.save_png(out[:-4] + ".png", preview.norm_u8(mid[::-1]))

    def frame_done(sim, f):
        # every requested artifact must exist: a crash between the .uni and
        # the .png write must not skip the half-done frame
        base = os.path.join(out_dir, f"source_{sim:04d}_{f:04d}")
        want = ([base + ".uni"] if cfg.infer.write_uni else []) + \
               ([base + ".png"] if cfg.infer.write_png else [])
        return bool(want) and all(os.path.exists(w) for w in want)

    frames = [(sim, f)
              for sim in range(cfg.data.from_sim, cfg.data.to_sim + 1)
              for f in range(cfg.infer.frame_min, cfg.infer.frame_max)]
    if cfg.infer.write_test >= 0:
        todo = [sf for sf in frames if not frame_done(*sf)]
        if len(todo) < len(frames):
            print(f"writeTest {cfg.infer.write_test}: skipping "
                  f"{len(frames) - len(todo)} already-written frames")
        frames = todo
    with ThreadPoolExecutor(1) as reader, ThreadPoolExecutor(1) as writer:
        pending = []
        nxt = reader.submit(read_frame, *frames[0]) if frames else None
        for i, (sim, f) in enumerate(frames):
            lr_np = nxt.result()
            if i + 1 < len(frames):
                nxt = reader.submit(read_frame, *frames[i + 1])
            if lr_np is None:
                continue
            hr = _to_host(upscale(lr_np))
            out = os.path.join(out_dir, f"source_{sim:04d}_{f:04d}.uni")
            # bound the writes in flight: each holds a full HR volume
            while len(pending) >= 3:
                pending.pop(0).result()
            pending.append(writer.submit(write_frame, out, hr))
            print(f"sim {sim} frame {f}: {lr_np.shape[:3]} -> "
                  f"{hr.shape[:3]} -> {out}")
        for p in pending:
            p.result()
    print(f"inference outputs in {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
