"""Reference-style command line of the port — counterpart of
``scripts/multipass_gan.py``.

Training (pass 1, 2 or 3), into a new run dir ``<testPath>/test_%04d``::

    python -m mpgan_torch.cli out 0 basePath data/ fromSim 1000 toSim 1009 \\
        upRes 4 tileSizeLow 16 trainingIters 10000 batchSize 16 \\
        saveInterval 1000 firstNN 1 useTempoD 1 randSeed 42

Inference (checkpoints → full 3D volumes as ``.uni``)::

    python -m mpgan_torch.cli out 1 basePath data/ fromSim 1000 toSim 1000 \\
        load_model_test 0 load_model_test2 1 outFrameMin 0 outFrameMax 20

Unattended runs: with ``retryOnError N`` a supervising parent runs the
work as a child (``python -m mpgan_torch.cli`` with the same flags) and
restarts it up to N times when it dies, training with ``resumeIndex`` of
the run dir it owned (``resumeLatest 1`` if it died before allocating
one) and inference into a pinned ``writeTest`` dir that skips the frames
already written. ``hangTimeout S`` also kills a child whose heartbeat has
been silent for S seconds (:mod:`mpgan_torch.utils.supervise`). The parent
never touches the card.

Flags take the reference's names (:func:`mpgan_torch.config.from_cli` and
those read in :func:`main`); an unknown flag aborts. ``device`` (``cuda``
by default) is the only way to the CPU. ``compileCache`` names a JAX
compile cache and has no effect here.

Parallelism, as the JAX package's ``make_mesh()`` takes every chip:
- ``out 0`` trains data-parallel with one rank (process) per visible card
  (``CUDA_VISIBLE_DEVICES`` limits them), NCCL between them
  (:mod:`mpgan_torch.train.loop`). On a host with one card it runs in this
  process.
- ``coordinator host:port numProcesses N processId I`` joins a job of N
  host processes; each starts one rank per visible card, global rank I ×
  (cards per host) + local rank. With ``device cpu`` each host process is
  one gloo rank.
- ``out 1`` splits each pass's slices over every visible card
  (:func:`mpgan_torch.infer.assemble.apply_sliced`), or with
  ``pipelineSplit auto`` (or ``a,b[,c]`` cards per pass) runs the passes
  as a pipeline of card groups (:mod:`mpgan_torch.infer.pipeline`) when
  more than one card is visible.

The run-dir layout is :mod:`mpgan_torch.train.checkpoint`'s.
"""

from __future__ import annotations

import os
import re
import socket
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from mpgan_torch import config as cfgmod
from mpgan_torch import convert
from mpgan_torch.device import resolve_device
from mpgan_torch.parallel import mesh as pmesh
from mpgan_torch.train import checkpoint as ckpt
from mpgan_torch.utils import params as ph
from mpgan_torch.utils.liveness import touch_heartbeat

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(local_rank: int, argv: list[str]) -> None:
    """A spawned training rank: :func:`main` on card ``local_rank``."""
    os.environ["MPGAN_LOCAL_RANK"] = str(local_rank)
    main(argv)


def _join_ranks(argv: list[str], dev: torch.device, coordinator: str,
                num_processes: int, process_id: int) -> torch.device | None:
    """Make this process one rank of the training job the flags describe
    → the rank's device; None when it started one rank per card itself
    (spawned processes, joined before it returns)."""
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    multi = bool(coordinator or num_processes)
    if not multi and local <= 1:
        return dev
    local_rank = os.environ.get("MPGAN_LOCAL_RANK")
    if local_rank is None and local > 1:
        if not multi:   # one host: a job of one process over its cards
            argv = argv + ["coordinator", f"127.0.0.1:{_free_port()}",
                           "numProcesses", "1", "processId", "0"]
        print(f"data-parallel training: {local} ranks, one per card",
              flush=True)
        torch.multiprocessing.start_processes(
            _rank_entry, args=(argv,), nprocs=local, start_method="spawn")
        return None
    if not coordinator or num_processes < 1:
        sys.exit("coordinator host:port and numProcesses N go together")
    if process_id < 0:
        if num_processes > 1:
            sys.exit(f"processId is required with numProcesses "
                     f"{num_processes}")
        process_id = 0
    lr = int(local_rank or 0)
    if dev.type == "cuda":
        dev = torch.device("cuda", lr)
        torch.cuda.set_device(dev)
    pmesh.init_distributed(coordinator, num_processes * local,
                           process_id * local + lr, pmesh.backend_for(dev))
    return dev


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    ph.setParams(argv)
    # read here, so that the child's checkUnusedParams sees them consumed;
    # hangTimeout alone (retryOnError 0) arms the watchdog without restarts
    retry_budget = int(ph.getParam("retryOnError", 0))
    hang_timeout = float(ph.getParam("hangTimeout", 0))
    if ((retry_budget > 0 or hang_timeout > 0)
            and not os.environ.get("MPGAN_TRAIN_CHILD")):
        if ph.getParam("coordinator", "") or int(ph.getParam("numProcesses",
                                                             0)):
            sys.exit(
                "retryOnError/hangTimeout do not support multi-host "
                "(coordinator/numProcesses) jobs: per-host supervisors would "
                "race run-dir allocation and restart one host's process into "
                "a distributed job whose peers are blocked in the old run's "
                "collectives. Supervise and relaunch the whole job "
                "externally instead.")
        # out 2 is inference too (bool(out), as config reads it)
        sys.exit(_supervise(
            argv, max(retry_budget, 0), hang_timeout,
            infer=bool(int(ph.getParam("out", ph.getParam("outputOnly",
                                                          0))))))
    # multi-host (JAX scripts/multipass_gan.py:74-82)
    coordinator = str(ph.getParam("coordinator", ""))
    num_processes = int(ph.getParam("numProcesses", 0))
    process_id = int(ph.getParam("processId", -1))
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
        if coordinator or num_processes:
            sys.exit("out 1 runs on one host (over every card it sees); "
                     "coordinator/numProcesses are for training")
        run_inference(cfg, dev, load_test2, load_no2, load_test3, load_no3)
        return
    dev = _join_ranks(argv, dev, coordinator, num_processes, process_id)
    if dev is None:
        return
    try:
        _train_main(cfg, argv, dev, pass2_source, pass3_source, train_pass,
                    resume_test, resume_no, resume_latest, resume_index,
                    warm_test, warm_no, load_test2, load_no2)
    finally:
        pmesh.shutdown()


def _train_main(cfg, argv, dev, pass2_source, pass3_source, train_pass,
                resume_test, resume_no, resume_latest, resume_index,
                warm_test, warm_no, load_test2, load_no2) -> None:
    """``out 0`` on this rank: the resume flags, then :func:`run_training`."""
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


def _strip_flag(argv: list[str], name: str) -> list[str]:
    """Remove ``name <value>`` pairs from a reference-style flag list
    (case-insensitive, as ``getParam`` reads flags)."""
    out, skip = [], False
    for tok in argv:
        if skip:
            skip = False
            continue
        if tok.lower() == name.lower():
            skip = True
            continue
        out.append(tok)
    return out


def _has_flag(argv: list[str], name: str) -> bool:
    """True if the flag appears in argv (case-insensitive)."""
    return any(tok.lower() == name.lower() for tok in argv)


def _next_run_index(test_path: str, create: bool = False) -> int:
    """The next free ``test_%04d`` index under ``test_path``; ``create``
    reserves its dir (inference pinning), training leaves that to the
    child."""
    os.makedirs(test_path, exist_ok=True)
    newest = ckpt.latest_run_idx(test_path)
    idx = 0 if newest is None else newest + 1
    if create:
        os.makedirs(ckpt.run_dir(test_path, idx))
    return idx


def _owned_run_index(run_file: str | None) -> int | None:
    """The ``test_%04d`` index a training child reported owning through
    ``MPGAN_RUN_FILE`` (None when it died before allocating one)."""
    if not run_file or not os.path.exists(run_file):
        return None
    try:
        with open(run_file) as f:
            base = os.path.basename(f.read().strip())
    except OSError:
        return None
    m = re.fullmatch(r"test_(\d{4})", base)
    return int(m.group(1)) if m else None


def _supervise(argv: list[str], retries: int, hang_timeout: float = 0.0,
               infer: bool = False) -> int:
    """Restart a dead or hung child up to ``retries`` times (JAX
    ``scripts/multipass_gan.py:240-327``) → the last exit code (0 on a
    clean finish).

    A training child restarts on exactly the run dir it reported owning
    (``MPGAN_RUN_FILE``: ``resumeIndex`` of that dir), or, when it died
    before allocating one, with ``resumeLatest 1`` scoped by
    ``MPGAN_RESUME_MIN`` to run dirs this launch creates, so that an older
    run under the same testPath never hijacks recovery. An inference child
    writes into a ``writeTest`` dir pinned here and skips the frames
    already written. ``hang_timeout`` > 0 also kills a child whose
    heartbeat is stale that long.
    """
    from mpgan_torch.utils import supervise

    env = dict(os.environ, MPGAN_TRAIN_CHILD="1")
    # the child imports this package from where the parent found it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    delay = float(os.environ.get("MPGAN_RETRY_DELAY_S", "30"))
    base_argv = list(argv)
    test_path = ph.getParam("testPath", "test_out/")
    if infer and not _has_flag(base_argv, "writeTest"):
        idx = _next_run_index(test_path, create=True)
        base_argv += ["writeTest", str(idx)]
        print(f"retryOnError: inference outputs pinned to test_{idx:04d} "
              f"(writeTest {idx})", flush=True)
    resume_min = None if infer else _next_run_index(test_path)
    run_file = None
    if not infer:
        run_file = os.path.join(test_path, f".rundir_{os.getpid()}")
        env["MPGAN_RUN_FILE"] = run_file
    heartbeat = None
    if hang_timeout > 0:
        os.makedirs(test_path, exist_ok=True)
        heartbeat = os.path.join(test_path, f".heartbeat_{os.getpid()}")
        env["MPGAN_HEARTBEAT"] = heartbeat
    failures = 0
    try:
        while True:
            args = list(base_argv)
            attempt_env = dict(env)
            if failures and not infer:
                owned = _owned_run_index(run_file)
                if owned is not None:
                    args = (_strip_flag(_strip_flag(args, "resumeLatest"),
                                        "resumeIndex")
                            + ["resumeIndex", str(owned)])
                else:
                    args = (_strip_flag(args, "resumeLatest")
                            + ["resumeLatest", "1"])
                    attempt_env["MPGAN_RESUME_MIN"] = str(resume_min)
            cmd = [sys.executable, "-m", "mpgan_torch.cli"] + args
            if heartbeat:
                rc = supervise.run_child_watched(cmd, attempt_env,
                                                 hang_timeout, heartbeat)
            else:
                rc = supervise.run_child(cmd, attempt_env)
            if rc == 0:
                return 0
            failures += 1
            if failures > retries:
                print(f"retryOnError: giving up after {failures} failures "
                      f"(last rc={rc})", flush=True)
                return rc
            kind = "inference" if infer else "training"
            how = "skipping done frames" if infer else "resuming its run dir"
            print(f"retryOnError: {kind} child died (rc={rc}); restarting "
                  f"{how} in {delay:g}s [{failures}/{retries}]", flush=True)
            time.sleep(delay)
    finally:
        if heartbeat and os.path.exists(heartbeat):
            os.remove(heartbeat)
        if run_file and os.path.exists(run_file):
            os.remove(run_file)


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
    every ``outputInterval``. In a data-parallel job every rank trains and
    the lead alone writes files. → the run dir."""
    from mpgan_torch.data.loader import FluidDataLoader
    from mpgan_torch.data.pipeline import TileCreator
    from mpgan_torch.infer import assemble
    from mpgan_torch.infer.load import load_generator
    from mpgan_torch.train.loop import Trainer, replicate_state
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
    lead = pmesh.is_lead()
    run_file = os.environ.get("MPGAN_RUN_FILE")
    if run_file and lead:
        # tell a supervisor which run dir this attempt owns
        with open(run_file, "w") as f:
            f.write(run)
    if lead:
        ckpt.save_param_log(run, cfg, argv, pass_no=pass_no)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"run dir: {run}; device: {dev} ({name}); rank {pmesh.rank()} of "
          f"{pmesh.world()}; pass {pass_no}")

    # the sidecars record the absolute target, known after the resume logic
    budget = {"total_iters": cfg.train.training_iters}

    def on_checkpoint(trainer, it):
        no = it // cfg.train.save_interval
        trainer.save(run, no, it, total_iters=budget["total_iters"])
        if lead:
            print(f"  saved model_{no:04d} at iter {it}")

    writer = preview.MetricsWriter(run) if lead else None
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
        replicate_state(rt)
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
        last = tr.fit(iters=total_iters, on_log=on_log if lead else None,
                      start_it=start_it, on_checkpoint=on_checkpoint)
    finally:
        if writer is not None:
            writer.close()
    # the lead's listing decides: ranks on hosts without one shared
    # filesystem could disagree
    latest = ckpt.latest_model_no(run) if lead else None
    latest = pmesh.broadcast_int(-1 if latest is None else latest)
    latest = None if latest < 0 else latest
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
    outputs all exist. With ``pipelineSplit`` (``auto`` or ``a,b[,c]``)
    and more than one visible card the passes run as a pipeline of card
    groups, ``n_stages`` frames in flight. Each written frame touches the
    heartbeat; ``MPGAN_FAIL_ONCE`` crashes the sweep once, after its first
    frame is written. → the output run dir."""
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
    pp = upscale = None
    if (cfg.infer.pipeline_split and chain[1] is not None
            and dev.type == "cuda" and torch.cuda.device_count() > 1):
        from mpgan_torch.infer.pipeline import InferencePipeline

        spec = cfg.infer.pipeline_split
        split = (None if spec == "auto"
                 else [int(v) for v in spec.split(",")])
        pp = InferencePipeline(chain[0], chain[1], cfg.data.up_res,
                               split=split, chunk=cfg.infer.slice_chunk,
                               gen3=chain[2])
        print(f"pipeline-parallel inference: {pp.n_stages} stages, split "
              f"{pp.split}")
    else:
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

        def flush(sim, f, hr, lr_shape):
            hr = _to_host(hr)
            out = os.path.join(out_dir, f"source_{sim:04d}_{f:04d}.uni")
            # bound the writes in flight: each holds a full HR volume
            while len(pending) >= 3:
                pending.pop(0).result()
            pending.append(writer.submit(write_frame, out, hr))
            touch_heartbeat()
            print(f"sim {sim} frame {f}: {lr_shape} -> {hr.shape[:3]} -> "
                  f"{out}")
            # fault injection for recovery tests: crash once, after the
            # first frame is durably written
            fail_once = os.environ.get("MPGAN_FAIL_ONCE")
            if fail_once and not os.path.exists(fail_once):
                pending[-1].result()
                with open(fail_once, "w") as fh:
                    fh.write(f"injected at sim {sim} frame {f}\n")
                raise RuntimeError(f"MPGAN_FAIL_ONCE: injected fault after "
                                   f"writing sim {sim} frame {f}")

        inflight = []   # pipeline: (sim, f, volume in flight, LR shape)
        nxt = reader.submit(read_frame, *frames[0]) if frames else None
        for i, (sim, f) in enumerate(frames):
            lr_np = nxt.result()
            if i + 1 < len(frames):
                nxt = reader.submit(read_frame, *frames[i + 1])
            if lr_np is None:
                continue
            if pp is not None:
                inflight.append((sim, f, pp.submit(lr_np), lr_np.shape[:3]))
                if len(inflight) > pp.n_stages:
                    flush(*inflight.pop(0))
            else:
                flush(sim, f, upscale(lr_np), lr_np.shape[:3])
        for item in inflight:
            flush(*item)
        for p in pending:
            p.result()
    print(f"inference outputs in {out_dir}")
    return out_dir


if __name__ == "__main__":
    main()
