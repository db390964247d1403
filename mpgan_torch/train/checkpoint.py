"""Checkpoint / resume — counterpart of ``mpgan_tpu/train/checkpoint.py``
(single process).

The directory contract is the JAX package's, so that its discovery helpers
and these give the same answers on one tree:

    <testPath>/test_%04d/            one run (next_run_dir, run_dir)
        params.json                  argv, config and the run's pass
        model_%04d/state.pt          the full train state (save, restore)
        model_%04d.json              sidecar: it, stage, pass_no, up_res,
                                     total_iters
        gen_%04d/params.npz (+.json) the generator, as convert.save_npz
        gen_ema_%04d/params.npz      the EMA generator (when emaDecay > 0)
        metrics.csv, metrics.jsonl, preview_%06d.png

The JAX package stores orbax checkpoints, which the port cannot read; its
own train state is one ``torch.save`` file of tensors and plain containers
(the G, Ds and Dt ``state_dict``s, the three optimizers' ``state_dict``s,
the EMA and the step counter), read with ``weights_only=True``. The
generator saves are the ``.npz`` + sidecar pair that
:func:`mpgan_torch.convert.load_npz` and
:func:`mpgan_torch.infer.load.load_generator` read, so one weight format
serves export, training, inference and serving.

Every save is atomic and overwrite-safe (JAX ``:89-109``, ``:196-208``): a
directory is written under a ``.tmp`` name and renamed into place, and a
sidecar is written to ``.tmp`` and moved with ``os.replace``.

In a data-parallel run (JAX ``:25-52``, ``:82-110``) rank 0 allocates the
run dir and broadcasts its index (:func:`next_run_dir`); only the lead
writes checkpoints, sidecars, metrics and previews (its callers gate on
:func:`mpgan_torch.parallel.mesh.is_lead`), and every rank restores.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any

import torch

from mpgan_torch import convert
from mpgan_torch.parallel import mesh as pmesh

STATE_FILE = "state.pt"
GEN_FILE = "params.npz"


def _indices(base: str, prefix: str) -> list[int]:
    """The numbers of the ``prefix_%04d`` directories under ``base``."""
    if not os.path.isdir(base):
        return []
    return [int(m.group(1)) for d in os.listdir(base)
            if (m := re.fullmatch(prefix + r"_(\d{4})", d))]


def run_dir(base: str, index: int) -> str:
    return os.path.join(base, f"test_{index:04d}")


def next_run_dir(base: str) -> str:
    """Create and return the next free ``test_%04d`` run dir under base
    (JAX ``:25-52``). In a process group only rank 0 lists and creates it
    (ranks listing one shared ``base`` would race to one index), and
    every rank returns the index it broadcasts."""
    idx = -1
    if pmesh.is_lead():
        os.makedirs(base, exist_ok=True)
        idx = max(_indices(base, "test"), default=-1) + 1
        os.makedirs(run_dir(base, idx))
    return run_dir(base, pmesh.broadcast_int(idx))


def latest_run_idx(base: str) -> int | None:
    """Newest ``test_%04d`` index under ``base`` (None when none exist)."""
    return max(_indices(base, "test"), default=None)


def model_dir(run: str, no: int) -> str:
    return os.path.join(run, f"model_{no:04d}")


def gen_dir(run: str, no: int, prefix: str = "gen") -> str:
    return os.path.join(run, f"{prefix}_{no:04d}")


def _replace_dir(tmp: str, path: str) -> None:
    """Move the finished ``tmp`` directory to ``path``, replacing it."""
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def _fresh_tmp(path: str) -> str:
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def write_json(path: str, obj: Any) -> None:
    """Atomic JSON write: a kill mid-write never leaves a truncated file
    (resumeLatest keys on the sidecars)."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=1, default=str)
    os.replace(path + ".tmp", path)


def read_json(path: str) -> dict | None:
    """A JSON file's object, or None when it is missing or corrupt."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def save(run: str, no: int, state: dict, meta: dict) -> str:
    """Save the train state (tensors and plain containers only) as
    ``model_%04d/state.pt`` and its sidecar ``model_%04d.json``."""
    path = os.path.abspath(model_dir(run, no))
    tmp = _fresh_tmp(path)
    torch.save(state, os.path.join(tmp, STATE_FILE))
    _replace_dir(tmp, path)
    write_json(path + ".json", meta)
    return path


def restore(run: str, no: int, map_location) -> tuple[dict, dict]:
    """→ (state, sidecar); the state's tensors on ``map_location``. A
    missing sidecar gives ``{}``."""
    path = os.path.abspath(model_dir(run, no))
    state = torch.load(os.path.join(path, STATE_FILE),
                       map_location=map_location, weights_only=True)
    return state, read_json(path + ".json") or {}


def latest_model_no(run: str) -> int | None:
    return max(_indices(run, "model"), default=None)


def latest_gen_no(run: str) -> int | None:
    """Newest generator-only checkpoint number (``gen_%04d``); gen-only
    runs exist (a run dir that holds only an exported generator)."""
    return max(_indices(run, "gen"), default=None)


def latest_resumable(base: str, pass_no: int | None = None,
                     min_index: int = -1,
                     max_index: int | None = None) -> tuple[int, int] | None:
    """Newest (run index, model no) under ``base`` with a full checkpoint
    (JAX ``:143-189``). With ``pass_no``, checkpoints whose sidecar records
    another pass, or that have no readable sidecar, are skipped (older
    model numbers of a run are scanned before older runs); ``min_index``
    and ``max_index`` bound the run indices scanned."""
    runs = sorted((i for i in _indices(base, "test")
                   if i >= min_index and (max_index is None
                                          or i <= max_index)),
                  reverse=True)
    for idx in runs:
        run = run_dir(base, idx)
        if not os.path.isdir(run):
            continue
        for no in sorted(_indices(run, "model"), reverse=True):
            if pass_no is not None:
                meta = read_json(model_dir(run, no) + ".json")
                if meta is None or meta.get("pass_no") != pass_no:
                    continue  # unknown or other pass: not a resume target
            return idx, no
    return None


def save_gen(run: str, no: int, sd: dict[str, torch.Tensor], meta: dict,
             prefix: str = "gen") -> str:
    """A generator's ``state_dict`` as ``gen_%04d/params.npz`` + sidecar
    (``prefix="gen_ema"`` for the EMA generator); ``meta`` holds
    ``pass_no``, ``stage`` and ``up_res``."""
    path = os.path.abspath(gen_dir(run, no, prefix))
    tmp = _fresh_tmp(path)
    convert.save_npz(os.path.join(tmp, GEN_FILE),
                     convert.state_dict_to_flax(sd), meta)
    _replace_dir(tmp, path)
    return path


def gen_path(run: str, no: int, prefix: str = "gen") -> str:
    """The ``.npz`` of a generator save (it may not exist)."""
    return os.path.join(gen_dir(run, no, prefix), GEN_FILE)


def save_param_log(run: str, cfg: Any, argv: list[str] | None = None,
                   pass_no: int | None = None) -> None:
    """The run's ``params.json``: argv, config and the pass that owns the
    dir (crash recovery keys on it, :func:`recover_run_dir`)."""
    log: dict = {"argv": argv or [], "config": dataclasses.asdict(cfg)}
    if pass_no is not None:
        log["pass_no"] = int(pass_no)
    write_json(os.path.join(run, "params.json"), log)


def run_pass_no(run: str) -> int | None:
    """Training pass recorded in a run dir's params.json (None when the
    field or the file is missing or corrupt)."""
    log = read_json(os.path.join(run, "params.json"))
    try:
        return int(log["pass_no"]) if log and log.get("pass_no") is not None \
            else None
    except (TypeError, ValueError):
        return None


def recover_run_dir(base: str, pass_no: int,
                    min_index: int = -1) -> str | None:
    """Run dir to reuse for a crash-recovery fresh start (JAX
    ``:242-274``): the newest ``test_%04d`` iff its params.json records
    the same pass and it holds no model or gen checkpoint (the run died
    before its first save); None otherwise."""
    idx = latest_run_idx(base)
    if idx is None or (min_index >= 0 and idx < min_index):
        return None
    run = run_dir(base, idx)
    if (run_pass_no(run) == pass_no and latest_model_no(run) is None
            and latest_gen_no(run) is None):
        return run
    return None
