"""Data generation entry point of the port — counterpart of
``scripts/datagen.py``: buoyant smoke simulations on the card, written as
the LR/HR ``.uni`` pairs the loader reads.

    python -m mpgan_torch.datagen basePath data/ fromSim 1000 toSim 1009 \\
        resHigh 128 upRes 4 frames 120 obstacles 0 randSeed 0 [device cpu]

Flags: ``basePath fromSim toSim resHigh upRes frames obstacles`` (every Nth
sim gets an obstacle; 0 = never) ``randSeed warmup dataDim`` (2 → (1, Y, X)
scenes) ``pressureSolver`` (jacobi | cg) ``scene`` (plume | varied |
varied-dual | moving) ``skipExisting`` (skip sims whose last frame is
complete) ``writeHighVel`` ``retryOnError hangTimeout`` and ``device``
(``cuda`` by default; ``cpu`` only when asked). ``compileCache`` is
accepted and has no effect. Each sim prints one line and one JSON line of
its timing (:func:`mpgan_torch.solver.datagen.generate_sim`), whose
``graphed`` says whether its frames replayed CUDA graphs (on a card they
do; on the CPU they run eagerly).

With ``retryOnError N`` (or ``hangTimeout S``) a supervising parent runs
the work as a child and restarts it up to N times
(:func:`mpgan_torch.utils.supervise.supervise_restartable`); a restart
adds ``skipExisting 1``, and ``.uni`` writes are atomic, so restarts are
idempotent. The heartbeat is one written frame. The parent imports no
torch and never touches the card.
"""

from __future__ import annotations

import json
import os
import sys

from mpgan_torch.utils import params as ph


def _sim_complete(sim_dir: str, frames: int, with_obstacle: bool,
                  high_vel: bool = True) -> bool:
    """A sim dir is complete iff its last frame's files all exist: frames
    are written in order and each write is atomic."""
    f = frames - 1
    names = [f"density_high_{f:04d}.uni",
             f"density_low_{f:04d}.uni", f"velocity_low_{f:04d}.uni"]
    if high_vel:
        names.append(f"velocity_high_{f:04d}.uni")
    if with_obstacle:
        names.append(f"flags_{f:04d}.uni")
    return all(os.path.exists(os.path.join(sim_dir, n)) for n in names)


def main(argv=None) -> list[dict]:
    """Run the sweep; → one timing dict per generated sim."""
    eff_argv = list(sys.argv[1:]) if argv is None else list(argv)
    if argv is not None:
        ph.setParams(argv)
    ph.getParam("compileCache", "")          # a JAX compile cache: no effect
    retry_budget = int(ph.getParam("retryOnError", 0))
    hang_timeout = float(ph.getParam("hangTimeout", 0))
    if ((retry_budget > 0 or hang_timeout > 0)
            and not os.environ.get("MPGAN_DATAGEN_CHILD")):
        from mpgan_torch.utils.supervise import supervise_restartable
        sys.exit(supervise_restartable(
            "mpgan_torch.datagen", eff_argv, max(retry_budget, 0),
            hang_timeout, "MPGAN_DATAGEN_CHILD",
            heartbeat_dir=ph.getParam("basePath", "data/"),
            retry_flags=("skipExisting", "1")))
    base = ph.getParam("basePath", "data/")
    from_sim = int(ph.getParam("fromSim", 1000))
    to_sim = int(ph.getParam("toSim", from_sim))
    res_hi = int(ph.getParam("resHigh", 128))
    up_res = int(ph.getParam("upRes", 4))
    frames = int(ph.getParam("frames", 120))
    obstacles = int(ph.getParam("obstacles", 0))
    seed = int(ph.getParam("randSeed", 0))
    warmup = int(ph.getParam("warmup", 8))
    data_dim = int(ph.getParam("dataDim", 3))
    psolver = ph.getParam("pressureSolver", "jacobi")
    scene = ph.getParam("scene", "plume")
    skip_existing = int(ph.getParam("skipExisting", 0))
    high_vel = int(ph.getParam("writeHighVel", 1))
    device = ph.getParam("device", "cuda")
    ph.checkUnusedParams()
    if psolver not in ("jacobi", "cg"):
        sys.exit(f"pressureSolver must be jacobi or cg, got {psolver!r}")

    from mpgan_torch.device import resolve_device
    from mpgan_torch.solver import datagen
    if scene not in datagen.SCENES:
        sys.exit(f"scene must be one of {datagen.SCENES}, got {scene!r}")
    if scene != "plume" and data_dim == 2:
        sys.exit("randomized scene families are 3D only (dataDim 3)")
    dev = resolve_device(device)
    out = []
    for sim in range(from_sim, to_sim + 1):
        with_obs, save_flags = datagen.sim_scene_policy(scene, sim, obstacles)
        sim_dir = os.path.join(base, f"sim_{sim:04d}")
        # 2D scenes never write flags files, even with obstacles
        if skip_existing and _sim_complete(sim_dir, frames,
                                           save_flags and data_dim != 2,
                                           high_vel=bool(high_vel)):
            print(f"sim_{sim:04d}: complete ({frames} frames) — skipped")
            continue
        if data_dim == 2:
            stats = datagen.generate_sim_2d(
                sim_dir, seed + sim, res_hi, up_res, frames, warmup=warmup,
                with_obstacle=with_obs, pressure_solver=psolver, device=dev)
        else:
            stats = datagen.generate_sim(
                sim_dir, seed + sim, res_hi, up_res, frames, warmup=warmup,
                with_obstacle=with_obs, save_flags=save_flags,
                pressure_solver=psolver, scene=scene,
                write_high_vel=bool(high_vel), device=dev)
        stats = dict(sim=sim, res=res_hi, dim=data_dim, scene=scene,
                     obstacle=with_obs, solver=psolver, **stats)
        out.append(stats)
        print(f"sim_{sim:04d}: {frames} frames @{res_hi}^{data_dim} "
              f"(scene={scene}, obstacle={with_obs}, "
              f"graphed={stats['graphed']}) in "
              f"{stats['seconds']:.1f}s -> {sim_dir}")
        print("datagen " + json.dumps(stats), flush=True)
    return out


if __name__ == "__main__":
    main()
