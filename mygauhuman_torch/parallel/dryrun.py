"""Multi-process entry points of the tile-sharded path: `dryrun_multichip`
(port of the JAX package's __graft_entry__.py::dryrun_multichip) and
`run_multihost` (port of scripts/run_multihost.py), and the rank launcher
both use.

    python -m mygauhuman_torch.parallel.dryrun --nprocs 4 --device cpu
    python -m mygauhuman_torch.parallel.dryrun --multihost --device cpu

`launch(case, nprocs, ...)` starts one process per rank
(`python -m mygauhuman_torch.parallel.dryrun --worker CASE --rank R ...`),
each joining a process group over a `file://` store, running the named
case of `CASES` on the inputs a parent wrote with `torch.save`, and writing
its result to `<out>/rank<R>-<case>.pt` (its output to `.log` beside it);
it raises if a rank fails. `--local_world`
below the rank count emulates hosts: "data" then spans them
(`parallel/mesh.py::make_hybrid_mesh`). The ranks import nothing of JAX.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


# ---- the launcher ----------------------------------------------------------------

def launch(case: str, nprocs: int, out_dir, *, inputs: str | None = None,
           local_world: int | None = None, mesh: tuple | None = None, device: str = "cuda",
           timeout: float = 900.0) -> list:
    """Run CASES[case] on nprocs ranks on `device` (cuda: each rank on
    cuda:{local rank % cards}); returns each rank's result."""
    import torch

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    store = out / f"store-{case}-{time.time_ns()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "mygauhuman_torch.parallel.dryrun", "--worker", case,
            "--nprocs", str(nprocs), "--local_world", str(local_world or nprocs),
            "--init", f"file://{store}", "--out", str(out), "--device", device]
    if inputs:
        base += ["--inputs", str(inputs)]
    if mesh:
        base += ["--mesh", ",".join(str(m) for m in mesh)]
    logs = [open(out / f"rank{r}-{case}.log", "w") for r in range(nprocs)]
    procs = [subprocess.Popen(base + ["--rank", str(r)], stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=str(REPO), env=env)
             for r in range(nprocs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                          + (out / f"rank{r}-{case}.log").read_text()[-4000:]
                          for r, rc in enumerate(rcs))
        raise RuntimeError(f"case {case}: ranks failed {rcs}\n{tails}")
    return [torch.load(out / f"rank{r}-{case}.pt", weights_only=False)
            for r in range(nprocs)]


# ---- the cases (each runs on every rank) ------------------------------------------

def _mesh(args):
    from mygauhuman_torch.parallel.mesh import Mesh, make_hybrid_mesh

    if args.mesh:
        return Mesh(tuple(int(x) for x in args.mesh.split(",")))
    return make_hybrid_mesh()


def case_raster(args, inp):
    """rasterize_sharded on the inputs' whole scene; with inp["grads"], the
    gradients of the JAX test's loss (sum (image - 0.3)^2 + sum alpha^2 +
    0.1 sum depth) with respect to opacities, features and the means2d
    offset."""
    import torch

    from mygauhuman_torch.parallel.raster import rasterize_sharded

    mesh = _mesh(args)
    x = {k: v.clone() for k, v in inp["scene"].items()}
    grads = inp.get("grads", False)
    off = torch.zeros((x["means3d"].shape[0], 2))
    for k in ("opacities", "features"):
        x[k].requires_grad_(grads)
    off.requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        out = rasterize_sharded(
            x["means3d"], x["cov3d6"], x["opacities"], x["features"], x["w2c"],
            x["full_proj"], x["bg"], mesh=mesh, config=inp["config"],
            exchange_capacity=inp.get("exchange_capacity"), means2d_offset=off,
            **inp["camera"])
        res = {k: getattr(out, k).detach() for k in out._fields}
        if grads:
            loss = (((out.image - 0.3) ** 2).sum() + (out.alpha ** 2).sum()
                    + 0.1 * out.depth.sum())
            g = torch.autograd.grad(loss, (x["opacities"], x["features"], off))
            res.update(g_opacities=g[0], g_features=g[1], g_offset=g[2])
    return res


def _train_setup(inp, mesh):
    from mygauhuman_torch.parallel.train import make_tile_sharded_train_step

    return make_tile_sharded_train_step(
        inp["smpl_model"], inp["tx"], inp["cfg"], inp["raster_config"], bg=inp["bg"],
        mesh=mesh, exchange_capacity=inp["exchange_capacity"])


def _sharding(mesh):
    from mygauhuman_torch.parallel.mesh import RASTER_AXES, StateSharding

    return StateSharding(mesh.group(RASTER_AXES))


def _share_rows(sh) -> dict:
    """The rows of each per-Gaussian leaf of a share (and of its storage)."""
    from mygauhuman_torch.parallel.mesh import _per_gaussian
    from mygauhuman_torch.train.optim import tree_map_with_path

    c = sh.local.gauss.alive.shape[0]
    per_g, rows = _per_gaussian(sh.local, c), {}

    def add(path, x):
        if per_g(path, x):
            row_bytes = x[0].numel() * x.element_size()
            rows["/".join(map(str, path))] = (x.shape[0], x.untyped_storage().nbytes()
                                              // max(row_bytes, 1))

    tree_map_with_path(add, sh.local)
    return rows


def case_train_step(args, inp):
    """loss_and_grads and the step, twice each, on this rank's share of
    inp's state and the stacked batch; the results gathered whole (the
    gradients and increments too), the share's rows per leaf, and the
    collective kinds each call recorded."""
    from mygauhuman_torch.parallel import mesh as pm
    from mygauhuman_torch.parallel.mesh import Sharded

    mesh = _mesh(args)
    sharding = _sharding(mesh)
    step = _train_setup(inp, mesh)
    ts, batch, deg = inp["ts"], inp["batch"], inp.get("deg", 0)
    cap = ts.gauss.capacity
    sh = sharding.shard(ts, cap)
    kinds = {}
    pm.reset_stats()
    loss, metrics, grads, stats, _ = step.loss_and_grads(sh, batch, deg)
    kinds["loss_and_grads"] = sorted(pm.STATS)
    pm.reset_stats()
    sh1, m1 = step(sh, batch, deg)
    kinds["step"] = sorted(pm.STATS)
    sh2, m2 = step(sh, batch, deg)
    return dict(loss=loss, metrics=metrics, grads=sharding.gather(Sharded(grads, cap)),
                stats=sharding.gather(Sharded(stats, cap)), ts1=sharding.gather(sh1), m1=m1,
                ts2=sharding.gather(sh2), m2=m2, mesh=mesh.shape, rows=_share_rows(sh1),
                kinds=kinds, capacity=sh1.capacity)


def case_train_loop(args, inp):
    """train_loop with densify and capacity growth over the sharded step,
    one view per iteration."""
    from mygauhuman_torch.parallel import mesh as pm
    from mygauhuman_torch.parallel.train import stack_batches
    from mygauhuman_torch.train.trainer import train_loop

    mesh = _mesh(args)
    sharding = _sharding(mesh)
    base = _train_setup(inp, mesh)
    events, in_steps = [], [0]

    def step(t, b, d):
        before = pm.STATS.get("state_gather", {}).get("calls", 0)
        out = base(t, stack_batches([b]), d)
        in_steps[0] += pm.STATS.get("state_gather", {}).get("calls", 0) - before
        return out

    pm.reset_stats()
    sh, m = train_loop(
        sharding.shard(inp["ts"], inp["ts"].gauss.capacity), inp["tx"], step,
        inp["batches"], inp["cfg"], extent=inp["extent"], smpl_vertices=inp["smpl_vertices"],
        max_sh_degree=0, seed=inp["seed"], sharding=sharding,
        callback=lambda it, t2, m2: events.append((it, t2.capacity, sharding.num_alive(t2))))
    gathers = pm.STATS["state_gather"]["calls"]
    rows = _share_rows(sh)
    ts = sharding.gather(sh)
    return dict(ts=ts, loss=float(m["loss"]), events=events,
                alive=ts.gauss.alive.clone(), xyz=ts.gauss.params.xyz.detach().clone(),
                mesh=mesh.shape, rows=rows, capacity=sh.capacity, gathers=gathers,
                gathers_in_steps=in_steps[0])


def case_pbr_step(args, inp):
    """The sharded branch-B step on this rank's share of inp's state and
    occlusion, and inp's light; the state gathered whole, the share's rows
    per leaf, the collective kinds the step recorded."""
    from mygauhuman_torch.parallel import mesh as pm
    from mygauhuman_torch.parallel.train import make_tile_sharded_pbr_step

    mesh = _mesh(args)
    sharding = _sharding(mesh)
    step = make_tile_sharded_pbr_step(
        inp["smpl_model"], inp["tx"], inp["light_tx"], inp["cfg"], inp["raster_config"],
        bg=inp["bg"], mesh=mesh, exchange_capacity=inp["exchange_capacity"])
    cap = inp["ts"].gauss.capacity
    c, i = sharding.rows(cap), sharding.group.index
    occ = inp["occ"][:, i * c:(i + 1) * c]
    pm.reset_stats()
    sh, pbr, m = step(sharding.shard(inp["ts"], cap), inp["pbr_state"], inp["batch"],
                      inp["knn3"], occ, inp["prefilter_w"], inp.get("deg", 0))
    kinds = sorted(pm.STATS)
    return dict(ts=sharding.gather(sh), pbr_state=pbr, metrics=m, rows=_share_rows(sh),
                kinds=kinds, knn_gather_bytes=pm.STATS["knn_gather"]["bytes"])


def case_batched(args, inp):
    """make_batched_train_step over the data ranks (or one process)."""
    from mygauhuman_torch.parallel.train import make_batched_train_step

    mesh = _mesh(args)
    step = make_batched_train_step(inp["smpl_model"], inp["tx"], inp["cfg"],
                                   inp["raster_config"], bg=inp["bg"], mesh=mesh)
    ts, m = step(inp["ts"], inp["batch"], inp.get("deg", 0))
    return dict(ts=ts, metrics=m)


def case_cli(args, inp):
    """cli.train.main(inp["argv"]) on every rank ("{rank}" in an argument
    becomes the rank)."""
    from mygauhuman_torch.cli.train import main

    r = main([a.replace("{rank}", str(args.rank)) for a in inp["argv"]])
    p = r["state"].gauss.params
    return {k: v for k, v in r.items() if k not in ("state", "pbr_state")} | {
        "alive": r["state"].gauss.alive.clone(), "xyz": p.xyz.detach().clone(),
        "albedo": p.albedo.detach().clone(), "roughness": p.roughness.detach().clone(),
        "light": r["pbr_state"].light["base"].clone() if r["pbr_state"] else None}


def _scene(size, verts, cap, views, device, raster_config):
    from mygauhuman_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(n_views=views, width=size, height=size, n_verts=verts,
                                capacity=cap, raster_config=raster_config, device=device)


def _state(scene, cfg, device):
    import torch

    from mygauhuman_torch.models.mlps import init_lbs_offset, init_pose_refiner
    from mygauhuman_torch.train.trainer import create_train_state

    return create_train_state(
        cfg, scene.init_state,
        init_pose_refiner(torch.Generator().manual_seed(0), device=device),
        init_lbs_offset(torch.Generator().manual_seed(1), device=device))


def case_dryrun(args, inp):
    """One tile-sharded branch-A step and one branch-B step on the mesh
    (n ranks -> (2, g, t) when n is even: 8 -> (2, 2, 2)), at inp's size
    (8,192 Gaussians at 512^2 by default)."""
    import numpy as np
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.parallel.mesh import Mesh, hybrid_mesh_shape, runtime
    from mygauhuman_torch.parallel.train import (
        make_tile_sharded_pbr_step,
        make_tile_sharded_train_step,
        stack_batches,
    )
    from mygauhuman_torch.pbr.light import prefilter_weight_set
    from mygauhuman_torch.train.pbr import compute_knn3, create_pbr_state

    rt = runtime()
    n = rt.world_size
    # two "data" hosts of n/2 ranks when n is even
    mesh = Mesh(hybrid_mesh_shape(n, n // 2 if n % 2 == 0 and n > 1 else n))
    dev = rt.device
    rc = RasterizerConfig(tile_capacity=512, max_tiles_per_gaussian=16)
    views = max(mesh.shape["data"], 2)
    scene = _scene(inp["size"], inp["verts"], inp["verts"], views, dev, rc)
    cfg = OptimizationConfig()
    ts, tx = _state(scene, cfg, dev)
    bg = torch.zeros(3, device=dev)
    step = make_tile_sharded_train_step(scene.smpl_model, tx, cfg, rc, bg=bg, mesh=mesh,
                                        exchange_capacity=16384)
    sharding = _sharding(mesh)
    batch = stack_batches(scene.batches[:views])
    t0 = time.perf_counter()
    new_sh, m = step(sharding.shard(ts, ts.gauss.capacity), batch, 0)
    loss = float(m["loss"])
    t_a = time.perf_counter() - t0
    assert np.isfinite(loss), f"multichip step produced loss={loss}"
    assert new_sh.local.step == 1

    pbr_state, light_tx = create_pbr_state(cfg, base_res=16, device=dev)
    pbr_step = make_tile_sharded_pbr_step(scene.smpl_model, tx, light_tx, cfg, rc, bg=bg,
                                          mesh=mesh, exchange_capacity=16384)
    knn3 = compute_knn3(sharding.gather(new_sh).gauss)
    occ = torch.full((views, sharding.rows(new_sh.capacity), 3), 0.5, device=dev)
    t0 = time.perf_counter()
    sh_b, pbr_b, m_b = pbr_step(new_sh, pbr_state, batch, knn3, occ,
                                prefilter_weight_set(16, dev), 0)
    loss_b = float(m_b["loss"])
    t_b = time.perf_counter() - t0
    assert np.isfinite(loss_b), f"multichip PBR step loss={loss_b}"
    assert sh_b.local.step == 2
    assert not torch.equal(pbr_b.light["base"], pbr_state.light["base"])
    if rt.rank == 0:
        print(f"dryrun_multichip({n}): OK, loss={loss:.4f}, pbr_loss={loss_b:.4f}, "
              f"mesh={mesh.shape}, backend {mesh.backend} (tile-sharded A+B steps, "
              f"{inp['verts']:,} Gaussians @ {inp['size']}x{inp['size']}; {t_a:.1f} s + "
              f"{t_b:.1f} s)", flush=True)
    return dict(loss=loss, pbr_loss=loss_b, mesh=mesh.shape)


def case_multihost(args, inp):
    """run_multihost's case: `steps` tile-sharded steps on a 64^2 scene,
    then the losses and parameter checksums."""
    import torch

    from mygauhuman_torch.config import OptimizationConfig
    from mygauhuman_torch.ops.rasterize import RasterizerConfig
    from mygauhuman_torch.parallel.mesh import runtime
    from mygauhuman_torch.parallel.train import make_tile_sharded_train_step, stack_batches

    rt = runtime()
    mesh = _mesh(args)
    dev = rt.device
    cap = 512
    rc = RasterizerConfig(instance_capacity=4 * cap)
    n_views = mesh.shape["data"]
    scene = _scene(64, 200, cap, max(n_views, 2), dev, rc)
    cfg = OptimizationConfig()
    ts, tx = _state(scene, cfg, dev)
    step = make_tile_sharded_train_step(scene.smpl_model, tx, cfg, rc,
                                        bg=torch.zeros(3, device=dev), mesh=mesh,
                                        exchange_capacity=2048)
    batch = stack_batches(scene.batches[:n_views])
    sharding = _sharding(mesh)
    sh = sharding.shard(ts, ts.gauss.capacity)
    losses = []
    for _ in range(inp["steps"]):
        sh, m = step(sh, batch, 0)
        losses.append(float(m["loss"]))
    ts = sharding.gather(sh)
    p = ts.gauss.params
    return dict(losses=losses, xyz_abs_sum=float(p.xyz.abs().sum()),
                opacity_abs_sum=float(p.opacity.abs().sum()),
                fdc_abs_sum=float(p.features_dc.abs().sum()),
                pose_w0_abs_sum=float(ts.pose_refiner["layers"][0]["w"].abs().sum()),
                accum_sum=float(ts.gauss.xyz_grad_accum.sum()), mesh=mesh.shape,
                world_size=rt.world_size, local_world_size=rt.local_world_size)


CASES = {"raster": case_raster, "train_step": case_train_step,
         "train_loop": case_train_loop, "pbr_step": case_pbr_step, "batched": case_batched,
         "cli": case_cli, "dryrun": case_dryrun, "multihost": case_multihost}


def worker_main(args) -> None:
    import torch

    from mygauhuman_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    os.environ.update(RANK=str(args.rank), WORLD_SIZE=str(args.nprocs),
                      LOCAL_RANK=str(args.rank % args.local_world),
                      LOCAL_WORLD_SIZE=str(args.local_world))
    init_distributed(args.init, rank=args.rank, world_size=args.nprocs,
                     local_rank=args.rank % args.local_world,
                     local_world_size=args.local_world, device=args.device)
    inp = torch.load(args.inputs, weights_only=False) if args.inputs else {}
    res = CASES[args.worker](args, inp)
    # what the rank imported: the port runs without JAX and its package
    res["jax_imported"] = any(m.split(".")[0] in ("jax", "mygauhuman_tpu") for m in sys.modules)
    torch.save(res, Path(args.out) / f"rank{args.rank}-{args.worker}.pt")
    torch.distributed.destroy_process_group()


# ---- the entry points --------------------------------------------------------------

def dryrun_multichip(n: int, device: str = "cuda", size: int = 512,
                     verts: int = 8192) -> dict:
    """One tile-sharded A step and one B step over n ranks; rank 0's result."""
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        torch.save(dict(size=size, verts=verts), out / "dryrun_inputs.pt")
        return launch("dryrun", n, out, inputs=out / "dryrun_inputs.pt", device=device,
                      timeout=3000)[0]


def run_multihost(hosts: int = 2, ranks_per_host: int = 2, steps: int = 1,
                  device: str = "cuda") -> dict:
    """hosts x ranks_per_host ranks, the hosts emulated through
    LOCAL_WORLD_SIZE (mesh (hosts, g, t), "data" across the hosts), against
    one host of the same ranks on the same mesh: the losses and parameter
    checksums must agree within 1e-4 relative (they are the same program)."""
    import tempfile

    import torch

    n = hosts * ranks_per_host
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        torch.save(dict(steps=steps), out / "multihost_inputs.pt")
        multi = launch("multihost", n, out / "hosts", inputs=out / "multihost_inputs.pt",
                       local_world=ranks_per_host, device=device)[0]
        shape = tuple(multi["mesh"].values())
        single = launch("multihost", n, out / "one", inputs=out / "multihost_inputs.pt",
                        mesh=shape, device=device)[0]
    keys = ["xyz_abs_sum", "opacity_abs_sum", "fdc_abs_sum", "pose_w0_abs_sum", "accum_sum"]
    diffs = {k: abs(multi[k] - single[k]) / max(abs(single[k]), 1e-12) for k in keys}
    diffs["loss"] = max(abs(a - b) / max(abs(b), 1e-12)
                        for a, b in zip(multi["losses"], single["losses"]))
    ok = (all(d < 1e-4 for d in diffs.values()) and multi["mesh"]["data"] == hosts
          and multi["local_world_size"] == ranks_per_host)
    return dict(ok=ok, mesh=multi["mesh"], hosts=hosts, ranks_per_host=ranks_per_host,
                steps=steps, multi=multi, single=single, rel_diffs=diffs)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nprocs", type=int, default=4, help="ranks")
    p.add_argument("--device", default="cuda", help="cuda (ranks on cuda:{local rank "
                   "%% cards}; gloo where ranks share a card, NCCL otherwise) or cpu")
    p.add_argument("--size", type=int, default=512, help="dry run: image side")
    p.add_argument("--verts", type=int, default=8192, help="dry run: Gaussians")
    p.add_argument("--multihost", action="store_true",
                   help="run_multihost: 2 emulated hosts x nprocs/2 ranks vs one host")
    p.add_argument("--steps", type=int, default=1, help="multihost: train steps")
    # a rank of a launch
    p.add_argument("--worker", choices=sorted(CASES))
    p.add_argument("--rank", type=int)
    p.add_argument("--local_world", type=int)
    p.add_argument("--init")
    p.add_argument("--out")
    p.add_argument("--inputs")
    p.add_argument("--mesh")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        worker_main(args)
        return 0
    if args.multihost:
        r = run_multihost(2, args.nprocs // 2, args.steps, args.device)
        print(f"[multihost] mesh {r['mesh']}: ok={r['ok']} rel_diffs={r['rel_diffs']}")
        return 0 if r["ok"] else 1
    r = dryrun_multichip(args.nprocs, args.device, args.size, args.verts)
    print(f"[dryrun] {args.nprocs} ranks, mesh {r['mesh']}: loss {r['loss']:.6f}, "
          f"pbr loss {r['pbr_loss']:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
