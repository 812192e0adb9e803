"""Ranks for the port's distribution tests: ``run_ranks`` spawns ``world``
processes joined in a ``gloo`` group over a ``FileStore``, each running
one of the tasks below, and returns what each rank returned.  This module
imports neither JAX nor the JAX package, so that a spawned rank starts
light; the test files pass it numpy data."""
import dataclasses
import datetime
import multiprocessing
import pickle
import time
import traceback

import torch

#: The ranks' process group times out a collective after this long.
RANK_TIMEOUT_S = 60
#: How long a run's ranks may take, their start-up and first DTensor
#: steps (which learn the shardings) included.
RUN_TIMEOUT_S = 300


def _rank_main(task, rank, world, store_path, out_path, args):
    import torch.distributed as dist
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            "gloo", store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        try:
            result = TASKS[task](rank, world, *args)
        finally:
            dist.destroy_process_group()
        payload = ("ok", result)
    except BaseException:           # reported to the parent, then re-raised
        payload = ("error", traceback.format_exc())
        with open(out_path, "wb") as f:
            pickle.dump(payload, f)
        raise
    with open(out_path, "wb") as f:
        pickle.dump(payload, f)


def run_ranks(task, world, tmp_path, *args):
    """``TASKS[task](rank, world, *args)`` on each of ``world`` spawned
    ranks; the ranks' results in rank order.  Fails if a rank raises or
    the ranks have not finished within ``RUN_TIMEOUT_S``."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / f"{task}.store")
    outs = [tmp_path / f"{task}.{r}.pkl" for r in range(world)]
    procs = [ctx.Process(target=_rank_main,
                         args=(task, r, world, store, str(outs[r]), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RUN_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    assert not alive, f"{len(alive)} of {world} ranks did not finish in " \
        f"{RUN_TIMEOUT_S} s"
    results = []
    for r, (p, path) in enumerate(zip(procs, outs)):
        status, value = pickle.loads(path.read_bytes())
        assert status == "ok" and p.exitcode == 0, f"rank {r}:\n{value}"
        results.append(value)
    return results


# ------------------------------------------------------------------ tasks --


def ring_task(rank, world, x, w):
    """The ring and the reference all-gather matmul over the world group
    (rank r holds rows ``[r·d/n, (r+1)·d/n)`` of ``w``), and
    ``make_overlapped_matmul`` over the ``data`` axis of a ``(2, n/2)``
    mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.parallel import collectives as coll
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    rows = w.shape[0] // world
    shard = w[rank * rows:(rank + 1) * rows]
    ring = coll.ring_allgather_matmul(x, shard)
    ref = coll.reference_allgather_matmul(x, shard)
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("data", "model"))
    wd = distribute_tensor(w, mesh, [Shard(0), Replicate()])
    over = coll.make_overlapped_matmul(mesh, "data")(x, wd)
    assert over.placements == (Replicate(), Replicate())
    return ring.numpy(), ref.numpy(), over.to_local().numpy()


def layouts_task(rank, world, cache, new, idx):
    """(1) The local block of a dim split over ``("pod", "data")`` by the
    port's ``placements``: rank r = (p, d) holds block p·D + d.  (2)
    ``attention.write_cache`` into a decode cache laid out by the cache
    rules (B over data, S over model) on a ``(2, n/2)`` mesh, whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models.attention import write_cache
    from repro_torch.parallel import sharding as sh
    mesh = init_device_mesh("cpu", (2, world // 2),
                            mesh_dim_names=("pod", "data"))
    whole = torch.arange(4 * world)
    local = sh.NamedSharding(mesh, (("pod", "data"),)).distribute(whole)
    mesh2 = init_device_mesh("cpu", (2, world // 2),
                             mesh_dim_names=("data", "model"))
    spec = sh._cache_spec(mesh2, sh.ParallelPlan(), "k", cache.shape, False)
    dc = sh.NamedSharding(mesh2, spec).distribute(torch.from_numpy(cache))
    with implicit_replication():
        write_cache(dc, torch.from_numpy(idx), torch.from_numpy(new))
    return (mesh.get_coordinate(), local.to_local().numpy(),
            tuple(dc.placements), dc.full_tensor().numpy())


def train_task(rank, world, arch, state, batch, fsdp):
    """One train step of ``arch``'s f32 smoke config from ``state`` on a
    ``(2, n/2)`` mesh, every parameter, moment and batch leaf laid out by
    the sharding rules (FSDP as given); the loss and every updated
    parameter, whole."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import step as S
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              param_dtype="float32", attn_impl="chunked")
    mesh = mesh_mod.mesh_variant(2, world // 2, device_type="cpu")
    plan = dataclasses.replace(sh.plan_for(cfg), fsdp=fsdp)
    model = T.Transformer(cfg, device="meta")
    shardings = sh.param_shardings(cfg, mesh, plan, model)
    sh.set_parameters(model, {
        name: ns.distribute(torch.from_numpy(state[name]))
        for name, ns in shardings.items()})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    bsh = sh.batch_shardings(cfg, mesh, tb)
    tb = {k: bsh[k].distribute(v) for k, v in tb.items()}
    tcfg = S.TrainConfig(opt=opt_mod.OptConfig(lr=1e-2))
    with implicit_replication():
        st = opt_mod.init(tcfg.opt, S.trainable(model))
        model, st, m = S.make_train_step(cfg, tcfg)(model, st, tb)
    spec_of = {k: v.placements for k, v in shardings.items()}
    laid_out = all(p.placements == spec_of[n]
                   for n, p in model.named_parameters())
    return (float(m["loss"].full_tensor()), laid_out,
            {n: p.full_tensor().detach().numpy()
             for n, p in model.named_parameters()})


def restore_task(rank, world, directory, step, like, specs):
    """``checkpoint.restore`` of a checkpoint with ``shardings`` built from
    ``specs`` (a tree of specs of ``like``'s structure) on a ``(2, n/2)``
    mesh: each restored leaf's placements and whole value."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import checkpoint as ckpt
    mesh = mesh_mod.mesh_variant(2, world // 2, device_type="cpu")

    def tree(s):
        if isinstance(s, dict):
            return {k: tree(v) for k, v in s.items()}
        return sh.NamedSharding(mesh, s)

    out = ckpt.restore(directory, step, like, shardings=tree(specs))
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}/")
        else:
            flat[prefix[:-1]] = (tuple(t.placements),
                                 t.full_tensor().numpy())
    walk(out, "")
    return flat


TASKS = {"ring": ring_task, "layouts": layouts_task,
         "train": train_task, "restore": restore_task}


def numpy_state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


__all__ = ["run_ranks", "numpy_state"]
