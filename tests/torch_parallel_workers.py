"""Process bodies for the gloo tests of the port's parallel slice
(``tests/test_torch_parallel.py``, ``tests/test_torch_parallel_cli.py``).

Kept apart from the test files so that a spawned rank imports torch and the
port only, not JAX. Each rank joins a ``file://`` rendezvous in the test's
temporary directory (no port, so test workers never collide), runs on the
CPU with one thread and writes what it computed to ``<out>/rank<r>.pt``.
"""

from __future__ import annotations

import torch


def join(rank: int, world: int, init_file: str) -> None:
    torch.set_num_threads(1)
    from prpe_tpu_torch.parallel import distributed

    distributed.initialize(f"file://{init_file}", world, rank, backend="gloo", device="cpu")


class Ranks:
    """``fn(rank, world, *args, queue, done)`` started in ``world`` spawned
    processes; ``result()`` waits for what rank 0 puts on ``queue``, then
    lets the ranks exit (they wait for ``done``, so that the tensors they
    shared stay readable until then)."""

    def __init__(self, fn, world: int, *args):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.queue, self.done = ctx.SimpleQueue(), ctx.Event()
        self.procs = mp.spawn(fn, args=(world, *args, self.queue, self.done), nprocs=world,
                              join=False)

    def result(self):
        try:
            while self.queue.empty():
                # raises with a failed rank's traceback
                if self.procs.join(timeout=0.2) and self.queue.empty():
                    raise RuntimeError("the ranks ended without a result")
            out = self.queue.get()
        finally:
            self.done.set()
            while not self.procs.join():
                pass
        return out


def spawn(fn, world: int, *args):
    """``Ranks(fn, world, *args).result()``."""
    return Ranks(fn, world, *args).result()


_MODELS = {}


def _model(cfg_kwargs, state_dict, dtype, dropout: bool):
    """The model of ``train_config`` in ``dtype`` holding ``state_dict``,
    built once per process and refilled on each call."""
    from prpe_tpu_torch.core import config as pcfg
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.nn.common import set_sync_group

    cfg = train_config(pcfg, **cfg_kwargs)
    key = (tuple(sorted(cfg_kwargs.items())), dtype)
    if key not in _MODELS:
        model = CombinedModel(cfg, dtype, device="cpu").to(dtype)
        _MODELS[key] = (model, model.ada_face.dropout.rate)
    model, rate = _MODELS[key]
    model.mesh, model.class_offset = None, 0
    set_sync_group(model, None)
    model.face_kernel.data = torch.empty(state_dict["face_kernel"].shape, dtype=dtype)
    model.load_state_dict(state_dict)
    model.ada_face.dropout.rate = rate if dropout else 0.0
    return cfg, model


def train_config(m, num_classes: int = 10):
    """``tests/test_torch_train.py``'s configuration: a (1, 1, 1, 1) trunk,
    detection adapters at 64^2, IR-18 on 32^2, a 1-layer ViT of width 32 at
    64x48."""
    return m.CombinedModelConfig(
        backbone_stages=(1, 1, 1, 1), detection=m.DetectionConfig(adapter_size=(64, 64)),
        face=m.AdaFaceConfig(arch="ir_18", num_classes=num_classes, input_size=(32, 32)),
        pose=m.PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32,
                          vit_layers=1, vit_heads=2))


def one_step(state_dict, cfg_kwargs, task, batch, dtype, *, mesh=None, dropout=False,
             optim=None, seed: int = 1, scope: str = "all"):
    """One train step of ``task`` from ``state_dict`` (trainable ``scope``;
    'all' takes every gradient path, the trunk's included) on ``batch``
    (global; this rank's rows taken under ``mesh``) -> (metrics as floats,
    the state dict after it with every split tensor gathered)."""
    from prpe_tpu_torch.core.config import OptimConfig
    from prpe_tpu_torch.parallel import mesh as mesh_lib
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.train.state import create_train_state
    from prpe_tpu_torch.train.steps import make_train_step, trainable_params

    cfg, model = _model(cfg_kwargs, state_dict, dtype, dropout)
    norm_fn = None
    if mesh is not None:
        mesh_lib.shard_params(model, mesh)
        norm_fn = lambda u: mesh_lib.global_norm(u, mesh)  # noqa: E731
        batch = mesh_lib.shard_batch(batch, mesh)
    tx = build_optimizer(OptimConfig(**(optim or {})), norm_fn)
    state = create_train_state(model, {task: tx},
                               {task: trainable_params(model, task, scope)})
    step = make_train_step(model, task, tx, cfg, trainable=scope)
    batch = {k: (torch.as_tensor(v).to(dtype) if torch.as_tensor(v).is_floating_point()
                 else torch.as_tensor(v)) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(seed)
    _, metrics = step(state, batch, gen)
    out = mesh_lib.gather_params({k: t.detach().clone() for k, t in model.state_dict().items()},
                                 mesh)
    return {k: float(v) for k, v in metrics.items()}, out


def collectives_worker(rank: int, world: int, init_file: str, payload, queue, done) -> None:
    """The collectives on ``world`` ranks: the vocab-parallel cross-entropy,
    its gradient and the argmax over class shards; the three autograd
    functions; BatchNorm on this rank's rows with the group's statistics.
    Rank 0 puts every rank's results on ``queue``."""
    join(rank, world, init_file)
    import torch.distributed as dist

    from prpe_tpu_torch.nn.common import BatchNorm
    from prpe_tpu_torch.parallel import collectives as C
    from prpe_tpu_torch.parallel import distributed

    group = dist.group.WORLD
    out = {}
    logits, labels = payload["logits"], payload["labels"]
    n = logits.shape[1] // world
    shard = logits[:, rank * n:(rank + 1) * n].clone().requires_grad_(True)
    ce = C.vocab_parallel_cross_entropy(shard, labels, rank * n, group)
    (ce * payload["ce_weight"]).sum().backward()
    out["ce"] = ce.detach()
    out["ce_grad"] = C.all_gather(shard.grad, group, dim=1)
    out["argmax"] = C.vocab_parallel_argmax(shard.detach(), rank * n, group)
    out["argmax_ties"] = C.vocab_parallel_argmax(
        torch.zeros(3, n), rank * n, group)

    x = torch.full((4,), float(rank + 1), requires_grad=True)
    (C.copy_to_group(x, group) * (rank + 1)).sum().backward()
    out["copy_grad"] = x.grad.clone()
    x.grad = None
    (C.reduce_from_group(x, group) * (rank + 1)).sum().backward()
    out["reduce"] = C.reduce_from_group(x.detach(), group)
    out["reduce_grad"] = x.grad.clone()
    x.grad = None
    g = C.gather_from_group(x, group, dim=0)
    (g * torch.arange(g.numel(), dtype=g.dtype)).sum().backward()
    out["gather"] = g.detach()
    out["gather_grad"] = x.grad.clone()

    bn_x, bn_dy = payload["bn_x"], payload["bn_dy"]
    rows = slice(rank * bn_x.shape[0] // world, (rank + 1) * bn_x.shape[0] // world)
    bn = BatchNorm(bn_x.shape[1], 1e-3, momentum=0.9)
    bn.load_state_dict(payload["bn_state"])
    bn.sync_group = group
    bn.train()
    xr = bn_x[rows].clone().requires_grad_(True)
    y = bn(xr)
    y.backward(bn_dy[rows])
    out["bn"] = dict(y=y.detach(), dx=xr.grad, dweight=bn.weight.grad, dbias=bn.bias.grad,
                     running_mean=bn.running_mean.clone(), running_var=bn.running_var.clone())
    out["primary"] = distributed.is_primary()
    distributed.sync_hosts()
    everyone = C.all_gather_object(out, group)
    if rank == 0:
        queue.put(everyone)
    done.wait()
    distributed.shutdown()


def delta(after, before):
    """The entries of a state dict that moved, as (after - before) in
    after's dtype."""
    return {k: (after[k] - before[k].to(after[k].dtype)) for k in after
            if not torch.equal(after[k], before[k].to(after[k].dtype))}


def compare(got_delta, start, want_delta, want_metrics, got_metrics, param_tol: float,
            floor: float, metric_tol: float, norm_tol: float, stat_tol: float):
    """Worst shares of their bounds (<= 1 passes) of a step's changes
    against a reference's: each tensor's change within ``param_tol`` of the
    reference change's largest entry plus ``floor`` of the task's largest
    change (a tensor either side left unmoved counts as a zero change);
    running statistics and margin buffers within ``stat_tol`` of their
    magnitude; metrics within ``metric_tol`` (``grad_norm`` ``norm_tol``)
    of theirs (at least 1)."""
    task_scale = max(float(d.abs().max()) for d in want_delta.values() if d.numel())
    worst = {"param": 0.0, "stat": 0.0, "metric": 0.0}
    for k in set(want_delta) | set(got_delta):
        zero = torch.zeros((), dtype=torch.float64)
        d = want_delta.get(k, zero).double()
        e = float((got_delta.get(k, zero).double() - d).abs().max())
        if k.endswith(("running_mean", "running_var")) or k in ("margin_mean", "margin_std"):
            bound = stat_tol * max(1.0, float((start[k].double() + d).abs().max()))
            worst["stat"] = max(worst["stat"], e / bound)
        else:
            bound = param_tol * float(d.abs().max()) + floor * task_scale
            worst["param"] = max(worst["param"], e / bound)
    for k, w in want_metrics.items():
        tol = norm_tol if k == "grad_norm" else metric_tol
        worst["metric"] = max(worst["metric"],
                              abs(got_metrics[k] - float(w)) / max(1.0, abs(float(w))) / tol)
    worst["metric_keys_equal"] = set(got_metrics) == set(want_metrics)
    return worst


def _ranks_equal(state, mesh) -> bool:
    """Whether every rank holds bit-equal tensors (gathered split ones
    included)."""
    import hashlib

    from prpe_tpu_torch.parallel import collectives as C

    digest = hashlib.sha256()
    for k in sorted(state):
        digest.update(k.encode())
        digest.update(state[k].contiguous().numpy().tobytes())
    hashes = C.all_gather_object(digest.hexdigest(), mesh.world_group)
    return len(set(hashes)) == 1


def steps_worker(rank: int, world: int, init_file: str, shape, payload, queue, done) -> None:
    """Every case of the payload at mesh ``shape``, one step each from the
    same weights: held against the payload's reference on rank 0
    (``compare``) where the case names one, else rank 0 returns the step's
    metrics and changes (``delta``); with whether every rank ended
    bit-equal. Then a three-step face-recognition run with its eval when
    the payload asks for one. Rank 0 puts the results on ``queue``."""
    join(rank, world, init_file)
    from prpe_tpu_torch.core.config import MeshConfig
    from prpe_tpu_torch.parallel import collectives as C
    from prpe_tpu_torch.parallel import distributed
    from prpe_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(MeshConfig(data_parallel=shape[0], model_parallel=shape[1]))
    start = payload["state_dict"]
    results = {}
    for task, dtype, dropout, scope, ref, bounds in payload["cases"]:
        metrics, got = one_step(start, payload["cfg_kwargs"], task, payload["batches"][task],
                                dtype, mesh=mesh, dropout=dropout, optim=payload["optim"],
                                scope=scope)
        equal = _ranks_equal(got, mesh)
        if rank == 0:
            key = (task, str(dtype).replace("torch.", ""), dropout, scope)
            if ref is None:
                results[key] = dict(metrics=metrics, delta=delta(got, start), ranks_equal=equal)
            else:
                want_metrics, want_delta = payload["refs"][ref]
                results[key] = dict(compare(delta(got, start), start, want_delta, want_metrics,
                                            metrics, **bounds), ranks_equal=equal)
    if payload.get("run"):
        results["run"] = face_run(start, payload["cfg_kwargs"], payload["run"], mesh,
                                  payload["optim"])
    results["coords"] = C.all_gather_object((mesh.data_rank, mesh.model_rank), mesh.world_group)
    if rank == 0:
        queue.put(results)
    done.wait()
    distributed.shutdown()


def face_run(state_dict, cfg_kwargs, run, mesh=None, optim=None, scope: str = "branch",
             dtype=torch.float64):
    """Face recognition for ``len(run['train'])`` steps, then one eval step,
    in ``dtype``: -> (losses, eval metrics, margin buffers)."""
    from prpe_tpu_torch.core.config import OptimConfig
    from prpe_tpu_torch.parallel import mesh as mesh_lib
    from prpe_tpu_torch.train.optim import build_optimizer
    from prpe_tpu_torch.train.state import create_train_state
    from prpe_tpu_torch.train.steps import make_eval_step, make_train_step, trainable_params

    task = "face_recognition"
    cfg, model = _model(cfg_kwargs, state_dict, dtype, False)
    put = lambda b: b  # noqa: E731
    norm_fn = None
    if mesh is not None:
        mesh_lib.shard_params(model, mesh)
        norm_fn = lambda u: mesh_lib.global_norm(u, mesh)  # noqa: E731
        put = lambda b: mesh_lib.shard_batch(b, mesh)  # noqa: E731
    tx = build_optimizer(OptimConfig(**(optim or {})), norm_fn)
    state = create_train_state(model, {task: tx}, {task: trainable_params(model, task, scope)})
    step = make_train_step(model, task, tx, cfg, trainable=scope)
    losses = []
    def cast(b):
        return {k: (torch.as_tensor(v).to(dtype) if torch.as_tensor(v).is_floating_point()
                    else torch.as_tensor(v)) for k, v in put(b).items()}

    for i, b in enumerate(run["train"]):
        state, m = step(state, cast(b), torch.Generator().manual_seed(i))
        losses.append(float(m["loss"]))
    metrics, _ = make_eval_step(model, task, cfg)(cast(run["val"]))
    return (losses, {k: float(v) for k, v in metrics.items()},
            (float(model.margin_mean), float(model.margin_std)))


def cli_worker(rank: int, world: int, init_file: str, argv, queue, done) -> None:
    """``cli.train.main`` as process ``rank`` of ``world``; a rank that fails
    raises, and rank 0 puts its return code on ``queue``."""
    torch.set_num_threads(1)
    from prpe_tpu_torch.cli import train as cli

    try:
        code = cli.main([*argv, "--coordinator", f"file://{init_file}", "--num-processes",
                         str(world), "--process-id", str(rank)])
    except SystemExit as e:  # carried to the parent with its message
        raise RuntimeError(f"rank {rank}: SystemExit: {e}") from None
    if code != 0:
        raise RuntimeError(f"rank {rank}: cli.train.main returned {code}")
    if rank == 0:
        queue.put(code)
    done.wait()
