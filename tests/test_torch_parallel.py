"""The port's parallel slice on the CPU under gloo, against its single
process and against the JAX package (``tests/test_sharding.py``'s claims,
the JAX package's mesh and configs).

Ranks are spawned processes (``tests/torch_parallel_workers.py``) that join
a ``file://`` rendezvous in the test's temporary directory, one torch
thread each. Tensors go to them in shared memory, and each rank compares
its results itself, so nothing large is written to disk.

Train steps. One step of each task from a seeded tree and
``tests/test_torch_train.py``'s batches (detection and pose at batch 2,
face at 8), branch scope (the frozen trunk's BatchNorms on the global
batch's statistics, the branches' SyncBN backward), SGD at lr 0.1 without weight decay (the update is the
gradient, element by element), in float64, at (dp, mp) = (2, 1), (1, 2) and
(2, 2), against the port's single-process float64 step: each parameter's
change within 1e-10 of the largest change of that tensor plus 1e-10 of the
task's largest, running statistics and margin buffers within 1e-10, since
only the order of the reductions differs. The metrics are held at 1e-6:
the detection losses are computed in fp32 whatever the model's dtype, as
in the JAX package. Face recognition also runs with IR-Net's dropout on
where dp = 2: every data rank draws the global batch's mask and keeps its
rows. Every rank ends with bit-equal parameters, running statistics and
margin buffers (the split ``face_kernel`` gathered). The fp32 steps
against JAX's are in ``tests/test_torch_parallel_jax.py`` and
``tests/test_torch_parallel_jax_heads.py``.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prpe_tpu.core import config as jcfg
from prpe_tpu.core import dtypes as jdtypes
from prpe_tpu.data import pipeline as jpipe
from prpe_tpu.ops import margin as jmargin
from prpe_tpu.parallel import mesh as jmesh
from prpe_tpu_torch.core import config as pcfg
from prpe_tpu_torch.core import dtypes as pdtypes
from prpe_tpu_torch.data import pipeline
from prpe_tpu_torch.data import synthetic
from prpe_tpu_torch.models.combined import CombinedModel
from prpe_tpu_torch.nn.common import BatchNorm
from prpe_tpu_torch.ops import margin
from prpe_tpu_torch.parallel import mesh as pmesh
from test_torch_train import task_batches

import torch_parallel_workers as W

OPTIM = dict(optimizer="sgd", learning_rate=0.1, weight_decay=0.0)
SHAPES = ((2, 1), (1, 2), (2, 2))
F64 = dict(param_tol=1e-10, floor=1e-10, metric_tol=1e-6, norm_tol=1e-6, stat_tol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs several test processes on the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------- mesh

def test_mesh_shapes():
    assert pmesh.mesh_shape(pcfg.MeshConfig(model_parallel=2), 8) == (4, 2)
    assert pmesh.mesh_shape(pcfg.MeshConfig(data_parallel=2, model_parallel=4), 8) == (2, 4)
    with pytest.raises(ValueError):
        pmesh.mesh_shape(pcfg.MeshConfig(data_parallel=3, model_parallel=2), 8)
    # the JAX package agrees on the 8 fake devices of tests/conftest.py
    assert jmesh.build_mesh(jcfg.MeshConfig(model_parallel=2)).devices.shape == (4, 2)
    with pytest.raises(ValueError):
        jmesh.build_mesh(jcfg.MeshConfig(data_parallel=3, model_parallel=2))
    mesh = pmesh.build_mesh()  # one process, no process group
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    assert mesh.data_group is None
    with pytest.raises(ValueError):
        pmesh.build_mesh(pcfg.MeshConfig(model_parallel=2))
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        pmesh.build_mesh(pcfg.MeshConfig(data_parallel=2), world_size=2)


def test_param_sharding_rules():
    mesh = pmesh.Mesh((4, 2))
    model = torch.nn.Module()
    model.face_kernel = torch.nn.Parameter(torch.zeros(16, 64))
    model.conv = torch.nn.Conv2d(3, 8, 3)
    specs = pmesh.make_param_shardings(mesh, model)
    assert specs["face_kernel"] == pmesh.Spec("model", 1)
    assert specs["conv.weight"] == specs["conv.bias"] == pmesh.Spec()
    jspecs = jmesh.make_param_shardings(
        jmesh.build_mesh(jcfg.MeshConfig(model_parallel=2)),
        {"face_kernel": jnp.zeros((16, 64)), "conv": {"kernel": jnp.zeros((3, 3, 3, 8))}})
    assert tuple(jspecs["face_kernel"].spec) == (None, "model")  # dim 1 on the model axis
    assert tuple(jspecs["conv"]["kernel"].spec) == ()
    # the rank's rows and classes
    mesh.data_rank, mesh.model_rank = 3, 1
    batch = {"image": np.arange(8 * 2).reshape(8, 2), "n": 5}
    rows = pmesh.shard_batch(batch, mesh)
    np.testing.assert_array_equal(rows["image"], batch["image"][6:8])
    assert rows["n"] == 5
    assert mesh.class_range(64) == (32, 64)
    with pytest.raises(ValueError, match="equal parts"):
        mesh.class_range(63)
    tree = {"model": {"face_kernel": torch.arange(16 * 64.).reshape(16, 64)},
            "mu": ({"face_kernel": torch.ones(16, 64), "x": torch.ones(3)},)}
    local = pmesh.slice_params(tree, mesh)
    assert torch.equal(local["model"]["face_kernel"], tree["model"]["face_kernel"][:, 32:])
    assert local["mu"][0]["face_kernel"].shape == (16, 32) and local["mu"][0]["x"].shape == (3,)


def _margin_inputs(seed=0, b=8, e=32, c=64):
    rng = np.random.default_rng(seed)
    kernel = rng.normal(size=(e, c)).astype(np.float32)
    emb = rng.normal(size=(b, e)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    norms = rng.uniform(5, 30, size=(b, 1)).astype(np.float32)
    labels = rng.integers(0, c, size=(b,))
    return kernel, emb, norms, labels


@pytest.mark.parametrize("head", ["adaface", "arcface", "cosface"])
def test_class_sharded_logits_match_replicated_and_jax(head):
    """Two class shards, each with its offset, concatenated: the replicated
    port logits, and JAX's (as in tests/test_sharding.py:33-61)."""
    kernel, emb, norms, labels = _margin_inputs()
    t = [torch.from_numpy(a) for a in (kernel, emb, norms, labels)]

    def port(k, offset):
        if head == "adaface":
            return margin.adaface_logits(k, t[1], t[2], t[3], margin.MarginState.init(),
                                         class_offset=offset)[0]
        fn = margin.arcface_logits if head == "arcface" else margin.cosface_logits
        return fn(k, t[1], t[3], class_offset=offset)

    full = port(t[0], 0)
    shards = torch.cat([port(t[0][:, :32], 0), port(t[0][:, 32:], 32)], dim=1)
    torch.testing.assert_close(shards, full, rtol=0, atol=0)
    if head == "adaface":
        want, _ = jmargin.adaface_logits(jnp.asarray(kernel), jnp.asarray(emb),
                                         jnp.asarray(norms), jnp.asarray(labels),
                                         jmargin.MarginState.init())
    else:
        fn = jmargin.arcface_logits if head == "arcface" else jmargin.cosface_logits
        want = fn(jnp.asarray(kernel), jnp.asarray(emb), jnp.asarray(labels))
    np.testing.assert_allclose(shards.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_norm_stats_one_process():
    x = torch.from_numpy(_margin_inputs()[2])
    mean, std = margin.norm_stats(x)
    assert torch.equal(mean, x.mean()) and torch.equal(std, x.std(correction=1))


# ------------------------------------------------------------ collectives

@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    """Two ranks: cross-entropy and argmax over class shards, the autograd
    functions, and BatchNorm with the group's statistics; with the
    single-process inputs."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(6, 10)).astype(np.float32) * 4)
    logits[0, 7] = logits[0, 2] = logits[0].max() + 1.0  # a tie: the lower class wins
    bn_x = torch.from_numpy(rng.normal(size=(4, 3, 5, 5)).astype(np.float32) * 2 + 1)
    bn = BatchNorm(3, 1e-3, momentum=0.9)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.5, 0.5, -1.0]))
        bn.bias.copy_(torch.tensor([0.1, 0.2, 0.3]))
        bn.running_mean.copy_(torch.tensor([0.5, -0.5, 0.0]))
        bn.running_var.copy_(torch.tensor([1.0, 2.0, 0.5]))
    payload = dict(logits=logits, labels=torch.tensor([7, 0, 9, 4, 5, 1]),
                   ce_weight=torch.arange(1.0, 7.0), bn_x=bn_x,
                   bn_dy=torch.from_numpy(rng.normal(size=(4, 3, 5, 5)).astype(np.float32)),
                   bn_state={k: v.clone() for k, v in bn.state_dict().items()})
    init = tmp_path_factory.mktemp("collectives") / "init"
    return payload, W.spawn(W.collectives_worker, 2, str(init), payload)


def test_vocab_parallel_cross_entropy_and_argmax(collectives):
    payload, ranks = collectives
    logits = payload["logits"].clone().requires_grad_(True)
    want = torch.nn.functional.cross_entropy(logits, payload["labels"], reduction="none")
    (want * payload["ce_weight"]).sum().backward()
    for r in ranks:
        torch.testing.assert_close(r["ce"], want.detach(), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(r["ce_grad"], logits.grad, rtol=1e-6, atol=1e-7)
        assert torch.equal(r["argmax"], payload["logits"].argmax(-1))
        assert r["argmax"][0] == 2
        assert torch.equal(r["argmax_ties"], torch.zeros(3, dtype=torch.long))


def test_autograd_collectives(collectives):
    _, ranks = collectives
    assert [r["primary"] for r in ranks] == [True, False]
    for rank, r in enumerate(ranks):
        assert torch.equal(r["copy_grad"], torch.full((4,), 3.0))  # 1 + 2 over the ranks
        assert torch.equal(r["reduce"], torch.full((4,), 3.0))
        assert torch.equal(r["reduce_grad"], torch.full((4,), float(rank + 1)))
        assert torch.equal(r["gather"], torch.tensor([1.0] * 4 + [2.0] * 4))
        assert torch.equal(r["gather_grad"], torch.arange(4.0) + 4 * rank)


def test_sync_batchnorm_matches_one_process_and_flax(collectives):
    """BatchNorm at dp = 2 (each rank half the rows) against the port's
    BatchNorm on the whole batch and against flax ``BatchNorm`` on it."""
    payload, ranks = collectives
    bn = BatchNorm(3, 1e-3, momentum=0.9)
    bn.load_state_dict(payload["bn_state"])
    bn.train()
    x = payload["bn_x"].clone().requires_grad_(True)
    y = bn(x)
    y.backward(payload["bn_dy"])
    got = {k: torch.cat([r["bn"][k] for r in ranks]) for k in ("y", "dx")}
    torch.testing.assert_close(got["y"], y.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got["dx"], x.grad, rtol=1e-5, atol=1e-5)
    # the parameter gradients are each rank's share: they add up
    torch.testing.assert_close(ranks[0]["bn"]["dweight"] + ranks[1]["bn"]["dweight"],
                               bn.weight.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ranks[0]["bn"]["dbias"] + ranks[1]["bn"]["dbias"],
                               bn.bias.grad, rtol=1e-5, atol=1e-5)
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0]["bn"][k], ranks[1]["bn"][k])  # equal on every rank
        torch.testing.assert_close(ranks[0]["bn"][k], getattr(bn, k), rtol=1e-6, atol=1e-6)
    # flax on the global batch (NHWC)
    st = payload["bn_state"]
    fb = flax.linen.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    variables = {"params": {"scale": jnp.asarray(st["weight"]), "bias": jnp.asarray(st["bias"])},
                 "batch_stats": {"mean": jnp.asarray(st["running_mean"]),
                                 "var": jnp.asarray(st["running_var"])}}
    xj = jnp.asarray(payload["bn_x"].permute(0, 2, 3, 1).numpy())

    def f(params, xx):
        return fb.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                        mutable=["batch_stats"])

    yj, pullback = jax.vjp(lambda p, xx: f(p, xx)[0], variables["params"], xj)
    dparams, dxj = pullback(jnp.asarray(payload["bn_dy"].permute(0, 2, 3, 1).numpy()))
    new = f(variables["params"], xj)[1]["batch_stats"]
    np.testing.assert_allclose(got["y"].permute(0, 2, 3, 1).numpy(), np.asarray(yj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["dx"].permute(0, 2, 3, 1).numpy(), np.asarray(dxj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose((ranks[0]["bn"]["dweight"] + ranks[1]["bn"]["dweight"]).numpy(),
                               np.asarray(dparams["scale"]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ranks[0]["bn"]["running_mean"].numpy(), np.asarray(new["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ranks[0]["bn"]["running_var"].numpy(), np.asarray(new["var"]),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ train steps

@pytest.fixture(scope="module")
def references():
    """The port's single-process float64 step per task (and face
    recognition with dropout on), from one seeded tree (margin buffers off
    their initial values) and ``tests/test_torch_train.py``'s batches."""
    model = CombinedModel(W.train_config(pcfg), device="cpu", seed=5)
    model.margin_mean.fill_(30.0)
    model.margin_std.fill_(20.0)
    state_dict = model.state_dict()
    batches = task_batches()
    refs = {}
    for task in jcfg.TASKS:
        for dropout in ((False, True) if task == "face_recognition" else (False,)):
            metrics, after = W.one_step(state_dict, {}, task, batches[task], torch.float64,
                                        dropout=dropout, optim=OPTIM, scope="branch")
            refs[(task, dropout)] = (metrics, W.delta(after, state_dict))
    return state_dict, batches, refs


@pytest.fixture(scope="module")
def mesh_runs(references, tmp_path_factory):
    """shape -> what rank 0 found at that mesh; the three meshes' ranks run
    at once."""
    state_dict, batches, refs = references
    rng = np.random.default_rng(11)
    run = {"train": [synthetic.face_batch(rng, 8, 64, 10) for _ in range(3)],
           "val": synthetic.face_batch(rng, 8, 64, 10)}
    started = {}
    for shape in SHAPES:
        # dropout's rows matter where the batch is split
        cases = [(task, torch.float64, dropout, "branch", (task, dropout), F64)
                 for task, dropout in refs if shape[0] > 1 or not dropout]
        init = tmp_path_factory.mktemp("mesh") / "init"
        payload = dict(state_dict=state_dict, cfg_kwargs={}, batches=batches, optim=OPTIM,
                       refs=refs, cases=cases, run=run if shape == (1, 2) else None)
        started[shape] = W.Ranks(W.steps_worker, shape[0] * shape[1], str(init), shape, payload)
    out = {shape: ranks.result() for shape, ranks in started.items()}
    out["state_dict"], out["run"] = state_dict, run
    return out


@pytest.mark.parametrize("task", jcfg.TASKS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"dp{s[0]}_mp{s[1]}")
def test_float64_step_on_a_mesh_matches_one_process(mesh_runs, shape, task):
    res = mesh_runs[shape]
    assert sorted(res["coords"]) == [(d, m) for d in range(shape[0]) for m in range(shape[1])]
    rows = {k: r for k, r in res.items() if isinstance(k, tuple) and k[0] == task}
    assert len(rows) == (2 if task == "face_recognition" and shape[0] > 1 else 1)
    for key, row in rows.items():
        assert row["metric_keys_equal"], key
        for what in ("param", "stat", "metric"):
            assert row[what] <= 1.0, (key, what, row)
        assert row["ranks_equal"], key  # parameters, statistics and margin buffers


def test_face_recognition_run_at_mp2_follows_one_process(mesh_runs):
    """Three face-recognition steps and an eval step at (dp, mp) = (1, 2),
    the classifier split by class, against one process (as
    tests/test_sharding.py:184-247), in float64: the margin EMA threads
    through the steps and the eval's cross-entropy and argmax run over the
    split classes. (In fp32 the two drift apart by the reduction order,
    about 4x a step through the margin head, as the JAX test found.)"""
    got_losses, got_eval, got_buffers = mesh_runs[(1, 2)]["run"]
    losses, evals, buffers = W.face_run(mesh_runs["state_dict"], {}, mesh_runs["run"], None,
                                        OPTIM)
    np.testing.assert_allclose(got_losses, losses, rtol=1e-10)
    assert set(got_eval) == set(evals)
    for k, v in evals.items():
        assert abs(got_eval[k] - v) <= 1e-10 * max(1.0, abs(v)), (k, got_eval[k], v)
    np.testing.assert_allclose(got_buffers, buffers, rtol=1e-12)


# ---------------------------------------------------------------- sampler

def test_sampler_strides_by_data_rank():
    """Under a (2, 2) mesh the two ranks of a model group read the same
    samples: a loader given the mesh's data coordinates strides by data
    rank and data-axis size, not by the global rank and world."""
    dataset = type("D", (), {"__len__": lambda self: 100, "__getitem__": lambda self, i: {
        "x": np.full(2, i)}})()
    seen = {}
    for data_rank in range(2):
        for model_rank in range(2):
            mesh = pmesh.Mesh((2, 2))
            mesh.data_rank, mesh.model_rank = data_rank, model_rank
            loader = pipeline.make_epoch_loader(dataset, 4, max_samples=41, seed=3, prefetch=0,
                                                shard=(mesh.data_rank, mesh.dp))
            # a batch of 4 rows a data rank: the global batch of 8 takes 40 // 8 steps
            assert loader.steps_per_epoch == 5 and loader.per_rank
            seen[(data_rank, model_rank)] = np.concatenate(
                [b["x"][:, 0] for b in loader.host(2)])
    np.testing.assert_array_equal(seen[(0, 0)], seen[(0, 1)])
    np.testing.assert_array_equal(seen[(1, 0)], seen[(1, 1)])
    both = np.concatenate([seen[(0, 0)], seen[(1, 0)]])
    assert len(seen[(0, 0)]) == len(seen[(1, 0)]) == 20  # equal shards: the 41st is dropped
    np.testing.assert_array_equal(np.sort(both), np.sort(
        jpipe.LimitedSampler(100, max_samples=41, seed=3, shard_index=0,
                             shard_count=1).indices(2)[:40]))
    # data rank 1 reads JAX's stride 1 of 2
    want = jpipe.LimitedSampler(100, 41, seed=3, shard_index=1, shard_count=2).indices(2)
    np.testing.assert_array_equal(seen[(1, 0)], want[:20])


# ---------------------------------------------------------- config, dtypes

def test_config_to_json_equals_jax():
    assert pcfg.config_to_json(pcfg.FrameworkConfig()) == jcfg.config_to_json(
        jcfg.FrameworkConfig())
    for cls in ("MeshConfig", "FrameworkConfig"):
        assert [f.name for f in dataclasses.fields(getattr(pcfg, cls))] == \
            [f.name for f in dataclasses.fields(getattr(jcfg, cls))]
    assert pcfg.MeshConfig() == pcfg.MeshConfig(data_parallel=-1, model_parallel=1)
    data = {"mesh": {"model_parallel": 2}, "cascade": {"max_faces": 4}, "other": 1}
    got = pcfg._from_dict(pcfg.FrameworkConfig, data)
    want = jcfg._from_dict(jcfg.FrameworkConfig, data)
    # the JAX reader keeps nested configs as dicts (postponed annotations)
    assert got.mesh == want.mesh == {"model_parallel": 2}
    assert pcfg.config_to_json(got) == jcfg.config_to_json(want)


def test_dtype_policy():
    policy = pdtypes.DTypePolicy()
    assert (policy.param_dtype, policy.compute_dtype, policy.accum_dtype) == (
        torch.float32, torch.bfloat16, torch.float32)
    jp = jdtypes.DTypePolicy()
    assert [f.name for f in dataclasses.fields(policy)] == [f.name for f in
                                                            dataclasses.fields(jp)]
    tree = {"a": torch.ones(2), "b": [torch.ones(2, dtype=torch.float64),
                                      torch.arange(3)], "c": (torch.ones(1), 5)}
    out = policy.cast_to_compute(tree)
    assert out["a"].dtype == out["b"][0].dtype == out["c"][0].dtype == torch.bfloat16
    assert out["b"][1].dtype == torch.int64 and out["c"][1] == 5
    assert isinstance(out["b"], list) and isinstance(out["c"], tuple)
    assert pdtypes.default_policy(True, "cuda").compute_dtype == torch.bfloat16
    assert pdtypes.default_policy(True, "cpu").compute_dtype == torch.float32
    assert pdtypes.default_policy(False, "cuda").compute_dtype == torch.float32
    # JAX gives bf16 compute on the TPU only; the test platform is the CPU
    assert jdtypes.default_policy(True).compute_dtype == jnp.float32
