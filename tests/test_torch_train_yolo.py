"""The standalone YOLO trainer (``prpe_tpu_torch/cli/train_yolo.py``) against
the JAX package's on the CPU, in fp32: YOLOv11-n, one class, batch 4 of
64^2 images.

The JAX side is the JAX CLI's jitted ``train_step`` and ``eval_step``
closures (``prpe_tpu/cli/train_yolo.py:119-156``) rebuilt here from the
functions they call (``losses.yolo_detection_loss``,
``optim.build_optimizer``, ``state.update_ema``, ``decode_predictions``,
``nms.non_max_suppression``); the port's weights come from the same JAX
tree through ``from_jax_variables``.

Tolerances. The losses agree within 1e-4 of their magnitude (at least 1)
on both calls of an accumulation of 2, and the running statistics within
1e-3. The update of the second call is the accumulated mean of two
gradients through Nesterov SGD, so each parameter's change holds the
gradients element by element; it agrees within ``PARAM_TOL`` of the
largest JAX change of its tensor plus 1e-4 of the largest change of the
model, plus two fp32 ulps of the tensor's largest entry (where a change is
at rounding level, ``p + u`` and the EMA's ``e d + (1 - d) p`` round
either way). The bound is the one ``tests/test_torch_train.py``'s docstring
derives for detection: at 64^2 the last YOLO level is 2 x 2, so its
BatchNorms reduce over 16 values with the fast variance, and the backward
through them cancels large terms in fp32 (the same tolerance, 5e-2, holds
the combined model's detection branch there; against float64 runs, JAX's
own fp32 detection gradients are off by up to 1.2e-2 of a tensor's largest
entry). The EMA after the two calls is held the same way. Detections are
compared as matched sets (``tools/check_cascade_numerics.py:133``, IoU
0.99): every valid JAX box has a port box, scores within 1e-4.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from prpe_tpu.core.config import DetectionConfig as JDetectionConfig
from prpe_tpu.core.config import OptimConfig as JOptimConfig
from prpe_tpu.data import synthetic as jsynthetic
from prpe_tpu.data.packed import apply_image_norm as japply_image_norm
from prpe_tpu.nn.yolo import YOLO as JYOLO
from prpe_tpu.nn.yolo import decode_predictions as jdecode
from prpe_tpu.ops import losses as JL
from prpe_tpu.ops import nms as jnms
from prpe_tpu.train.optim import build_optimizer as jbuild_optimizer
from prpe_tpu.train.state import update_ema as jupdate_ema
from prpe_tpu.utils import profiling as jprofiling
from prpe_tpu_torch.cli import train_yolo
from prpe_tpu_torch.core.config import DetectionConfig, OptimConfig
from prpe_tpu_torch.models.porting import from_jax_variables
from prpe_tpu_torch.ops.kernels import _build
from prpe_tpu_torch.train.checkpoint import load_model
from prpe_tpu_torch.train.optim import build_optimizer
from prpe_tpu_torch.utils import profiling
from test_torch_models import random_variables

SIZE, BATCH, ACCUMULATE = 64, 4, 2
PARAM_TOL = 5e-2
EPS32 = float(np.finfo(np.float32).eps)
OPTIM = dict(optimizer="sgd", learning_rate=0.1, weight_decay=5e-4, schedule="linear",
             min_lr=1e-4, warmup_steps=100, total_steps=200, accumulate=ACCUMULATE)

_spec = importlib.util.spec_from_file_location(
    "check_cascade_numerics",
    pathlib.Path(__file__).resolve().parents[1] / "tools" / "check_cascade_numerics.py")
_numerics = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_numerics)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several test processes on the
    host's cores, and these small shapes gain nothing from more."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def batches(seed=0, n=ACCUMULATE):
    """Synthetic detection batches with uint8 images (the loaders' dtype)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = jsynthetic.detection_batch(rng, BATCH, SIZE, JDetectionConfig().max_gt)
        b["image"] = np.round(b["image"] * 255).astype(np.uint8)
        out.append(b)
    return out


def jax_variables(seed=0):
    model = JYOLO(nc=1, variant="n")
    v = random_variables(lambda: model.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3))),
                         seed)
    return model, v


def jax_steps(model, det_cfg, tx):
    """The JAX CLI's two closures, as it writes them."""
    @jax.jit
    def train_step(params, batch_stats, opt_state, ema_params, updates_count, batch):
        image = japply_image_norm(batch["image"], "unit")

        def loss_fn(p):
            outs, mut = model.apply({"params": p, "batch_stats": batch_stats}, image, True,
                                    mutable=["batch_stats"])
            dl = JL.yolo_detection_loss(
                outs, batch["gt_labels"], batch["gt_boxes"], batch["gt_mask"],
                num_classes=det_cfg.num_classes, box_gain=det_cfg.box_gain,
                cls_gain=det_cfg.cls_gain, dfl_gain=det_cfg.dfl_gain)
            return dl.total, (mut["batch_stats"], dl)

        (_, (new_stats, dl)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        updates_count = updates_count + 1
        ema_params = jupdate_ema(ema_params, params, updates_count)
        metrics = {"loss": dl.total, "box": dl.box, "cls": dl.cls, "dfl": dl.dfl}
        return params, new_stats, opt_state, ema_params, updates_count, metrics

    @jax.jit
    def eval_step(eval_params, batch_stats, batch):
        outs = model.apply({"params": eval_params, "batch_stats": batch_stats},
                           japply_image_norm(batch["image"], "unit"), False)
        return jnms.non_max_suppression(
            jdecode(outs, det_cfg.num_classes), conf_threshold=det_cfg.conf_threshold,
            iou_threshold=det_cfg.iou_threshold, max_det=det_cfg.max_det,
            pre_nms_top_k=det_cfg.pre_nms_top_k)

    return train_step, eval_step


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX train calls (one accumulated update), then the eval of the
    start weights and of the EMA with the new statistics."""
    model, v = jax_variables()
    det_cfg = JDetectionConfig(num_classes=1, image_size=SIZE)
    tx = jbuild_optimizer(JOptimConfig(**OPTIM), v["params"])
    train_step, eval_step = jax_steps(model, det_cfg, tx)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])
    opt_state = tx.init(params)
    ema = jax.tree_util.tree_map(jnp.copy, params)
    count = jnp.zeros((), jnp.int32)
    calls = []
    bs = batches()
    for batch in bs:
        params, stats, opt_state, ema, count, m = train_step(
            params, stats, opt_state, ema, count, {k: jnp.asarray(a) for k, a in batch.items()})
        calls.append((jax.device_get(m), jax.device_get({"params": params, "batch_stats": stats}),
                      jax.device_get(ema)))
    eval_batch = batches(seed=1, n=1)[0]
    dets = jax.device_get(eval_step(ema, stats, {"image": jnp.asarray(eval_batch["image"])}))
    return v, bs, calls, int(count), eval_batch, dets, eval_step


def port_model(v):
    model = train_yolo.build_model(1, "n", "cpu")
    model.load_state_dict(from_jax_variables(v), strict=True)
    return model


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def test_train_steps_with_accumulation_and_ema_match_jax(jax_run):
    v, bs, calls, count, _, _, _ = jax_run
    model = port_model(v)
    tx = build_optimizer(OptimConfig(**OPTIM))
    state = train_yolo.create_state(model, tx)
    start = {k: t.clone() for k, t in model.state_dict().items()}
    det_cfg = DetectionConfig(num_classes=1, image_size=SIZE)
    names = [n for n, _ in model.named_parameters()]
    for i, batch in enumerate(bs):
        metrics = train_yolo.train_step(model, tx, state, batch, det_cfg)
        want_metrics, want_vars, want_ema = calls[i]
        assert set(metrics) == set(want_metrics)
        for k, w in want_metrics.items():
            assert rel_err(metrics[k].numpy(), w) <= 1e-4, (i, k, float(metrics[k]), float(w))
        want = from_jax_variables(want_vars)
        got = model.state_dict()
        for k in got:
            if k not in names:  # running statistics: every call moves them
                assert rel_err(got[k].numpy(), want[k].numpy()) <= 1e-3, (i, k)
        if i == 0:  # the accumulation holds the update back; the EMA of
            # unmoved weights is those weights up to its rounding
            ema = from_jax_variables({"params": want_ema})
            for n in names:
                assert torch.equal(got[n], start[n]), n
                assert rel_err(state.ema_params[n].numpy(), ema[n].numpy()) <= 1e-6, n
                assert rel_err(state.ema_params[n].numpy(), start[n].numpy()) <= 1e-6, n
    assert state.updates_count == count == ACCUMULATE
    want = from_jax_variables(calls[-1][1])
    want_ema = from_jax_variables({"params": calls[-1][2]})
    got = model.state_dict()
    scale = max(float((want[n] - start[n]).abs().max()) for n in names)
    ema_scale = max(float((want_ema[n] - start[n]).abs().max()) for n in names)
    assert scale > 0 and ema_scale > 0
    for n in names:
        for g, w, s in ((got[n], want[n], scale), (state.ema_params[n], want_ema[n], ema_scale)):
            dw, dg = w - start[n], g - start[n]
            ulps = 2 * EPS32 * float(start[n].abs().max())  # the sums' own rounding
            bound = PARAM_TOL * float(dw.abs().max()) + 1e-4 * s + ulps
            assert float((dg - dw).abs().max()) <= bound, n


def assert_same_detections(det, want):
    boxes, scores = det.boxes.numpy(), det.scores.numpy()
    valid = det.valid.numpy()
    wvalid = np.asarray(want.valid)
    assert valid.sum(-1).tolist() == wvalid.sum(-1).tolist() and valid.any()
    for b in range(len(valid)):
        wb = np.asarray(want.boxes)[b][wvalid[b]]
        pairs = _numerics._greedy_match(wb, boxes[b][valid[b]], thr=0.99)
        assert len(pairs) == len(wb)
        ws, gs = np.asarray(want.scores)[b][wvalid[b]], scores[b][valid[b]]
        assert max(abs(float(ws[i]) - float(gs[j])) for i, j, _ in pairs) <= 1e-4


def test_eval_step_runs_the_ema_with_the_live_statistics(jax_run):
    """The EMA and the statistics from two different trees: the port's
    ``eval_step`` takes the parameters it is given and the model's running
    statistics, as ``eval_step(ema_params, batch_stats, ...)`` does."""
    v, _, _, _, eval_batch, _, jeval = jax_run
    _, other = jax_variables(seed=7)
    want = jax.device_get(jeval(jax.tree_util.tree_map(jnp.asarray, other["params"]),
                                jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]),
                                {"image": jnp.asarray(eval_batch["image"])}))
    model = port_model(v)
    ema = {k: t for k, t in from_jax_variables({"params": other["params"]}).items()}
    before = {k: t.clone() for k, t in model.state_dict().items()}
    _build.reset_launches()
    det = train_yolo.eval_step(model, ema, eval_batch, DetectionConfig(num_classes=1))
    assert not any(_build.launches.values())  # the plain NMS on the CPU
    assert_same_detections(det, want)
    for k, t in model.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_eval_after_training_matches_jax(jax_run):
    """The trained EMA and statistics of the two calls: the detections of
    the JAX CLI's eval step on them."""
    v, bs, calls, _, eval_batch, want, _ = jax_run
    model = port_model(calls[-1][1])
    ema = from_jax_variables({"params": calls[-1][2]})
    det = train_yolo.eval_step(model, ema, eval_batch, DetectionConfig(num_classes=1))
    assert_same_detections(det, want)


def test_count_params_and_flops_against_jax():
    """Parameters equal; FLOPs within 15 % at 64^2 (FlopCounterMode counts
    the products and convolutions only; XLA also the elementwise work,
    which at 64^2 is 12 % of its count: 6.374e7 against 5.597e7)."""
    jm, v = jax_variables()
    x0 = jnp.zeros((1, SIZE, SIZE, 3))
    want = jprofiling.count_flops(lambda vv, x: jm.apply(vv, x, False), v, x0)
    model = port_model(v)
    assert profiling.count_params(model.parameters()) == jprofiling.count_params(v["params"])
    assert profiling.count_params(dict(model.named_parameters())) == 2604867
    got = profiling.count_flops(model, torch.zeros(1, SIZE, SIZE, 3))
    assert got["bytes_accessed"] == -1.0
    assert abs(got["flops"] / want["flops"] - 1) <= 0.15, (got, want)


def test_profiling_helpers(tmp_path):
    """``trace`` writes a Chrome trace and, beside it, the program's spans
    and counters of the captured calls (none here: no runner ran)."""
    with profiling.trace(str(tmp_path / "trace")) as d:
        torch.ones(8).sum()
    assert d == str(tmp_path / "trace")
    assert "traceEvents" in (tmp_path / "trace" / "trace.json").read_text()
    spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
    assert spans == {"ring_calls": profiling.RING_CALLS, "spans": [], "counters": []}


def test_synthetic_cli_then_test_mode_writes_everything(tmp_path, capsys):
    """One synthetic epoch, then ``--test`` on ``best``: the checkpoints,
    ``step.csv`` with the JAX CLI's columns, the metrics table and the four
    curve PNGs (the counterpart of the slow-marked
    ``tests/test_plots.py::test_train_yolo_cli_test_mode``)."""
    out = tmp_path / "weights"
    common = ["--device", "cpu", "--synthetic", "--input-size", "64", "--batch-size", "4",
              "--num-classes", "1", "--output-dir", str(out)]
    assert train_yolo.main(common + ["--epochs", "1"]) == 0
    assert (out / "best.pt").exists() and (out / "last.pt").exists()
    header = (out / "step.csv").read_text().splitlines()[0].split(",")
    assert header == ["epoch", "loss", "box", "cls", "dfl", "precision", "recall", "f1",
                      "mAP50", "mAP75", "mAP50-95"]
    first = capsys.readouterr().out.splitlines()[0]
    assert first.startswith("params: 2.60M  flops/img: 0.06G"), first
    # the checkpoint holds the EMA weights with the running statistics
    sd = load_model(out / "best")
    model = train_yolo.build_model(1, "n", "cpu")
    assert set(sd) == set(model.state_dict())
    assert train_yolo.main(common + ["--test", "--class-names", "person"]) == 0
    printed = capsys.readouterr().out
    assert "precision    recall     mAP50       mAP" in printed
    for name in ("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png"):
        assert (out / name).stat().st_size > 1000
        assert f"{name[:-4]}: {out / name}" in printed


def test_cli_from_disk_turns_the_mosaic_off_for_the_last_10_epochs(tmp_path, monkeypatch):
    """11 epochs from a PNG directory: the mosaic on in epoch 0 only, a
    ``step.csv`` row per epoch, and the optimizer config the JAX CLI builds
    (SGD, linear schedule, ``accumulate = round(64 / batch)``, warm-up
    ``max(warmup_epochs x steps, 100)``), with the schedule's horizon from
    the batches the loader gives (2 an epoch), where the JAX CLI would count
    ``--max-train-samples`` 100 as 25 steps an epoch (ROADMAP.md §3)."""
    import csv

    import prpe_tpu_torch.train.optim as optim
    from prpe_tpu_torch.data.detection import YoloMosaicDataset
    from prpe_tpu_torch.tools.make_dataset import make_detection_split

    make_detection_split(tmp_path / "det", "train", 8, 48, seed=0)
    make_detection_split(tmp_path / "det", "val", 4, 48, seed=1)
    seen, mosaic = [], []
    orig = optim.build_optimizer
    monkeypatch.setattr(optim, "build_optimizer", lambda cfg: seen.append(cfg) or orig(cfg))
    set_mosaic = YoloMosaicDataset.set_mosaic
    monkeypatch.setattr(YoloMosaicDataset, "set_mosaic",
                        lambda self, p: mosaic.append(p) or set_mosaic(self, p))
    out = tmp_path / "out"
    assert train_yolo.main(["--device", "cpu", "--data-dir", str(tmp_path / "det"),
                            "--input-size", "32", "--batch-size", "4", "--epochs", "11",
                            "--max-train-samples", "100", "--warmup-epochs", "60",
                            "--output-dir", str(out)]) == 0
    (cfg,) = seen
    assert (cfg.optimizer, cfg.schedule) == ("sgd", "linear")
    assert (cfg.total_steps, cfg.warmup_steps, cfg.accumulate) == (22, 120, 16)
    assert (cfg.learning_rate, cfg.min_lr, cfg.weight_decay) == (1e-2, 1e-4, 5e-4)
    assert mosaic == [0.0] * 10  # set before each of epochs 1-10
    rows = list(csv.DictReader((out / "step.csv").open()))
    assert [int(r["epoch"]) for r in rows] == list(range(11))
    assert all(np.isfinite(float(r["loss"])) for r in rows)
