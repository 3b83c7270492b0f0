"""Train a ViTPose-B checkpoint on synthetic skeleton crops for the bf16
numerics check.

    python -m prpe_tpu_torch.tools.make_numerics_pose_ckpt [--steps 1500]
        [--batch 16] [--lr 1e-3] [--out runs/torch_numerics/pose_ckpt.pt]
        [--init-from CKPT] [--device cpu]

The port's counterpart of ``tools/make_numerics_pose_ckpt.py`` (its
``main``, ``:75-157``). Random-init heatmaps are noise, and the argmax of
noise is as sensitive to the dtype as anything can be, so a fp32-against-bf16
keypoint comparison over random weights measures nothing. This trains the
full ViTPose-B (768 x 12 x 12 at 256x192, 17 keypoints) in fp32 (TF32
GEMMs on the card) on
``tools/scenes.py::make_crop_batch`` crops (fed in [0, 1], as the JAX
script feeds them) with the port's ``generate_target_heatmaps`` (sigma 2),
``joints_mse_loss`` and Adam under a warm-up cosine schedule (100 warm-up
steps, decay over ``--steps``, as ``optax.warmup_cosine_decay_schedule(0,
lr, 100, steps)``), then scores the argmax-decoded pck on 32 fresh crops.
On the card the attention's forward and backward run the packed MHSA
kernel (``PRPE_ATTN_MODE`` as set). It saves the ``torch.save`` state dict
of ``nn/vit.py::ViTPose`` that ``tools/check_cascade_numerics.py
--pose-ckpt`` loads, and exits non-zero when the final pck is under 0.8.
CUDA unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import pathlib
import queue
import sys
import time

import numpy as np
import torch

from prpe_tpu_torch.core.config import OptimConfig, PoseConfig
from prpe_tpu_torch.core.device import resolve_device
from prpe_tpu_torch.nn.common import build_on
from prpe_tpu_torch.nn.vit import ViTPose
from prpe_tpu_torch.ops.heatmap import decode_heatmaps, generate_target_heatmaps
from prpe_tpu_torch.ops.losses import joints_mse_loss, pck_accuracy
from prpe_tpu_torch.tools.scenes import make_crop_batch
from prpe_tpu_torch.train.optim import build_schedule, chain, scale_by_adam, scale_by_learning_rate

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "runs" / "torch_numerics" / "pose_ckpt.pt"
MIN_PCK = 0.8


def pose_model(pose_cfg: PoseConfig, device, dtype=torch.float32) -> ViTPose:
    """ViTPose of ``pose_cfg``, weights from seed 0."""
    return build_on(device, lambda: ViTPose(
        image_size=pose_cfg.input_size, num_keypoints=pose_cfg.num_keypoints,
        hidden=pose_cfg.vit_hidden, layers=pose_cfg.vit_layers, heads=pose_cfg.vit_heads,
        mlp_ratio=pose_cfg.vit_mlp_ratio, patch_size=pose_cfg.patch_size,
        scale_factor=pose_cfg.decoder_scale_factor, dtype=dtype))


def pose_schedule(lr: float, steps: int, warmup: int = 100):
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, steps)``: linear
    from 0 to ``lr`` over ``warmup`` steps, then a cosine to 0 at ``steps``."""
    return build_schedule(OptimConfig(schedule="cosine", learning_rate=lr, min_lr=0.0,
                                      warmup_steps=warmup, total_steps=steps))


def crop_pck(heatmaps: torch.Tensor, kps: np.ndarray, areas: np.ndarray,
             crop_h: int = 256) -> float:
    """The JAX script's score (``:134-140``): argmax-decoded keypoints and
    targets both scaled by ``crop_h`` on either axis, PCK at 0.2 sqrt(area)."""
    coords, _ = decode_heatmaps(heatmaps.float())
    t = lambda a: torch.as_tensor(a, device=coords.device)  # noqa: E731
    return float(pck_accuracy(coords * crop_h, t(kps[:, 0, :, :2]) * crop_h,
                              t(kps[:, 0, :, 2]), t(areas[:, 0])))


def train_pose_ckpt(steps: int = 1500, batch: int = 16, lr: float = 1e-3,
                    out=DEFAULT_OUT, init_from=None, *, device=None,
                    pose_cfg: PoseConfig = PoseConfig(), warmup: int = 100,
                    log_every: int = 50) -> float:
    """Train, save the state dict to ``out`` and return the final pck."""
    dev = resolve_device(device)
    # fp32 parameters and activations; the GEMMs and convolutions round
    # their inputs to TF32 on the card (the JAX script's fp32 matmuls ran at
    # the TPU's default precision, one bf16 pass), the attention kernel
    # stays fp32. The caller's settings come back afterwards.
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return _train(steps, batch, lr, out, init_from, dev, pose_cfg, warmup, log_every)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def draw_batches(batches, steps: int, batch: int, h: int, w: int) -> None:
    """Puts the JAX script's crops on ``batches`` in its order:
    ``default_rng(0)``'s ``steps`` training batches of ``batch``, then the
    32 validation crops."""
    rng = np.random.default_rng(0)
    for n in [batch] * steps + [32]:
        batches.put(make_crop_batch(rng, n, h, w))


def _get(batches, drawer):
    """The next batch, or an error once the drawing process has died."""
    while True:
        try:
            return batches.get(timeout=5.0)
        except queue.Empty:
            if not drawer.is_alive():
                raise RuntimeError(f"the crop-drawing process exited ({drawer.exitcode})")


def _train(steps, batch, lr, out, init_from, dev, pose_cfg, warmup, log_every) -> float:
    model = pose_model(pose_cfg, dev)
    if init_from:
        model.load_state_dict(torch.load(init_from, map_location=dev, weights_only=True))
        print(f"continuing from {init_from}")
    h, w = pose_cfg.input_size
    params = dict(model.named_parameters())
    tx = chain(scale_by_adam(), scale_by_learning_rate(pose_schedule(lr, steps, warmup)))
    opt = tx.init({n: p.detach() for n, p in params.items()})
    # the crops are drawn by a process of their own while this one queues
    # the steps (drawing a batch takes about as long as a step)
    ctx = mp.get_context("spawn")
    batches = ctx.Queue(maxsize=4)
    drawer = ctx.Process(target=draw_batches, args=(batches, steps, batch, h, w), daemon=True)
    drawer.start()
    try:
        t0 = time.perf_counter()
        for i in range(steps):
            imgs, kps, areas = _get(batches, drawer)
            kps_t = torch.from_numpy(kps).to(dev)
            hm_t, w_t = generate_target_heatmaps(kps_t[..., :2], kps_t[..., 2],
                                                 torch.from_numpy(areas).to(dev),
                                                 heatmap_size=pose_cfg.heatmap_size, sigma=2.0)
            pred = model(torch.from_numpy(imgs).to(dev))
            loss = joints_mse_loss(pred.float(), hm_t, w_t)
            grads = torch.autograd.grad(loss, list(params.values()))
            updates, opt = tx.update(dict(zip(params, grads)), opt, None)
            with torch.no_grad():
                torch._foreach_add_(list(params.values()), [updates[n] for n in params])
            if i % log_every == 0:
                print(f"step {i}: loss {float(loss.detach()):.5f} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
        imgs, kps, areas = _get(batches, drawer)
    finally:
        drawer.kill()
        drawer.join()
    with torch.no_grad():
        pck = crop_pck(model(torch.from_numpy(imgs).to(dev)), kps, areas, h)
    print(f"final pck_px(ish): {pck:.3f}")
    out = pathlib.Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, out)
    print(f"saved {out}")
    return pck


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--init-from", default=None,
                    help="existing pose checkpoint to continue training from")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    a = ap.parse_args(argv)
    pck = train_pose_ckpt(a.steps, a.batch, a.lr, a.out, a.init_from, device=a.device)
    if pck < MIN_PCK:
        raise SystemExit(f"pose ckpt underqualified: pck {pck:.3f} < {MIN_PCK}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
