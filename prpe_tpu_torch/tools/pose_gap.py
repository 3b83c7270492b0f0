"""Diagnostics of the pose-training gap between the port's 60-epoch
round-robin run and the JAX package's (``runs/torch_convergence/``,
``runs/r5_round_robin_convergence/``; ``PERF.md`` §6).

    python -m prpe_tpu_torch.tools.pose_gap grad [--batch 4] [--device DEV]
    python -m prpe_tpu_torch.tools.pose_gap train [--init-seed N] [--init {normal,trunc}]
        -- <cli/train.py arguments>

``grad``: one pose loss and its gradient for the full combined model at
640^2 on one synthetic pose batch (``data/synthetic.py``, numpy seed 0),
from the same fresh weights (seed 0), in float64 with the plain attention
(``einsum``; the kernels take fp32 and bf16 only) as the reference, and in
fp32 and bf16 under the packed kernel (``pallas_packed``: K2 forward, the
torch backward) and under ``einsum``. Prints one JSON line: the losses and,
per run, the largest and the median over the pose branch's tensors of
max |g - g64| / max |g64| (leaving out the tensors whose float64 gradient
is below 1e-6 of the branch's largest: zero up to rounding), the tensor of
the largest, and the largest error over the branch's largest gradient. On the card this holds the training path of
the kernels at full size, which the CPU tests run only at small shapes.

``train``: ``cli/train.py``'s ``main`` with the full model's fresh weights
drawn from seed ``--init-seed`` (the CLI always draws seed 0, as the JAX
CLI draws ``jax.random.key(0)``) and, with ``--init trunc``, every
lecun-normal weight drawn as flax draws it (a normal truncated at two
standard deviations and scaled back to variance 1 / fan_in) where the port
draws an untruncated normal of that variance. Everything else is the
CLI's.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from prpe_tpu_torch.tools.timing import card, log

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at +-2


def _pose_grads(dtype, mode, device, batch):
    """-> (loss, {name: gradient as float64}) of one pose step's loss."""
    from prpe_tpu_torch.core.config import CombinedModelConfig
    from prpe_tpu_torch.models.combined import CombinedModel
    from prpe_tpu_torch.tools.bench_attention import attn_mode
    from prpe_tpu_torch.train.steps import make_loss_fn, to_device, trainable_mask

    cfg = CombinedModelConfig()
    model = CombinedModel(cfg, dtype, device=device, seed=0)
    if dtype == torch.float64:
        model.double()
    mask = trainable_mask(model, "pose_estimation")
    params = {n: p for n, p in model.named_parameters() if mask[n]}
    for n, p in model.named_parameters():
        p.requires_grad_(mask[n])
    with attn_mode(mode):
        loss, _ = make_loss_fn(model, "pose_estimation", cfg)(to_device(batch, device), True)
        grads = torch.autograd.grad(loss, list(params.values()))
    out = {n: g.detach().double() for n, g in zip(params, grads)}
    del model
    torch.cuda.empty_cache() if device.type == "cuda" else None
    return float(loss.detach()), out


def grad_check(args) -> dict:
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.data import synthetic

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    batch = synthetic.pose_batch(np.random.default_rng(0), args.batch, 640, 8)
    ref_loss, ref = _pose_grads(torch.float64, "einsum", device, batch)
    rows = {"float64_einsum": {"loss": ref_loss}}
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("pallas_packed", "einsum"):
            loss, grads = _pose_grads(dtype, mode, device, batch)
            # tensors whose float64 gradient is zero up to rounding (a conv
            # bias in front of a train-mode BatchNorm, the key bias) are
            # left out of the per-tensor errors; the branch error keeps them
            top = max(float(g.abs().max()) for g in ref.values())
            err = {n: float((grads[n] - g).abs().max()) for n, g in ref.items()}
            rel = {n: err[n] / float(g.abs().max()) for n, g in ref.items()
                   if float(g.abs().max()) > 1e-6 * top}
            ordered = sorted(rel.values())
            name = f"{str(dtype).replace('torch.', '')}_{mode}"
            rows[name] = {"loss": loss, "max_rel_err": ordered[-1],
                          "median_rel_err": ordered[len(ordered) // 2],
                          "worst_tensor": max(rel, key=rel.get),
                          "max_err_over_branch_max": max(err.values()) / top}
            log("pose_gap", f"{name}: {rows[name]}")
    return {"tool": "pose_gap", "check": "grad", "card": card(device), "batch": args.batch,
            "runs": rows}


@torch.no_grad()
def trunc_init_weights(model, generator, plain) -> None:
    """``plain`` (``nn/common.py::init_weights``), then every conv and dense
    weight redrawn from flax's truncated lecun normal."""
    from torch import nn

    plain(model, generator)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
            torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
    for m in model.modules():
        if hasattr(m, "_init_extra"):
            m._init_extra(generator)


def train(args, rest) -> int:
    from prpe_tpu_torch.cli import build_model
    from prpe_tpu_torch.cli import train as train_cli
    from prpe_tpu_torch.nn import common

    model_cls, plain = build_model.CombinedModel, common.init_weights
    build_model.CombinedModel = lambda cfg, dtype, device=None, seed=0: model_cls(
        cfg, dtype, device=device, seed=args.init_seed)
    if args.init == "trunc":
        common.init_weights = lambda model, gen: trunc_init_weights(model, gen, plain)
    try:
        return train_cli.main(rest)
    finally:
        build_model.CombinedModel, common.init_weights = model_cls, plain


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    rest = []
    if "--" in argv:
        rest = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("check", choices=("grad", "train"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--init-seed", type=int, default=0)
    ap.add_argument("--init", choices=("normal", "trunc"), default="normal")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.check == "grad":
        print(json.dumps(grad_check(args)), flush=True)
        return 0
    return train(args, rest)


if __name__ == "__main__":
    sys.exit(main())
