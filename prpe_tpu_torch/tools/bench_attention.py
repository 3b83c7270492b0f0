"""The ViTPose-B forward under each attention formulation on the card: the
port's ``tools/bench_attention.py``.

    python -m prpe_tpu_torch.tools.bench_attention [mode ...] [--batch 128] [--iters 10]
    python -m prpe_tpu_torch.tools.bench_attention --dry-run

The cascade's pose stage shape: ViTPose-B (random weights, seed 0) over
``--batch`` crops of 256x192, bf16 with fp32 parameters. For each
``PRPE_ATTN_MODE`` (``einsum``, ``einsum_bf16sm``, ``pallas``,
``pallas_unrolled``, ``pallas_bh``, ``pallas_packed``, ``pallas_lnfused``)
and for the library row ``sdpa`` (the module path with PyTorch's
``scaled_dot_product_attention`` in place of the attention; not a mode of
the model) it prints ``MODE <mode> vitpose fwd total <ms> ms/step`` and,
where the mode runs a kernel of the port, that kernel's ms per forward
(from a profile of one forward), then one JSON line with every number.
The ms is the median of ``--iters`` forwards timed by CUDA events.

Departures from the JAX tool: the modes run in this process, one after
the other (the mode is read at every forward, where the JAX package reads
it at trace time and the JAX tool needed a fresh process each); the time
is CUDA events, not a profiler's device-time total; the ``sdpa`` row is
new. ``--dry-run`` runs a 1-layer ViT of width 32 on 64x48 crops on the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

from prpe_tpu_torch.tools.timing import card, log, time_ms

MODES = ["einsum", "einsum_bf16sm", "pallas", "pallas_unrolled", "pallas_bh", "pallas_packed",
         "pallas_lnfused"]
LIBRARY = "sdpa"


@contextlib.contextmanager
def attn_mode(mode: str):
    """``PRPE_ATTN_MODE=mode`` inside the block (``sdpa``: the ``einsum``
    module path with SDPA as its attention); the environment and the
    module as they were afterwards."""
    from prpe_tpu_torch.nn import vit

    saved = {k: os.environ.pop(k, None) for k in ("PRPE_ATTN_MODE", "PRPE_FUSED_ATTENTION")}
    einsum = vit.einsum_attention
    os.environ["PRPE_ATTN_MODE"] = "einsum" if mode == LIBRARY else mode
    if mode == LIBRARY:
        def sdpa(q, k, v, heads, softmax_in_input_dtype):
            b, t, c = q.shape
            split = lambda x: x.view(b, t, heads, c // heads).transpose(1, 2)  # noqa: E731
            out = torch.nn.functional.scaled_dot_product_attention(split(q), split(k), split(v))
            return out.transpose(1, 2).reshape(b, t, c)

        vit.einsum_attention = sdpa
    try:
        yield
    finally:
        vit.einsum_attention = einsum
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def run(args) -> dict:
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.nn.common import build_on
    from prpe_tpu_torch.nn.vit import ViTPose
    from prpe_tpu_torch.tools.dump_trace_ops import profile_top

    device = resolve_device("cpu" if args.dry_run else args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.dry_run:
        kw, shape, batch, iters = dict(image_size=(64, 48), hidden=32, layers=1, heads=2), \
            (64, 48), 2, 1
    else:
        kw, shape, batch, iters = {}, (256, 192), args.batch, args.iters
    model = build_on(device, lambda: ViTPose(dtype=dtype, **kw), seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.rand(batch, *shape, 3, generator=gen, device=device).to(dtype)
    rows = {}
    with torch.inference_mode():
        for mode in (args.modes or MODES) + [LIBRARY]:
            with attn_mode(mode):
                ms = time_ms(lambda: model(x), device, runs=iters, warmup=2)
                kernel_ms = None
                if device.type == "cuda" and mode.startswith("pallas"):
                    p = profile_top(lambda: model(x))
                    kernel_ms = p["attention_ms"] + (sum(p["ln_mhsa"][s] for s in (
                        "layernorm", "gemm")) if mode == "pallas_lnfused" else 0.0)
            rows[mode] = {"vitpose_fwd_ms": ms, "kernel_ms": kernel_ms}
            log("bench_attention", f"{mode}: {ms:.3f} ms")
    return {"tool": "bench_attention", "card": card(device), "batch": batch,
            "shape": list(shape), "dtype": str(dtype).replace("torch.", ""), "modes": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", choices=MODES + [[]], default=[])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dry-run", action="store_true", help="a tiny ViT on the CPU")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    r = run(parse_args(argv))
    for mode, row in r["modes"].items():
        print(f"MODE {mode:16s} vitpose fwd total {row['vitpose_fwd_ms']:7.3f} ms/step"
              + (f"   kernel {row['kernel_ms']:6.3f} ms" if row["kernel_ms"] else ""))
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
