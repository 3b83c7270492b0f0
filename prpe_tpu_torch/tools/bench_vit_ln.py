"""One ViT-B block and its LayerNorm -> attention half-block on the card, per
formulation: the port's ``tools/bench_vit_ln.py``.

    python -m prpe_tpu_torch.tools.bench_vit_ln [mode ...] [--batch 128] [--iters 20]
    python -m prpe_tpu_torch.tools.bench_vit_ln --dry-run

At the cascade's pose-stage shape (``--batch`` crops of 192 tokens, width
768, 12 heads, bf16 with fp32 parameters, random weights), for each
``PRPE_ATTN_MODE`` (default: every one) it times one ``ViTBlock`` forward
and its first half, LN1 -> q/k/v -> attention -> projection + residual
(the module path, or K4 in one launch under ``pallas_lnfused``), and prints
``MODE <mode> block <ms>  half-block <ms>``; then the rows ``library``
(the half-block as ``F.layer_norm``, ``F.linear`` and
``scaled_dot_product_attention``) and the LayerNorm alone three ways: the
model's ``LayerNorm`` (fp32 statistics, ``nn/common.py``), K4's
LayerNorm stage launched alone (``ops/kernels/ln_mhsa.py::layernorm``)
and ``F.layer_norm`` in bf16. One JSON line with every number ends the
output. Times are medians of ``--iters`` calls, CUDA events.

Departure from the JAX tool: its modes were LayerNorm formulations
(``PRPE_LN_MODE``: barrier, plain, manual fp32 / bf16) that the JAX
package no longer has; the port's formulations are the attention modes
and the fused half-block, with the LayerNorm's own variants as rows.
``--dry-run`` runs width 32 with 2 heads over 24 tokens on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from prpe_tpu_torch.tools.bench_attention import MODES, attn_mode
from prpe_tpu_torch.tools.timing import card, log, time_ms


def run(args) -> dict:
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.nn.common import build_on
    from prpe_tpu_torch.nn import vit
    from prpe_tpu_torch.ops.kernels.ln_mhsa import fused_ln_mhsa, layernorm

    device = resolve_device("cpu" if args.dry_run else args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.dry_run:
        b, t, c, heads, iters = 2, 24, 32, 2, 1
    else:
        b, t, c, heads, iters = args.batch, 192, 768, 12, args.iters
    block = build_on(device, lambda: vit.ViTBlock(c, heads), seed=0)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(b, t, c, generator=gen, device=device).to(dtype)
    a = block.attn

    def half():
        if vit.attn_mode() == "pallas_lnfused":
            return fused_ln_mhsa(x, block.ln1.weight, block.ln1.bias, a.q.weight, a.q.bias,
                                 a.k.weight, a.k.bias, a.v.weight, a.v.bias, a.proj.weight,
                                 a.proj.bias, heads, block.ln1.eps)
        return x + a(block.ln1(x))

    def library():
        y = F.layer_norm(x, (c,), block.ln1.weight.to(dtype), block.ln1.bias.to(dtype),
                         block.ln1.eps)
        split = lambda z: z.view(b, t, heads, c // heads).transpose(1, 2)  # noqa: E731
        q, k, v = (F.linear(y, m.weight.to(dtype), m.bias.to(dtype)) for m in (a.q, a.k, a.v))
        o = F.scaled_dot_product_attention(split(q), split(k), split(v))
        return x + F.linear(o.transpose(1, 2).reshape(b, t, c), a.proj.weight.to(dtype),
                            a.proj.bias.to(dtype))

    rows = {}
    with torch.inference_mode():
        for mode in args.modes or MODES:
            with attn_mode(mode):
                rows[mode] = {"block_ms": time_ms(lambda: block(x), device, runs=iters),
                              "half_block_ms": time_ms(half, device, runs=iters)}
            log("bench_vit_ln", f"{mode}: {rows[mode]}")
        rows["library"] = {"block_ms": None, "half_block_ms": time_ms(library, device, runs=iters)}
        w, bias = block.ln1.weight, block.ln1.bias
        ln = {"model_layernorm_ms": time_ms(lambda: block.ln1(x), device, runs=iters),
              "k4_layernorm_stage_ms": time_ms(lambda: layernorm(x, w, bias), device, runs=iters),
              "library_layer_norm_ms": time_ms(
                  lambda: F.layer_norm(x, (c,), w.to(dtype), bias.to(dtype), 1e-12), device,
                  runs=iters)}
    return {"tool": "bench_vit_ln", "card": card(device), "shape": [b, t, c], "heads": heads,
            "dtype": str(dtype).replace("torch.", ""), "modes": rows, "layernorm": ln}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("modes", nargs="*", choices=MODES + [[]], default=[])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--dry-run", action="store_true", help="a narrow block on the CPU")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    r = run(parse_args(argv))
    for mode, row in r["modes"].items():
        block = f"block {row['block_ms']:7.3f} ms" if row["block_ms"] is not None else " " * 19
        print(f"MODE {mode:16s} {block}  half-block {row['half_block_ms']:7.3f} ms")
    for name, ms in r["layernorm"].items():
        print(f"LAYERNORM {name:24s} {ms:7.3f} ms")
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
