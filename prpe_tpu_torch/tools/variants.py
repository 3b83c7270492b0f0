"""Time variants of a kernel source on the card, in turns, in one process.

    python3 -m prpe_tpu_torch.tools.variants {nms,mhsa,ln_mhsa,bn_act} \\
        [--variant NAME 'OLD=>NEW' ['OLD=>NEW' ...]] ... [--rounds 2]

A variant is ``prpe_tpu_torch/csrc/`` with each ``OLD`` text replaced by
``NEW`` in every source or header that holds it (a missing ``OLD`` is an
error); variant ``as_is`` is the source unchanged. Every variant is built at
once with the flags of ``_build.py`` into ``build/prpe_tpu_torch/variants/``
and loaded with ctypes; then, round after round, each variant's entry point
is timed (median CUDA-event time of 25 back-to-back launches behind a sleep
kernel) and held against the plain PyTorch version:

- ``nms``: ``prpe_nms_keep`` at B = 32, K = 256 and 1024 and B = 128,
  K = 256, every candidate valid and 70 % valid, threshold 0.65 (keep masks
  must equal ``nms_keep_plain``);
- ``mhsa``: ``prpe_mhsa_packed_f32`` at B = 32 and 128, T = 192, H = 12,
  D = 64 (max abs error against ``mhsa_packed_plain``);
- ``ln_mhsa``: the fused half-block ``prpe_ln_mhsa_f32`` at B = 32 and 128
  and ``prpe_ln_mhsa_bf16`` at B = 32 (T = 192, C = 768, H = 12), then the
  fp32 stages alone at B = 32 and 128: ``prpe_linear_f32`` (one 768 x 768
  projection, M = B * 192) and ``prpe_layernorm_f32`` (max abs error against
  ``ln_mhsa_plain``, ``linear_plain``, ``layernorm_plain``). The stages are
  also timed as one library call each (``F.linear``, ``F.layer_norm``, fp32
  without TF32), as the pseudo-variant ``library``;
- ``bn_act``: ``prpe_bn_act_bf16`` on channels-last tensors of 128 frames
  and 256 channels: with a residual and ReLU at 160^2 (ResNet-50-vd's first
  stage), with a residual and SiLU at 80^2 (a RepVGG block of RT-DETR's
  neck), and without a residual or activation at 160^2 (mismatches against
  ``bn_act_plain``).

Prints one JSON line per variant and shape with the card's name and power
limit, and the ``ptxas`` register and spill lines of each build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from prpe_tpu_torch.ops.kernels import _build
from prpe_tpu_torch.ops.kernels.attention import mhsa_packed_plain
from prpe_tpu_torch.ops.kernels.nms import nms_keep_plain
from prpe_tpu_torch.tools.nms_phases import inputs as nms_inputs


def make_variant(lib: str, name: str, edits) -> Path:
    root = _build.BUILD_DIR / "variants" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    for edit in edits:
        old, new = edit.split("=>", 1)
        hits = 0
        for path in [root / f"{lib}.cu", *sorted(root.glob("*.cuh"))]:
            text = path.read_text()
            if old in text:
                path.write_text(text.replace(old, new))
                hits += 1
        if not hits:
            raise ValueError(f"variant {name}: {old!r} is in no source of {lib}")
    return root


def build(lib: str, variants: dict) -> dict:
    procs = {}
    for name, root in variants.items():
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *_build.libraries[lib].flags,
               "-o", str(root / f"lib{lib}.so"), str(root / f"{lib}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) \
                    or "error" in line.lower():
                print(f"{name}: {line.strip()}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        dll = ctypes.CDLL(str(variants[name] / f"lib{lib}.so"))
        for sym, argtypes in _build.libraries[lib].entry_points.items():
            fn = getattr(dll, sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
        libs[name] = dll
    return libs


def event_ms(fn, runs: int = 25) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for i in range(runs):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(events[i].elapsed_time(events[i + 1]) for i in range(runs))


def nms_cases(gen):
    for b, k in ((32, 256), (32, 1024), (128, 256)):
        for all_valid in (True, False):
            boxes, valid = nms_inputs(b, k, all_valid, gen)
            keep = torch.empty(b, k, dtype=torch.bool, device="cuda")
            want = nms_keep_plain(boxes, valid, 0.65)

            def call(dll, boxes=boxes, valid=valid, keep=keep, b=b, k=k):
                return dll.prpe_nms_keep(boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b,
                                         k, 0.65, torch.cuda.current_stream().cuda_stream)

            def err(keep=keep, want=want):
                return float((keep != want).sum())

            yield dict(B=b, K=k, all_valid=all_valid), call, err, None


def mhsa_cases(gen):
    t, h, d = 192, 12, 64
    for b in (32, 128):
        q, k, v = (torch.randn(b, t, h * d, generator=gen, device="cuda") for _ in range(3))
        o = torch.empty_like(q)
        want = mhsa_packed_plain(q, k, v, h)

        def call(dll, q=q, k=k, v=v, o=o, b=b):
            return dll.prpe_mhsa_packed_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                            b, t, h, d, d ** -0.5,
                                            torch.cuda.current_stream().cuda_stream)

        def err(o=o, want=want):
            return float((o - want).abs().max())

        yield dict(B=b, T=t, H=h, D=d, dtype="float32"), call, err, None


def ln_mhsa_cases(gen):
    import torch.nn.functional as F

    from prpe_tpu_torch.ops.kernels.ln_mhsa import layernorm_plain, linear_plain, ln_mhsa_plain

    t, c, h = 192, 768, 12
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    n = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")  # noqa: E731
    for dtype, b in ((torch.float32, 32), (torch.float32, 128), (torch.bfloat16, 32)):
        x = n(b, t, c).to(dtype)
        params = [1 + 0.1 * n(c), 0.1 * n(c)]
        for _ in range(4):
            params += [(n(c, c) * c ** -0.5).to(dtype), 0.02 * n(c)]
        out, ws = torch.empty_like(x), torch.empty(4 * b * t * c, dtype=dtype, device="cuda")
        want = ln_mhsa_plain(x, *params, heads=h)
        sym = "prpe_ln_mhsa_f32" if dtype == torch.float32 else "prpe_ln_mhsa_bf16"

        def call(dll, x=x, params=params, out=out, ws=ws, b=b, sym=sym):
            return getattr(dll, sym)(x.data_ptr(), *(p.data_ptr() for p in params),
                                     out.data_ptr(), ws.data_ptr(), b, t, c, h, 1e-12,
                                     (c // h) ** -0.5, stream())

        def err(out=out, want=want):
            return float((out.float() - want.float()).abs().max())

        yield (dict(stage="ln_mhsa", B=b, T=t, C=c, H=h, dtype=str(dtype)[6:]), call, err,
               None)
    for b in (32, 128):
        m = b * t
        x, w, bias = n(m, c), n(c, c) * c ** -0.5, 0.02 * n(c)
        g, beta = 1 + 0.1 * n(c), 0.1 * n(c)
        y = torch.empty_like(x)
        stages = (
            ("linear", lambda dll, x=x, w=w, bias=bias, y=y, m=m: dll.prpe_linear_f32(
                x.data_ptr(), w.data_ptr(), bias.data_ptr(), None, y.data_ptr(), m, c, c,
                stream()), linear_plain(x, w, bias),
             lambda x=x, w=w, bias=bias: F.linear(x, w, bias)),
            ("layernorm", lambda dll, x=x, g=g, beta=beta, y=y, m=m: dll.prpe_layernorm_f32(
                x.data_ptr(), g.data_ptr(), beta.data_ptr(), y.data_ptr(), m, c, 1e-12,
                stream()), layernorm_plain(x, g, beta),
             lambda x=x, g=g, beta=beta: F.layer_norm(x, (c,), g, beta, 1e-12)),
        )
        for stage, call, want, library in stages:
            yield (dict(stage=stage, M=m, C=c, dtype="float32"), call,
                   lambda want=want, y=y: float((y - want).abs().max()), library)


def bn_act_cases(gen):
    from prpe_tpu_torch.ops.kernels.bn_act import ACTS, bn_act_plain

    c = 256
    for hw, act, residual in ((160, "relu", True), (80, "silu", True), (160, "none", False)):
        shape = (128, c, hw, hw)
        x, r = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                .contiguous(memory_format=torch.channels_last) for _ in range(2))
        r = r if residual else None
        scale, bias = (torch.rand(c, generator=gen, device="cuda").bfloat16() for _ in range(2))
        y = torch.empty_like(x)
        want = bn_act_plain(x, scale, bias, None, act, 1, r)

        def call(dll, x=x, r=r, scale=scale, bias=bias, y=y, act=act):
            return dll.prpe_bn_act_bf16(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), None,
                                        None if r is None else r.data_ptr(), y.data_ptr(),
                                        x.numel() // c, c, 1, ACTS[act], 0,
                                        torch.cuda.current_stream().cuda_stream)

        def err(y=y, want=want):
            return float((y != want).sum())

        yield (dict(shape=list(shape), act=act, residual=residual, dtype="bfloat16"), call, err,
               None)


CASES = {"nms": nms_cases, "mhsa": mhsa_cases, "ln_mhsa": ln_mhsa_cases, "bn_act": bn_act_cases}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("lib", choices=tuple(CASES))
    parser.add_argument("--variant", nargs="+", action="append", default=[],
                        metavar=("NAME", "EDIT"), help="a name, then OLD=>NEW edits")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("variants: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    specs = {"as_is": [], **{v[0]: v[1:] for v in args.variant}}
    libs = build(args.lib, {name: make_variant(args.lib, name, edits)
                            for name, edits in specs.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = list(CASES[args.lib](gen))
    times = {(name, i): [] for name in libs for i in range(len(cases))}
    times.update({("library", i): [] for i, case in enumerate(cases) if case[3]})
    errs = {}
    for _ in range(args.rounds):
        for name, dll in libs.items():
            for i, (_, call, err, _) in enumerate(cases):
                _build.check(call(dll), f"{name} launch")
                torch.cuda.synchronize()
                errs[name, i] = max(errs.get((name, i), 0.0), err())
                times[name, i].append(event_ms(lambda: call(dll)))
        for i, (_, _, _, library) in enumerate(cases):
            if library:
                errs["library", i] = None
                times["library", i].append(event_ms(library))
    for (name, i), ms in times.items():
        print(json.dumps({"lib": args.lib, "variant": name, **cases[i][0], "ms": ms,
                          "err": errs[name, i], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
