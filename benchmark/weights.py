"""Seeded weights for both sides, and the map from the program's key names
to the reference's.

:func:`make_weights` draws every parameter and statistic of the reference
models on the device from ``seed``, in two large calls (one normal, one
uniform draw, carved into tensors), in fp32, the type the configuration
serves its parameters in. The program gets the very same tensors through
:func:`program_state_dict`; it draws nothing of its own that survives.

The draws give a working cascade rather than a silent or a chaotic one:
lecun-normal convolution and linear weights (the detectors' two output
convolutions at ``head_gain`` times that scale), BatchNorm scales drawn from
the configuration's ``bn_weight`` range and shifts and statistics near zero
and one (the cascade's driver then calibrates the statistics on real
frames, so that folding them is exercised on true values), LayerNorm affines near identity,
PReLU slope 0.25, positional table N(0, 0.02), DFL box bias 1 and
class-score bias 0. Small
BatchNorm scales keep a random network from amplifying rounding as a chaotic
one does (a trained one does not), and the output gain spreads scores and
boxes again, so that candidates pass the confidence gate and NMS, the face
stage, the gate and ViTPose all see work.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

# (model, key, shape, kind, a, b): "normal" draws N(0, 1) times a,
# "uniform" draws U(a, b), "const" fills with a
_Spec = Tuple[str, str, tuple, str, float, float]
# AdaFace's norm statistics start at its published values
MARGIN_INIT = {"margin_mean": 20.0, "margin_std": 100.0}


def _specs(name: str, model: nn.Module, bn_weight, head_gain: float) -> List[_Spec]:
    out = []
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            key = prefix + pname
            shape = tuple(t.shape)
            if pname == "num_batches_tracked":
                continue
            if isinstance(m, (nn.Conv2d, nn.Linear)) and pname == "weight":
                gain = head_gain if re.search(r"head\.(box\.\d+\.2|cls\.\d+\.4)\.weight$",
                                              key) else 1.0
                out.append((name, key, shape, "normal", gain * t[0].numel() ** -0.5, 0.0))
            elif isinstance(m, (nn.Conv2d, nn.Linear)) and pname == "bias":
                if re.search(r"head\.box\.\d+\.2\.bias$", key):
                    out.append((name, key, shape, "const", 1.0, 0.0))
                elif re.search(r"head\.cls\.\d+\.4\.bias$", key):
                    out.append((name, key, shape, "const", 0.0, 0.0))
                else:
                    out.append((name, key, shape, "normal", 0.02, 0.0))
            elif isinstance(m, nn.modules.batchnorm._BatchNorm) or hasattr(m, "momentum"):
                kind = {"weight": ("uniform",) + tuple(bn_weight), "bias": ("normal", 0.05, 0.0),
                        "running_mean": ("normal", 0.05, 0.0),
                        "running_var": ("uniform", 0.8, 1.2)}[pname]
                out.append((name, key, shape) + kind)
            elif isinstance(m, nn.LayerNorm):
                kind = ("uniform", 0.9, 1.1) if pname == "weight" else ("normal", 0.02, 0.0)
                out.append((name, key, shape) + kind)
            elif isinstance(m, nn.PReLU) or pname == "alpha":
                out.append((name, key, shape, "const", 0.25, 0.0))
            elif pname == "face_kernel":
                out.append((name, key, shape, "normal", 1.0, 0.0))
            elif pname in MARGIN_INIT:
                out.append((name, key, shape, "const", MARGIN_INIT[pname], 0.0))
            elif pname == "pos_embed":
                out.append((name, key, shape, "normal", 0.02, 0.0))
            else:
                raise ValueError(f"no draw for {name}.{key} ({type(m).__name__})")
    return out


@torch.no_grad()
def make_weights(shapes: Dict[str, nn.Module], seed: int, device, bn_weight,
                 head_gain: float) -> Dict[str, Dict[str, torch.Tensor]]:
    """Weights for the reference models in ``shapes`` (built on the meta
    device) -> model name -> state dict under the reference's key names."""
    specs = [s for name, m in shapes.items() for s in _specs(name, m, bn_weight, head_gain)]
    numel = lambda shape: int(torch.Size(shape).numel())  # noqa: E731
    n_normal = sum(numel(s[2]) for s in specs if s[3] == "normal")
    n_uniform = sum(numel(s[2]) for s in specs if s[3] == "uniform")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {name: {} for name in shapes}
    at = {"normal": 0, "uniform": 0}
    for name, key, shape, kind, a, b in specs:
        n = numel(shape)
        if kind == "const":
            t = torch.full(shape, a, device=device)
        else:
            flat = normal if kind == "normal" else uniform
            t = flat[at[kind]:at[kind] + n].view(shape)
            at[kind] += n
            t = t * a if kind == "normal" else t * (b - a) + a
        out[name][key] = t
    return out


# ---- the program's key names -> the reference's ------------------------------

_YOLO_RULES = [
    (r"^net\.p1_conv\.", "net.p1.0."),
    (r"^net\.p([2-4])_conv\.", r"net.p\1.0."),
    (r"^net\.p([2-4])_csp\.", r"net.p\1.1."),
    (r"^net\.p5_conv\.", "net.p5.0."),
    (r"^net\.p5_csp\.", "net.p5.1."),
    (r"^net\.p5_spp\.", "net.p5.2."),
    (r"^net\.p5_psa\.", "net.p5.3."),
    (r"\.blk(\d+)\.attn\.pe\.", r".res_m.\1.conv1.conv1."),
    (r"\.blk(\d+)\.attn\.proj\.", r".res_m.\1.conv1.conv2."),
    (r"\.blk(\d+)\.attn\.", r".res_m.\1.conv1."),
    (r"\.blk(\d+)\.ffn1\.", r".res_m.\1.conv2.0."),
    (r"\.blk(\d+)\.ffn2\.", r".res_m.\1.conv2.1."),
    (r"\.m(\d+)\.", r".res_m.\1."),
    (r"\.res([01])\.", r".res_m.\1."),
    (r"^head\.box(\d+)_([01])\.", r"head.box.\1.\2."),
    (r"^head\.box(\d+)_out\.", r"head.box.\1.2."),
    (r"^head\.cls(\d+)_([0-3])\.", r"head.cls.\1.\2."),
    (r"^head\.cls(\d+)_out\.", r"head.cls.\1.4."),
    (r"\.bn\.", ".norm."),
]

_IRNET_RULES = [
    (r"^input_conv\.", "input_layer.0."),
    (r"^input_bn\.", "input_layer.1."),
    (r"^input_prelu\.alpha$", "input_layer.2.weight"),
    (r"^body(\d+)\.bn0\.", r"body.\1.res_layer.0."),
    (r"^body(\d+)\.conv1\.", r"body.\1.res_layer.1."),
    (r"^body(\d+)\.bn1\.", r"body.\1.res_layer.2."),
    (r"^body(\d+)\.prelu\.alpha$", r"body.\1.res_layer.3.weight"),
    (r"^body(\d+)\.conv2\.", r"body.\1.res_layer.4."),
    (r"^body(\d+)\.bn2\.", r"body.\1.res_layer.5."),
    (r"^body(\d+)\.shortcut_conv\.", r"body.\1.shortcut_layer.0."),
    (r"^body(\d+)\.shortcut_bn\.", r"body.\1.shortcut_layer.1."),
    (r"^output_bn\.", "output_layer.0."),
    (r"^output_linear\.", "output_layer.3."),
    (r"^output_bn1d\.", "output_layer.4."),
]


def _rules(rules) -> Callable[[str], str]:
    def apply(key: str) -> str:
        for pattern, repl in rules:
            key = re.sub(pattern, repl, key)
        return key
    return apply


KEY_MAPS: Dict[str, Callable[[str], str]] = {
    "person_yolo": _rules(_YOLO_RULES),
    "face_yolo": _rules(_YOLO_RULES),
    "irnet": _rules(_IRNET_RULES),
    "vitpose": lambda key: key,
}


def program_state_dict(program_keys, weights: Dict[str, Dict[str, torch.Tensor]]
                       ) -> Dict[str, torch.Tensor]:
    """The program's ``<model>.<key>`` names -> the reference's tensors.
    Raises on a key the map does not reach or a reference tensor left over."""
    out, used = {}, set()
    for full in program_keys:
        model, key = full.split(".", 1)
        ref_key = KEY_MAPS[model](key)
        if ref_key not in weights[model]:
            raise KeyError(f"{full} maps to {model}.{ref_key}, which the reference lacks")
        out[full] = weights[model][ref_key]
        used.add((model, ref_key))
    left = [f"{m}.{k}" for m, sd in weights.items() for k in sd if (m, k) not in used]
    if left:
        raise KeyError(f"reference tensors the program does not take: {left[:6]}")
    return out

