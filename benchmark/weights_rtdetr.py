"""Seeded weights for the cascade with RT-DETR as its person detector, and the
map from the program's key names to the reference's.

:func:`make_weights` draws as ``weights.py::make_weights`` does (one normal
and one uniform draw on the device, carved into tensors, fp32), with
``weights.py``'s rules for the face detector, IR-50 and ViTPose and these
for RT-DETR (``person_rtdetr``): lecun-normal convolution and linear
weights, ``nn.MultiheadAttention``'s ``in_proj_weight`` included; biases
N(0, 0.02); BatchNorm and LayerNorm as ``weights.py`` draws them; and the
heads set so that a random network's scores and boxes spread: the class
heads (``enc_score_head``, ``dec_score_head``) at ``rtdetr_score_gain``
times the lecun scale with the constant bias ``rtdetr_score_bias`` (the
published prior is -4.6, at which a random network serves almost no
person), the box heads' last layers at ``rtdetr_box_gain`` times it.

Two settings keep the random ResNet-50-vd from being chaotic, as a trained
one is not: every backbone BatchNorm's shift is drawn from
``rtdetr_backbone_bn_bias`` (non-negative, so that fewer ReLUs after them
switch), and the scale of each bottleneck's last BatchNorm (``branch2c``)
from ``rtdetr_residual_bn_weight`` (small, so that the shortcut carries
the stream: the "zero-gamma" start of Goyal et al., arXiv:1706.02677).
With the draws of the other models, bf16 rounding grew through the
calibrated backbone to 21, 52 and 81 % of C3, C4 and C5's mean magnitude
(fp32 against bf16 on the CPU, 160^2 frames), which no check bound to the
precision can tell from a fault; with these, to 3, 3 and 5 % (320^2).

RT-DETR's reference keeps the published names, which the program keeps
too: its key map is the identity.
"""

from __future__ import annotations

import re
from typing import Dict, List

import torch
from torch import nn

from benchmark import weights as wmod

_SCORE_HEAD = re.compile(r"(enc_score_head|dec_score_head\.\d+)\.(weight|bias)$")
_BOX_LAST = re.compile(r"(enc_bbox_head|dec_bbox_head\.\d+)\.layers\.2\.weight$")


def _rtdetr_specs(name: str, model: nn.Module, init: dict) -> List[wmod._Spec]:
    out = []
    for mname, m in model.named_modules():
        prefix = f"{mname}." if mname else ""
        for pname, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            key, shape = prefix + pname, tuple(t.shape)
            if pname == "num_batches_tracked":
                continue
            if pname in ("weight", "in_proj_weight") and (
                    isinstance(m, (nn.Conv2d, nn.Linear)) or pname == "in_proj_weight"):
                gain = (init["rtdetr_score_gain"] if _SCORE_HEAD.search(key) else
                        init["rtdetr_box_gain"] if _BOX_LAST.search(key) else 1.0)
                out.append((name, key, shape, "normal", gain * t[0].numel() ** -0.5, 0.0))
            elif _SCORE_HEAD.search(key):
                out.append((name, key, shape, "const", init["rtdetr_score_bias"], 0.0))
            elif pname in ("bias", "in_proj_bias") and (
                    isinstance(m, (nn.Conv2d, nn.Linear)) or pname == "in_proj_bias"):
                out.append((name, key, shape, "normal", 0.02, 0.0))
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                kind = {"weight": ("uniform",) + tuple(init["bn_weight"]),
                        "bias": ("normal", 0.05, 0.0), "running_mean": ("normal", 0.05, 0.0),
                        "running_var": ("uniform", 0.8, 1.2)}[pname]
                if key.startswith("backbone.") and pname == "bias":
                    kind = ("uniform",) + tuple(init["rtdetr_backbone_bn_bias"])
                elif ".branch2c." in key and pname == "weight":
                    kind = ("uniform",) + tuple(init["rtdetr_residual_bn_weight"])
                out.append((name, key, shape) + kind)
            elif isinstance(m, nn.LayerNorm):
                kind = ("uniform", 0.9, 1.1) if pname == "weight" else ("normal", 0.02, 0.0)
                out.append((name, key, shape) + kind)
            else:
                raise ValueError(f"no draw for {name}.{key} ({type(m).__name__})")
    return out


@torch.no_grad()
def make_weights(shapes: Dict[str, nn.Module], seed: int, device, init: dict
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Weights for the reference models in ``shapes`` (built on the meta
    device) -> model name -> state dict under the reference's key names."""
    specs = [s for name, m in shapes.items()
             for s in (_rtdetr_specs(name, m, init) if name == "person_rtdetr" else
                       wmod._specs(name, m, init["bn_weight"], init["head_gain"]))]
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


KEY_MAPS = {**wmod.KEY_MAPS, "person_rtdetr": lambda key: key}


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
