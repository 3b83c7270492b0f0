"""Weight bridges into the port's ``state_dict``s.

**From JAX.** :func:`from_jax_variables` carries a flax variable tree of
the JAX package across. The port's modules carry the flax module names, so
a leaf at ``params/<path>/<leaf>`` becomes ``<path>.<torch leaf>`` with
these layout changes:

* conv kernel (kh, kw, I/g, O) -> (O, I/g, kh, kw), depthwise and
  ``PatchEmbed`` included;
* ``deconv*`` kernel (kh, kw, I, O) of flax's ``ConvTranspose`` -> the
  spatially flipped (I, O, kh, kw) weight of ``nn/vit.py::ConvTranspose``;
* Dense kernel (I, O) -> (O, I);
* BatchNorm / LayerNorm ``scale`` -> ``weight``; ``batch_stats`` ``mean`` /
  ``var`` -> ``running_mean`` / ``running_var``;
* IR-Net ``output_linear``: the JAX model flattens NHWC (h, w, c), the port
  NCHW (c, h, w), so the rows are permuted;
* PReLU ``alpha``, biases, the folded ``pos_embed`` table, the combined
  model's ``face_kernel`` (E, C) and its ``margin_mean`` / ``margin_std``
  buffers as they are.

**From the reference's torch checkpoints.** ``port_resnet50``,
``port_vitpose``, ``port_irnet``, ``port_yolo``, ``port_adapter`` and
``port_combined`` take a state dict of the reference's own modules
(torchvision ResNet-50, HF ViTPose, AdaFace IR-Net, yolopt YOLOv11, the
combined graft) and return the port's state dict: each builds the flax
variable tree the JAX package's converter of the same name builds (own
copies of its numpy code), then goes through :func:`from_jax_variables`.

Numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}

StateDict = Dict[str, torch.Tensor]


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _output_linear_rows(kernel: np.ndarray, channels: int) -> np.ndarray:
    """(h*w*c, E) NHWC-flatten kernel -> (E, c*h*w) NCHW-flatten weight."""
    spatial = int(round((kernel.shape[0] // channels) ** 0.5))
    if spatial * spatial * channels != kernel.shape[0]:
        raise ValueError(f"output_linear rows {kernel.shape[0]} are not {channels} * s^2")
    w = kernel.reshape(spatial, spatial, channels, -1).transpose(3, 2, 0, 1)
    return w.reshape(w.shape[0], -1)


def from_jax_variables(variables: Mapping[str, Any]) -> StateDict:
    """``{"params": ..., "batch_stats": ...}`` of a JAX model (the cascade,
    the combined model or one of their component models) -> the state dict
    of the matching port module, as fp32 CPU tensors."""
    leaves = dict(_flatten(variables.get("params", {})))
    stats = dict(_flatten(variables.get("batch_stats", {})))
    out: Dict[str, np.ndarray] = {}
    for path, value in leaves.items():
        *mods, leaf = path
        if leaf == "kernel" and value.ndim == 4:
            if mods and mods[-1].startswith("deconv"):
                value = value[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                value = value.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and value.ndim == 2:
            if mods and mods[-1] == "output_linear":
                bn_scale = leaves[tuple(mods[:-1]) + ("output_bn", "scale")]
                value = _output_linear_rows(value, bn_scale.shape[0])
            else:
                value = value.T
        out[".".join(mods + [_LEAF.get(leaf, leaf)])] = value
    for path, value in stats.items():
        *mods, leaf = path
        out[".".join(mods + [_LEAF.get(leaf, leaf)])] = value
    # a copy (scalars stay 0-d; ascontiguousarray would make them 1-d)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in out.items()}


# --------------------------------------------------------------------------
# reference torch state dicts -> flax-shaped trees (the JAX package's
# converters, own copies) -> the port's state dicts
# --------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        x = x.numpy()
    return np.asarray(x)


def to_numpy_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    return {k: _np(v) for k, v in state_dict.items()}


def conv_w(sd, key):
    """torch conv weight (O, I, kh, kw) -> flax kernel (kh, kw, I, O)."""
    return _np(sd[key]).transpose(2, 3, 1, 0)


def dense_w(sd, key):
    """torch linear weight (O, I) -> flax kernel (I, O)."""
    return _np(sd[key]).T


def _bn(sd, prefix, affine: bool = True):
    """(params, stats) of a torch BatchNorm at ``prefix``."""
    params = {}
    if affine:
        params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _ln(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def _resnet50_tree(sd, stage_sizes=(3, 4, 6, 3)):
    params: Dict[str, Any] = {"conv1": {"kernel": conv_w(sd, "conv1.weight")}}
    stats: Dict[str, Any] = {}
    params["bn1"], stats["bn1"] = _bn(sd, "bn1")
    for stage, n in enumerate(stage_sizes):
        for block in range(n):
            t = f"layer{stage + 1}.{block}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            for i in (1, 2, 3):
                bp[f"conv{i}"] = {"kernel": conv_w(sd, f"{t}.conv{i}.weight")}
                bp[f"bn{i}"], bs[f"bn{i}"] = _bn(sd, f"{t}.bn{i}")
            if f"{t}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {"kernel": conv_w(sd, f"{t}.downsample.0.weight")}
                bp["downsample_bn"], bs["downsample_bn"] = _bn(sd, f"{t}.downsample.1")
            params[f"layer{stage + 1}_{block}"], stats[f"layer{stage + 1}_{block}"] = bp, bs
    return {"params": params, "batch_stats": stats}


def _vitpose_tree(sd):
    bb: Dict[str, Any] = {
        "patch_embed": {
            "kernel": conv_w(sd, "backbone.embeddings.patch_embeddings.projection.weight"),
            "bias": _np(sd["backbone.embeddings.patch_embeddings.projection.bias"]),
        }
    }
    pos = _np(sd["backbone.embeddings.position_embeddings"])[0]  # (P+1, C)
    bb["pos_embed"] = pos[1:] + pos[:1]  # fold the extra token
    layer = 0
    while f"backbone.encoder.layer.{layer}.layernorm_before.weight" in sd:
        t = f"backbone.encoder.layer.{layer}"
        dense = lambda key: {"kernel": dense_w(sd, f"{key}.weight"),  # noqa: E731
                             "bias": _np(sd[f"{key}.bias"])}
        attn = {mine: dense(f"{t}.attention.attention.{theirs}")
                for mine, theirs in (("q", "query"), ("k", "key"), ("v", "value"))}
        attn["proj"] = dense(f"{t}.attention.output.dense")
        bb[f"block{layer}"] = {"ln1": _ln(sd, f"{t}.layernorm_before"),
                               "ln2": _ln(sd, f"{t}.layernorm_after"), "attn": attn,
                               "fc1": dense(f"{t}.mlp.fc1"), "fc2": dense(f"{t}.mlp.fc2")}
        layer += 1
    bb["ln_final"] = _ln(sd, "backbone.layernorm")
    head = {"conv": {"kernel": conv_w(sd, "head.conv.weight"), "bias": _np(sd["head.conv.bias"])}}
    return {"params": {"backbone": bb, "head": head}}


def _irnet_tree(sd, num_layers=50, mode="ir", skip_input_layer=False):
    from prpe_tpu_torch.nn.irnet import _BLOCKS

    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if not skip_input_layer:
        params["input_conv"] = {"kernel": conv_w(sd, "input_layer.0.weight")}
        params["input_bn"], stats["input_bn"] = _bn(sd, "input_layer.1")
        params["input_prelu"] = {"alpha": _np(sd["input_layer.2.weight"])}
    basic = num_layers <= 100
    # res_layer indices: BatchNorm, conv, BatchNorm, PReLU, conv, BatchNorm
    # (basic), then PReLU, conv, BatchNorm (bottleneck)
    layout = ((0, "bn0"), (1, "conv1"), (2, "bn1"), (3, "prelu"), (4, "conv2"), (5, "bn2"))
    if not basic:
        layout = ((0, "bn0"), (1, "conv1"), (2, "bn1"), (3, "prelu1"), (4, "conv2"),
                  (5, "bn2"), (6, "prelu2"), (7, "conv3"), (8, "bn3"))
    idx, in_ch = 0, 64
    for depth, num_units in _BLOCKS[num_layers]:
        for _ in range(num_units):
            t = f"body.{idx}"
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            if in_ch != depth:
                bp["shortcut_conv"] = {"kernel": conv_w(sd, f"{t}.shortcut_layer.0.weight")}
                bp["shortcut_bn"], bs["shortcut_bn"] = _bn(sd, f"{t}.shortcut_layer.1")
            for i, name in layout:
                key = f"{t}.res_layer.{i}"
                if name.startswith("bn"):
                    bp[name], bs[name] = _bn(sd, key)
                elif name.startswith("conv"):
                    bp[name] = {"kernel": conv_w(sd, f"{key}.weight")}
                else:
                    bp[name] = {"alpha": _np(sd[f"{key}.weight"])}
            if mode == "ir_se":
                se = f"{t}.res_layer.se_block"
                bp["se"] = {"fc1": {"kernel": conv_w(sd, f"{se}.fc1.weight")},
                            "fc2": {"kernel": conv_w(sd, f"{se}.fc2.weight")}}
            params[f"body{idx}"], stats[f"body{idx}"] = bp, bs
            in_ch = depth
            idx += 1
    # output layer: 0 BN2d, 1 dropout, 2 flatten, 3 linear, 4 BN1d(affine=False)
    params["output_bn"], stats["output_bn"] = _bn(sd, "output_layer.0")
    w = _np(sd["output_layer.3.weight"])  # (E, C*H*W), C-major flatten
    out_ch = 512 if basic else 2048
    spatial = int(round((w.shape[1] // out_ch) ** 0.5))
    if spatial * spatial * out_ch != w.shape[1]:
        raise ValueError(f"output_layer.3.weight in-dim {w.shape[1]} is not {out_ch} * s^2")
    w = w.reshape(w.shape[0], out_ch, spatial, spatial).transpose(0, 2, 3, 1)
    params["output_linear"] = {
        "kernel": w.reshape(w.shape[0], -1).T,
        "bias": _np(sd["output_layer.3.bias"]) if "output_layer.3.bias" in sd
        else np.zeros((512,), np.float32),
    }
    _, stats["output_bn1d"] = _bn(sd, "output_layer.4", affine=False)
    return {"params": params, "batch_stats": stats}


def _convbn(sd, t):
    """yolopt ``Conv`` (conv + norm) -> ConvBN (params, stats)."""
    bnp, bns = _bn(sd, f"{t}.norm")
    return {"conv": {"kernel": conv_w(sd, f"{t}.conv.weight")}, "bn": bnp}, {"bn": bns}


def _named(sd, pairs):
    """(params, stats) of several children: ``pairs`` of (name, builder)."""
    p, s = {}, {}
    for name, build in pairs:
        p[name], s[name] = build()
    return p, s


def _residual(sd, t):
    return _named(sd, [(n, lambda n=n: _convbn(sd, f"{t}.{n}")) for n in ("conv1", "conv2")])


def _cspmodule(sd, t):
    pairs = [(n, lambda n=n: _convbn(sd, f"{t}.{n}")) for n in ("conv1", "conv2", "conv3")]
    pairs += [(f"res{i}", lambda i=i: _residual(sd, f"{t}.res_m.{i}")) for i in (0, 1)]
    return _named(sd, pairs)


def _csp(sd, t, n, csp_inner):
    inner = _cspmodule if csp_inner else _residual
    pairs = [(c, lambda c=c: _convbn(sd, f"{t}.{c}")) for c in ("conv1", "conv2")]
    pairs += [(f"m{i}", lambda i=i: inner(sd, f"{t}.res_m.{i}")) for i in range(n)]
    return _named(sd, pairs)


def _psa(sd, t, n):
    def block(i):
        b = f"{t}.res_m.{i}"
        attn = lambda: _named(sd, [  # noqa: E731
            ("qkv", lambda: _convbn(sd, f"{b}.conv1.qkv")),
            ("pe", lambda: _convbn(sd, f"{b}.conv1.conv1")),
            ("proj", lambda: _convbn(sd, f"{b}.conv1.conv2"))])
        return _named(sd, [("attn", attn), ("ffn1", lambda: _convbn(sd, f"{b}.conv2.0")),
                           ("ffn2", lambda: _convbn(sd, f"{b}.conv2.1"))])

    pairs = [(c, lambda c=c: _convbn(sd, f"{t}.{c}")) for c in ("conv1", "conv2")]
    pairs += [(f"blk{i}", lambda i=i: block(i)) for i in range(n)]
    return _named(sd, pairs)


def _yolo_tree(sd, variant="n"):
    from prpe_tpu_torch.nn.yolo import VARIANTS

    d, ci = VARIANTS[variant]["depth"], VARIANTS[variant]["csp"]
    net = [("p1_conv", lambda: _convbn(sd, "net.p1.0")),
           ("p2_conv", lambda: _convbn(sd, "net.p2.0")),
           ("p2_csp", lambda: _csp(sd, "net.p2.1", d[0], ci[0])),
           ("p3_conv", lambda: _convbn(sd, "net.p3.0")),
           ("p3_csp", lambda: _csp(sd, "net.p3.1", d[1], ci[0])),
           ("p4_conv", lambda: _convbn(sd, "net.p4.0")),
           ("p4_csp", lambda: _csp(sd, "net.p4.1", d[2], ci[1])),
           ("p5_conv", lambda: _convbn(sd, "net.p5.0")),
           ("p5_csp", lambda: _csp(sd, "net.p5.1", d[3], ci[1])),
           ("p5_spp", lambda: _named(sd, [(c, lambda c=c: _convbn(sd, f"net.p5.2.{c}"))
                                          for c in ("conv1", "conv2")])),
           ("p5_psa", lambda: _psa(sd, "net.p5.3", d[4]))]
    fpn = [(name, (lambda name=name, inner=inner: _csp(sd, f"fpn.{name}", d[5], inner))
            if inner is not None else (lambda name=name: _convbn(sd, f"fpn.{name}")))
           for name, inner in (("h1", ci[0]), ("h2", ci[0]), ("h3", None), ("h4", ci[0]),
                               ("h5", None), ("h6", ci[1]))]
    head_p: Dict[str, Any] = {}
    head_s: Dict[str, Any] = {}
    for lvl in range(3):
        for j in (0, 1):
            head_p[f"box{lvl}_{j}"], head_s[f"box{lvl}_{j}"] = _convbn(sd, f"head.box.{lvl}.{j}")
        head_p[f"box{lvl}_out"] = {"kernel": conv_w(sd, f"head.box.{lvl}.2.weight"),
                                   "bias": _np(sd[f"head.box.{lvl}.2.bias"])}
        for j in range(4):
            head_p[f"cls{lvl}_{j}"], head_s[f"cls{lvl}_{j}"] = _convbn(sd, f"head.cls.{lvl}.{j}")
        if f"head.cls.{lvl}.4.weight" in sd:
            head_p[f"cls{lvl}_out"] = {"kernel": conv_w(sd, f"head.cls.{lvl}.4.weight"),
                                       "bias": _np(sd[f"head.cls.{lvl}.4.bias"])}
    net_p, net_s = _named(sd, net)
    fpn_p, fpn_s = _named(sd, fpn)
    return {"params": {"net": net_p, "fpn": fpn_p, "head": head_p},
            "batch_stats": {"net": net_s, "fpn": fpn_s, "head": head_s}}


# torch Sequential conv indices -> _ConvBNAct child names, per adapter
# flavour (the AdaFace and ViTPose adapters share one layout)
_ADAPTER_LAYOUT = {
    "yolo": ((0, "reduce"), (4, "spatial"), (7, "down1"), (10, "down2"), (13, "down3"),
             (16, "out")),
    "simple": ((0, "reduce"), (4, "down1"), (7, "down2"), (10, "out")),
}


def _adapter_tree(sd, prefix="adapter", flavor="simple", prelu=False):
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for idx, name in _ADAPTER_LAYOUT[flavor]:
        bnp, bns = _bn(sd, f"{prefix}.{idx + 1}")
        p = {"conv": {"kernel": conv_w(sd, f"{prefix}.{idx}.weight"),
                      "bias": _np(sd[f"{prefix}.{idx}.bias"])}, "bn": bnp}
        if prelu:
            p["prelu"] = {"alpha": _np(sd[f"{prefix}.{idx + 2}.weight"])}
        params[name], stats[name] = p, {"bn": bns}
    return {"params": params, "batch_stats": stats}


def _subdict(sd: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    pl = len(prefix) + 1
    return {k[pl:]: v for k, v in sd.items() if k.startswith(prefix + ".")}


def _combined_tree(sd, num_layers=50, mode="ir", variant="n", backbone_stages=(3, 4, 6, 3)):
    sd = to_numpy_state_dict(sd)
    out_p: Dict[str, Any] = {}
    out_s: Dict[str, Any] = {}

    def put(name, tree):
        out_p[name] = tree["params"]
        if "batch_stats" in tree:
            out_s[name] = tree["batch_stats"]

    put("backbone", _resnet50_tree(_subdict(sd, "backbone"), backbone_stages))
    for branch in ("yolo_person", "yolo_face"):
        bsd = _subdict(sd, branch)
        put(f"{branch}_adapter", _adapter_tree(bsd, "adapter", "yolo"))
        put(branch, _yolo_tree(_subdict(bsd, "yolo"), variant))
    fsd = _subdict(sd, "ada_face")
    put("ada_face_adapter", _adapter_tree(fsd, "adapter", "simple", prelu=True))
    put("ada_face", _irnet_tree(_subdict(fsd, "adaface_model"), num_layers, mode))
    out_p["face_kernel"] = _np(fsd["head.kernel"])
    out_s["margin_mean"] = _np(fsd["head.batch_mean"]).reshape(()).astype(np.float32)
    out_s["margin_std"] = _np(fsd["head.batch_std"]).reshape(()).astype(np.float32)
    psd = _subdict(sd, "vit_pose")
    put("vit_pose_adapter", _adapter_tree(psd, "adapter", "simple"))
    put("vit_pose", _vitpose_tree(_subdict(psd, "vit_pose")))
    return {"params": out_p, "batch_stats": out_s}


def port_resnet50(sd: Mapping[str, Any], stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)) -> StateDict:
    """torchvision ResNet-50 (``fc`` ignored) -> ``ResNetTrunk`` state dict;
    ``stage_sizes`` for trunks of other depths."""
    return from_jax_variables(_resnet50_tree(sd, stage_sizes))


def port_vitpose(sd: Mapping[str, Any]) -> StateDict:
    """HF ``VitPoseForPoseEstimation`` (simple decoder) -> ``ViTPose``."""
    return from_jax_variables(_vitpose_tree(sd))


def port_irnet(sd: Mapping[str, Any], num_layers: int = 50, mode: str = "ir",
               skip_input_layer: bool = False) -> StateDict:
    """AdaFace IR-Net (``model.`` / ``module.`` prefixes stripped) ->
    ``IRNet``. ``skip_input_layer`` leaves out the input conv, BatchNorm and
    PReLU, for the combined model's 64-channel input layer."""
    return from_jax_variables(_irnet_tree(sd, num_layers, mode, skip_input_layer))


def port_yolo(sd: Mapping[str, Any], variant: str = "n") -> StateDict:
    """yolopt YOLOv11 -> ``YOLO``; the ``head.cls{l}_out`` convs come across
    with the checkpoint's class count (drop them for an nc = 1 model)."""
    return from_jax_variables(_yolo_tree(sd, variant))


def port_adapter(sd: Mapping[str, Any], prefix: str = "adapter", flavor: str = "simple",
                 prelu: bool = False) -> StateDict:
    """A reference adapter ``nn.Sequential`` -> ``YoloAdapter`` (``flavor=
    "yolo"``), ``AdaFaceAdapter`` (``"simple"``, ``prelu=True``) or
    ``VitPoseAdapter`` (``"simple"``)."""
    return from_jax_variables(_adapter_tree(sd, prefix, flavor, prelu))


def port_combined(sd: Mapping[str, Any], num_layers: int = 50, mode: str = "ir",
                  variant: str = "n", backbone_stages: Tuple[int, ...] = (3, 4, 6, 3)) -> StateDict:
    """The reference ``CombinedModel.state_dict()`` (``backbone.*``,
    ``yolo_{person,face}.{adapter,yolo}.*``,
    ``ada_face.{adapter,adaface_model,head}.*``, ``vit_pose.{adapter,vit_pose}.*``)
    -> the port's ``CombinedModel``; the AdaFace head gives ``face_kernel``
    and the margin buffers."""
    return from_jax_variables(_combined_tree(sd, num_layers, mode, variant, backbone_stages))


def merge_variables(base: Mapping[str, torch.Tensor], ported: Mapping[str, torch.Tensor]
                    ) -> StateDict:
    """``ported`` entries over ``base`` (a fresh model's state dict), as
    ``load_state_dict(strict=False)`` would take them; a shape that differs
    from the base's raises."""
    out = dict(base)
    for k, v in ported.items():
        if k in base and tuple(base[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: {tuple(base[k].shape)} vs ported "
                             f"{tuple(v.shape)}")
        out[k] = v
    return out
