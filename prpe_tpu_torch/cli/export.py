"""Export an inference program for deployment.

    python -m prpe_tpu_torch.cli.export --model yolo|irnet|vitpose|combined_pose
        [--batch-size N] [--image-size S] [--output FILE.pt2] [--preset full|tiny]
        [--device cpu]

``torch.export`` traces the model's forward into an ``ExportedProgram``,
written with ``torch.export.save`` and read back with :func:`load_program`.
The kernels are custom ops (``prpe::mhsa_packed``, ``prpe::nms_keep``, ...),
so the program holds each launch as one node, and runs the kernel on CUDA
and its plain version on the CPU. Weights are random from a seed, as in
the JAX package's ``cli/export.py``. :func:`save_inference_checkpoint`
writes a state dict with its floating tensors in bf16.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Mapping, Tuple, Union

import torch
from torch import nn

MODELS = ("yolo", "irnet", "vitpose", "combined_pose")


def save_inference_checkpoint(state: Union[nn.Module, Mapping[str, torch.Tensor]],
                              path: pathlib.Path) -> pathlib.Path:
    """A model's (or a state dict's) entries on the CPU, floating tensors in
    bf16 and every other tensor as it is, saved with ``torch.save``."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    slim = {k: v.detach().cpu().to(torch.bfloat16) if v.is_floating_point() else v.detach().cpu()
            for k, v in state.items()}
    torch.save(slim, path)
    return pathlib.Path(path)


class Detector(nn.Module):
    """YOLO followed by ``decode_predictions``: (B, S, S, 3) -> (B, A, 4 + nc)."""

    def __init__(self, yolo: nn.Module, nc: int = 1):
        super().__init__()
        self.yolo = yolo
        self.nc = nc

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from prpe_tpu_torch.nn.yolo import decode_predictions

        return decode_predictions(self.yolo(x), self.nc)


class CombinedPose(nn.Module):
    """``CombinedModel.pose`` with only the submodules it runs, under their
    names in the combined model."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.backbone = model.backbone
        self.vit_pose_adapter = model.vit_pose_adapter
        self.vit_pose = model.vit_pose

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.vit_pose(self.vit_pose_adapter(self.backbone(x)))


def build_program(name: str, batch: int = 1, image_size: int = 640, preset: str = "full",
                  device=None, seed: int = 0) -> Tuple[nn.Module, torch.Tensor]:
    """(module, example input of zeros) for ``name`` at ``preset``: ``full``
    is YOLOv11-n, IR-50, ViTPose-B or the combined model's pose path at
    full width; ``tiny`` shrinks each (IR-18, a 1-layer ViT of width 32 at
    64x48, a (1, 1, 1, 1) trunk)."""
    from prpe_tpu_torch.core.config import AdaFaceConfig, CombinedModelConfig, PoseConfig
    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.nn.common import build_on

    dev = resolve_device(device)
    tiny = preset == "tiny"
    pose = (PoseConfig(input_size=(64, 48), heatmap_size=(16, 12), vit_hidden=32, vit_layers=1,
                       vit_heads=2) if tiny else PoseConfig())
    if name == "yolo":
        from prpe_tpu_torch.nn.yolo import YOLO

        model = Detector(build_on(dev, lambda: YOLO(nc=1), seed))
        shape = (batch, image_size, image_size, 3)
    elif name == "irnet":
        from prpe_tpu_torch.nn.irnet import build_irnet

        model = build_on(dev, lambda: build_irnet("ir_18" if tiny else "ir_50"), seed)
        shape = (batch, 112, 112, 3)
    elif name == "vitpose":
        from prpe_tpu_torch.nn.vit import ViTPose

        model = build_on(dev, lambda: ViTPose(
            image_size=pose.input_size, hidden=pose.vit_hidden, layers=pose.vit_layers,
            heads=pose.vit_heads), seed)
        shape = (batch, *pose.input_size, 3)
    elif name == "combined_pose":
        from prpe_tpu_torch.models.combined import CombinedModel

        cfg = (CombinedModelConfig(backbone_stages=(1, 1, 1, 1), pose=pose,
                                   face=AdaFaceConfig(arch="ir_18", num_classes=8))
               if tiny else CombinedModelConfig())
        model = CombinedPose(CombinedModel(cfg, device=dev, seed=seed))
        shape = (batch, image_size, image_size, 3)
    else:
        raise ValueError(f"unknown model {name!r}; supported: {MODELS}")
    return model.eval(), torch.zeros(shape, device=dev)


def export_program(model: nn.Module, x: torch.Tensor,
                   path=None) -> torch.export.ExportedProgram:
    """``torch.export.export(model, (x,))``, saved to ``path`` when given."""
    program = torch.export.export(model, (x,))
    if path is not None:
        torch.export.save(program, path)
    return program


def load_program(path) -> torch.export.ExportedProgram:
    """``torch.export.load`` with the kernels' custom ops registered."""
    import prpe_tpu_torch.ops.kernels.attention  # noqa: F401
    import prpe_tpu_torch.ops.kernels.bn_act  # noqa: F401
    import prpe_tpu_torch.ops.kernels.ln_mhsa  # noqa: F401
    import prpe_tpu_torch.ops.kernels.nms  # noqa: F401

    return torch.export.load(path)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="yolo", choices=MODELS)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--output", default="exported.pt2")
    ap.add_argument("--preset", choices=("full", "tiny"), default="full",
                    help="'tiny' shrinks the model for quick CPU runs")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    model, x = build_program(args.model, args.batch_size, args.image_size, args.preset,
                             args.device)
    out = pathlib.Path(args.output)
    export_program(model, x, out)
    print(f"exported {args.model} to {out} ({out.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
