"""Build the combined multi-task model from the reference's component
checkpoints.

    python -m prpe_tpu_torch.cli.build_model [--component-dir DIR]
        [--output FILE.pt] [--device cpu]

Loads the torch checkpoints in ``DIR`` (``resnet50.pth``, ``yolo11n.pt``
and ``yolov11n-face.pt``, ``adaface_ir50_ms1mv2.ckpt``,
``vitpose-base-simple.pth``), converts each into the port's layout
(``models/porting.py``) with the JAX package's surgeries (the detection
heads keep everything but the final class conv, so the nc = 1 heads stay
freshly initialised; the AdaFace input layer is dropped for the
64-channel one), and saves the combined model's state dict with
``torch.save``. A missing file leaves that component at its seeded
initialisation, so the command always writes a loadable model.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
from typing import Dict, Optional

import torch

from prpe_tpu_torch.core.config import CombinedModelConfig
from prpe_tpu_torch.models import porting
from prpe_tpu_torch.models.combined import CombinedModel


def _merge_into(state: Dict[str, torch.Tensor], branch: str,
                ported: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return porting.merge_variables(state, {f"{branch}.{k}": v for k, v in ported.items()})


def build_variables(component_dir: pathlib.Path, cfg: Optional[CombinedModelConfig] = None,
                    log=print, dtype: Optional[torch.dtype] = None, device=None):
    """-> (CombinedModel with the components found in ``component_dir``
    loaded, its state dict). Built on ``device`` (CUDA unless the caller
    names another)."""
    cfg = cfg or CombinedModelConfig()
    model = CombinedModel(cfg, dtype or torch.float32, device=device, seed=0)
    state = model.state_dict()

    def load_torch(path):
        # the reference's checkpoints pickle whole modules, not only tensors
        return torch.load(path, map_location="cpu", weights_only=False)

    rn_path = component_dir / "resnet50.pth"
    if rn_path.exists():
        state = _merge_into(state, "backbone",
                            porting.port_resnet50(load_torch(rn_path), cfg.backbone_stages))
        log(f"ported ResNet-50 from {rn_path}")
    else:
        log(f"[fresh init] backbone (no {rn_path})")

    # the face branch prefers the face detector and falls back to the person
    # detector's file, as the JAX package does
    face_candidates = ["yolov11n-face.pt", "yolo11n.pt"]
    face_file = next((f for f in face_candidates if (component_dir / f).exists()),
                     face_candidates[-1])
    for branch, fname in (("yolo_person", "yolo11n.pt"), ("yolo_face", face_file)):
        yp = component_dir / fname
        if yp.exists():
            ckpt = load_torch(yp)
            m = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
            ported = porting.port_yolo(m.state_dict() if hasattr(m, "state_dict") else m,
                                       variant=cfg.detection.variant)
            # nc=80 -> nc=1 surgery: drop the pretrained final class convs
            ported = {k: v for k, v in ported.items()
                      if not any(k.startswith(f"head.cls{lvl}_out.") for lvl in range(3))}
            state = _merge_into(state, branch, ported)
            log(f"ported {branch} from {yp} (cls head re-initialized, nc=1)")
        else:
            log(f"[fresh init] {branch} (no {yp})")

    ap = component_dir / "adaface_ir50_ms1mv2.ckpt"
    if ap.exists():
        ckpt = load_torch(ap)
        sd = ckpt.get("state_dict", ckpt)
        sd = {k.replace("module.", "").replace("model.", ""): v for k, v in sd.items()}
        ir = model.ada_face
        ported = porting.port_irnet(sd, num_layers=ir.num_layers, mode=ir.mode,
                                    skip_input_layer=True)
        state = _merge_into(state, "ada_face", ported)
        log(f"ported AdaFace {cfg.face.arch} from {ap} (input layer re-initialized)")
    else:
        log(f"[fresh init] ada_face (no {ap})")

    vp = component_dir / "vitpose-base-simple.pth"
    if vp.exists():
        state = _merge_into(state, "vit_pose", porting.port_vitpose(load_torch(vp)))
        log(f"ported ViTPose-B from {vp}")
    else:
        log(f"[fresh init] vit_pose (no {vp})")

    model.load_state_dict(state, strict=True)
    return model, model.state_dict()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--component-dir", default="component_models")
    ap.add_argument("--output", default="edited_components/combined_model.pt")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    _, state = build_variables(pathlib.Path(args.component_dir), device=args.device)
    out = pathlib.Path(args.output).absolute()
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, out)
    print(f"saved combined model state dict to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
