"""Download the pretrained component checkpoints
(``prpe_tpu/cli/download_models.py``, an own copy).

    python -m prpe_tpu_torch.cli.download_models [--output-dir component_models]

Mirror of the reference downloader (reference: scripts/download_models.py:1-53),
which pulls ``yolo11n.pt``, ``yolov11n-face.pt`` and
``adaface_ir50_ms1mv2.ckpt`` from the Hugging Face hub into
``component_models/`` (``cli/build_model.py`` converts them), plus the HF
ViTPose weights (reference: training/modify_models.py:397-401). Without
``huggingface_hub``, or without a network, it reports what is missing and
where to place it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

HF_REPO = "Jaspann/Person-Recognition-for-Pose-Estimation"
FILES = ["yolo11n.pt", "yolov11n-face.pt", "adaface_ir50_ms1mv2.ckpt"]
VITPOSE_REPO = "usyd-community/vitpose-base-simple"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output-dir", default="component_models")
    args = ap.parse_args(argv)

    out = pathlib.Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    missing = [f for f in FILES if not (out / f).exists()]
    if not missing:
        print(f"all component models present in {out}")
        return 0

    try:
        from huggingface_hub import hf_hub_download  # type: ignore
    except ImportError:
        hf_hub_download = None

    if hf_hub_download is None:
        print("huggingface_hub unavailable; place these files manually:")
        for f in missing:
            print(f"  {out / f}   (from https://huggingface.co/{HF_REPO})")
        print(f"  + ViTPose weights from https://huggingface.co/{VITPOSE_REPO}")
        return 1

    for f in missing:
        try:
            path = hf_hub_download(repo_id=HF_REPO, filename=f, local_dir=str(out))
            print(f"downloaded {path}")
        except Exception as e:  # noqa: BLE001 - no network
            print(f"could not download {f}: {e}")
            print(f"place it manually at {out / f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
