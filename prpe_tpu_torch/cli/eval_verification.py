"""Face-verification evaluation CLI over LFW-style pairs
(``prpe_tpu/cli/eval_verification.py``).

    python -m prpe_tpu_torch.cli.eval_verification pairs.npz [--device cpu]
        [--checkpoint PATH] [--arch ir_50] [--batch-size 64]

Embeds the pairs of a ``cli/convert_ms1m.py`` npz (``jpegs``: the encoded
images, 2 per pair; ``issame``) with an IR-Net on the card and prints
``eval/verification.py::verification_accuracy`` as one JSON line. Images
decode through ``data/image.py`` (PNG and BMP without PIL; JPEG through
PIL, or a ``RuntimeError`` naming the image where it is missing), at the
size they are stored (112 x 112), as RGB / 255, then (x - 0.5) / 0.5, then
BGR, as the JAX CLI does. The last batch is padded with zeros to the batch
size. ``--checkpoint`` is a state dict in ``train/checkpoint.py::
save_model``'s format (or a bare one); without it the weights are drawn
from seed 0.
"""

from __future__ import annotations

import argparse
import json
import sys


def decode(data: bytes, name: str = "<pair image>"):
    """Encoded face crop -> BGR (x / 255 - 0.5) / 0.5 fp32 HWC."""
    import numpy as np

    from prpe_tpu_torch.data.image import decode_image

    img = decode_image(bytes(data), name).astype(np.float32)
    x = (img / 255.0 - 0.5) / 0.5
    return x[..., ::-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("pairs", help="npz from convert_ms1m --output (jpegs, issame)")
    ap.add_argument("--checkpoint", default=None,
                    help="IR-Net state dict (train/checkpoint.py::save_model's format)")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--arch", default="ir_50",
                    help="IRNet variant (ir_18..ir_se_152); ir_18 for fast CPU smoke runs")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from prpe_tpu_torch.core.device import resolve_device
    from prpe_tpu_torch.eval.verification import verification_accuracy
    from prpe_tpu_torch.nn.common import build_on
    from prpe_tpu_torch.nn.irnet import build_irnet
    from prpe_tpu_torch.train.checkpoint import load_model

    device = resolve_device(args.device)
    data = np.load(args.pairs, allow_pickle=True)
    jpegs, issame = data["jpegs"], data["issame"]
    model = build_on(device, lambda: build_irnet(args.arch))
    if args.checkpoint:
        model.load_state_dict(load_model(args.checkpoint))
    model.eval()

    @torch.no_grad()
    def embed(batch):
        emb, _ = model(torch.from_numpy(np.ascontiguousarray(batch)).to(device))
        return emb.float().cpu().numpy()

    embs = []
    bs = args.batch_size
    for i in range(0, len(jpegs), bs):
        chunk = np.stack([decode(j, f"pair image {i + k}")
                          for k, j in enumerate(jpegs[i: i + bs])])
        if len(chunk) < bs:  # pad to the batch size
            pad = np.zeros((bs - len(chunk), *chunk.shape[1:]), chunk.dtype)
            embs.append(embed(np.concatenate([chunk, pad]))[: len(chunk)])
        else:
            embs.append(embed(chunk))
    embs = np.concatenate(embs)

    metrics = verification_accuracy(embs[0::2], embs[1::2], issame)
    print(json.dumps({k: float(v) for k, v in metrics.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
