"""Convert COCO instance annotations to YOLO-txt labels
(``prpe_tpu/cli/convert_coco.py``, an own copy: the same files byte for
byte).

    python -m prpe_tpu_torch.cli.convert_coco instances.json --output-dir DIR
        [--category person|all]

Dependency-free equivalent of the reference's ultralytics-based converter
(reference: convert_coco.py:1-6): for each image with a kept annotation,
``{output-dir}/{stem}.txt`` rows ``cls cx cy w h`` normalised to [0, 1].
Crowd annotations are skipped; classes are renumbered from 0 in category
id order.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from collections import defaultdict


def convert(ann_file: pathlib.Path, out_dir: pathlib.Path, category_filter: str = "person"):
    with open(ann_file) as f:
        coco = json.load(f)
    keep_ids = {
        c["id"] for c in coco["categories"]
        if category_filter in ("", "all") or c["name"] == category_filter
    }
    id_remap = {cid: i for i, cid in enumerate(sorted(keep_ids))}
    images = {im["id"]: im for im in coco["images"]}
    rows = defaultdict(list)
    for a in coco["annotations"]:
        if a["category_id"] not in keep_ids or a.get("iscrowd", 0):
            continue
        im = images[a["image_id"]]
        w, h = im["width"], im["height"]
        bx, by, bw, bh = a["bbox"]
        cx, cy = (bx + bw / 2) / w, (by + bh / 2) / h
        rows[a["image_id"]].append(
            f"{id_remap[a['category_id']]} {cx:.6f} {cy:.6f} {bw / w:.6f} {bh / h:.6f}")
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for img_id, lines in rows.items():
        stem = pathlib.Path(images[img_id]["file_name"]).stem
        (out_dir / f"{stem}.txt").write_text("\n".join(lines) + "\n")
        n += 1
    print(f"wrote {n} label files to {out_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("annotations", help="COCO instances json")
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--category", default="person")
    args = ap.parse_args(argv)
    convert(pathlib.Path(args.annotations), pathlib.Path(args.output_dir), args.category)
    return 0


if __name__ == "__main__":
    sys.exit(main())
