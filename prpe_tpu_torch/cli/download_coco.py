"""Download and prepare COCO 2017 for the person-detection and pose tasks
(``prpe_tpu/cli/download_coco.py``, an own copy).

    python -m prpe_tpu_torch.cli.download_coco [--output-dir DIR]
        [--splits val train] [--skip-images]

Mirror of the reference's dataset acquisition
(reference: training/download_coco_direct.py:14-143): fetch the images and
annotations, extract them, and filter the instance annotations down to the
person category (``person_instances_{split}2017.json``). A file already in
place is not fetched again; where the network is not reachable the CLI says
so and where to place the files, and exits 1. ``cli/convert_coco.py`` turns
the annotations into YOLO-txt labels.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import urllib.request
import zipfile

URLS = {
    "train_images": "http://images.cocodataset.org/zips/train2017.zip",
    "val_images": "http://images.cocodataset.org/zips/val2017.zip",
    "annotations": "http://images.cocodataset.org/annotations/annotations_trainval2017.zip",
}


def download(url: str, dest: pathlib.Path):
    if dest.exists():
        print(f"exists: {dest}")
        return dest
    print(f"downloading {url} -> {dest}")
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(".part")
    urllib.request.urlretrieve(url, tmp)
    tmp.rename(dest)
    return dest


def extract(zip_path: pathlib.Path, out_dir: pathlib.Path):
    print(f"extracting {zip_path}")
    with zipfile.ZipFile(zip_path) as z:
        z.extractall(out_dir)


def filter_person_instances(ann_file: pathlib.Path, out_file: pathlib.Path):
    """Keep only person-category annotations and the images they are on
    (reference: training/download_coco_direct.py person filtering)."""
    with open(ann_file) as f:
        coco = json.load(f)
    person_ids = {c["id"] for c in coco["categories"] if c["name"] == "person"}
    anns = [a for a in coco["annotations"] if a["category_id"] in person_ids]
    img_ids = {a["image_id"] for a in anns}
    images = [im for im in coco["images"] if im["id"] in img_ids]
    out = {
        "info": coco.get("info", {}),
        "licenses": coco.get("licenses", []),
        "categories": [c for c in coco["categories"] if c["id"] in person_ids],
        "images": images,
        "annotations": anns,
    }
    out_file.write_text(json.dumps(out))
    print(f"wrote {out_file} ({len(images)} images, {len(anns)} annotations)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--output-dir", default="dataset_folders/coco")
    ap.add_argument("--splits", nargs="*", default=["val"], choices=["train", "val"])
    ap.add_argument("--skip-images", action="store_true")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.output_dir)
    root.mkdir(parents=True, exist_ok=True)
    try:
        ann_zip = download(URLS["annotations"], root / "annotations_trainval2017.zip")
        extract(ann_zip, root)
        for split in args.splits:
            if not args.skip_images:
                img_zip = download(URLS[f"{split}_images"], root / f"{split}2017.zip")
                extract(img_zip, root / "images_tmp")
                src = root / "images_tmp" / f"{split}2017"
                dst = root / "images" / split
                dst.parent.mkdir(parents=True, exist_ok=True)
                if not dst.exists():
                    src.rename(dst)
            filter_person_instances(
                root / "annotations" / f"instances_{split}2017.json",
                root / "annotations" / f"person_instances_{split}2017.json")
    except Exception as e:  # noqa: BLE001 - no network, a damaged archive
        print(f"download failed ({e}); in air-gapped environments place files "
              f"manually under {root}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
