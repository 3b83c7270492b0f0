"""Convert MS1MV2 MXNet RecordIO archives to identity image folders
(``prpe_tpu/cli/convert_ms1m.py``, an own copy: the same files and npz
archives).

    python -m prpe_tpu_torch.cli.convert_ms1m train.rec --output DIR [--limit N]
    python -m prpe_tpu_torch.cli.convert_ms1m lfw.bin --output lfw_pairs.npz

Dependency-free equivalent of the reference converter (reference:
convert.py:18-53, which requires mxnet): it parses the documented MXNet
RecordIO on-disk format directly,

  record  = magic(4B, 0xced7230a) | cflag+length(4B LE) | payload | pad-to-4B
  payload = IRHeader | jpeg bytes
  IRHeader = flag(u32) | label(f32 * (1 if flag==0 else flag)) | id(u64) | id2(u64)

and writes ``{identity}/{n}.jpg`` folders that
``data/faces.py::IdentityFolderDataset`` reads (JPEG: decoded through PIL).
The LFW-style verification ``.bin`` files (pickled (bins, issame)) become
``{name}_pairs.npz`` without bcolz (reference: convert.py:55-76), which
``cli/eval_verification.py`` reads.
"""

from __future__ import annotations

import argparse
import pathlib
import pickle
import struct
import sys

_MAGIC = 0xCED7230A


def iter_records(rec_path: pathlib.Path):
    """Yield raw payload bytes from a .rec file."""
    with open(rec_path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            magic, cflag_len = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise ValueError(f"bad magic {magic:#x} in {rec_path}")
            cflag = cflag_len >> 29
            length = cflag_len & ((1 << 29) - 1)
            payload = f.read(length)
            f.read((4 - length % 4) % 4)  # padding
            if cflag != 0:
                raise NotImplementedError("multi-part records not supported")
            yield payload


def parse_irheader(payload: bytes):
    flag, = struct.unpack_from("<I", payload, 0)
    n_label = 1 if flag == 0 else flag
    labels = struct.unpack_from(f"<{n_label}f", payload, 4)
    off = 4 + 4 * n_label
    return labels, payload[off + 16:]  # past id and id2 (u64 each)


def convert_rec(rec_path: pathlib.Path, out_dir: pathlib.Path, limit=None):
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = {}
    n = 0
    for payload in iter_records(rec_path):
        labels, img = parse_irheader(payload)
        if not img:  # index records at the head of the archive
            continue
        identity = str(int(labels[0]))
        d = out_dir / identity
        if identity not in counts:
            d.mkdir(exist_ok=True)
            counts[identity] = 0
        (d / f"{counts[identity]}.jpg").write_bytes(img)
        counts[identity] += 1
        n += 1
        if limit and n >= limit:
            break
    print(f"wrote {n} images / {len(counts)} identities to {out_dir}")


def convert_bin(bin_path: pathlib.Path, out_path: pathlib.Path):
    """Verification pairs: pickled (bins, issame) -> npz of the encoded
    images + labels (decoded at eval time)."""
    import numpy as np

    with open(bin_path, "rb") as f:
        bins, issame = pickle.load(f, encoding="bytes")
    np.savez(out_path, jpegs=np.array([bytes(b) for b in bins], dtype=object),
             issame=np.asarray(issame, bool))
    print(f"wrote {len(issame)} pairs to {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("input", help=".rec archive or verification .bin")
    ap.add_argument("--output", required=True)
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    src = pathlib.Path(args.input)
    if src.suffix == ".bin":
        convert_bin(src, pathlib.Path(args.output))
    else:
        convert_rec(src, pathlib.Path(args.output), args.limit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
