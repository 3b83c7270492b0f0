"""Image IO and geometric transforms on the host (``prpe_tpu/data/image.py``).

Numpy HWC uint8 arrays in and out. ``load_image`` decodes PNG (8-bit grey,
grey + alpha, RGB, RGBA and palette; every filter type; no interlace) and
uncompressed 24- and 32-bit BMP with numpy and zlib, so a host without PIL
reads the datasets ``tools/make_dataset.py`` writes; any other format (JPEG)
goes through PIL where it is installed and raises a ``RuntimeError`` naming
the file where it is not. ``save_png`` writes what ``decode_png`` reads;
``jpeg_roundtrip`` gives an image the losses of a baseline JPEG without a
JPEG codec.
``resize_image`` is torch's antialiased bilinear resize rounded back to
uint8, within one grey level of PIL's ``BILINEAR``; the dataset readers
resize with ``native.resize_bilinear_u8`` instead, since their forked
workers must not run torch.
"""

from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

try:
    from PIL import Image

    _HAVE_PIL = True
except Exception:  # pragma: no cover - PIL is optional
    _HAVE_PIL = False

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel (8-bit depth)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter_average(row, prior, bpp: int) -> None:
    r, p = row, prior
    for i in range(len(r)):
        left = r[i - bpp] if i >= bpp else 0
        r[i] = (r[i] + ((left + p[i]) >> 1)) & 255


def _unfilter_paeth(row, prior, bpp: int) -> None:
    r, p = row, prior
    for i in range(len(r)):
        a = r[i - bpp] if i >= bpp else 0
        b = p[i]
        c = p[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        r[i] = (r[i] + pred) & 255


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An 8-bit, non-interlaced PNG -> RGB uint8 HWC, as PIL's
    ``convert("RGB")`` gives it (alpha dropped, grey replicated, palette
    looked up)."""
    if not data.startswith(PNG_MAGIC):
        raise RuntimeError(f"{name}: not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise RuntimeError(f"{name}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        raise RuntimeError(f"{name}: PNG of bit depth {depth}, colour type {color}, interlace "
                           f"{interlace} is not supported (8-bit, non-interlaced only)")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise RuntimeError(f"{name}: truncated PNG data")
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    ftype, x = rows[:, 0], rows[:, 1:].copy()
    if (ftype > 4).any():
        raise RuntimeError(f"{name}: unknown PNG filter type {int(ftype.max())}")
    # None and Sub rows do not read the row above: all at once
    sub = ftype == 1
    if sub.any():
        x[sub] = np.cumsum(x[sub].reshape(-1, w, bpp), axis=1, dtype=np.uint8).reshape(-1, stride)
    # Up, Average and Paeth rows read the finished row above, in order
    zero = np.zeros(stride, np.uint8)
    for y in np.flatnonzero(ftype >= 2):
        prior = x[y - 1] if y else zero
        if ftype[y] == 2:
            x[y] += prior
        else:
            row = x[y].tolist()
            (_unfilter_average if ftype[y] == 3 else _unfilter_paeth)(row, prior.tolist(), bpp)
            x[y] = row
    px = x.reshape(h, w, bpp)
    if color == 2:
        return px
    if color == 6:
        return np.ascontiguousarray(px[..., :3])
    if color == 3:
        if palette is None:
            raise RuntimeError(f"{name}: palette PNG without PLTE")
        lut = np.zeros((256, 3), np.uint8)
        lut[: len(palette)] = palette[:256]
        return lut[px[..., 0]]
    return np.repeat(px[..., :1], 3, axis=2)  # grey, grey + alpha


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 HW (grey) or HWC with 1, 3 or 4 channels -> PNG bytes, every
    row Sub-filtered (``decode_png`` undoes it in one pass)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    x = np.ascontiguousarray(img).reshape(h, w * c)
    f = x.copy()
    f[:, c:] -= x[:, :-c]  # uint8 wraps modulo 256, as the filter does
    raw = np.concatenate([np.ones((h, 1), np.uint8), f], axis=1).tobytes()
    return (PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, level)) + _chunk(b"IEND", b""))


def save_png(path, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level))


# libjpeg's base quantisation tables (ITU-T T.81 Annex K), row-major 8x8
_JPEG_LUMA = np.array(
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57,
     69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64,
     81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.float64).reshape(8, 8)
_JPEG_CHROMA = np.array(
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
     99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.float64).reshape(8, 8)


def _jpeg_plane(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """One plane through 8x8 DCT blocks quantised by ``quant`` and back."""
    from scipy.fft import dctn, idctn

    h, w = plane.shape
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    x = np.pad(plane, ((0, hp - h), (0, wp - w)), mode="edge") - 128.0
    blocks = x.reshape(hp // 8, 8, wp // 8, 8).transpose(0, 2, 1, 3)
    coef = np.round(dctn(blocks, axes=(2, 3), norm="ortho") / quant) * quant
    y = idctn(coef, axes=(2, 3), norm="ortho").transpose(0, 2, 1, 3).reshape(hp, wp)
    return np.clip(np.round(y + 128.0), 0, 255)[:h, :w]


def _upsample2(c: np.ndarray) -> np.ndarray:
    """libjpeg's "fancy" 2x upsampling on both axes: each output sample is
    3/4 of its own input sample and 1/4 of the next one outwards."""
    for axis in (0, 1):
        p = np.pad(c, [(1, 1) if a == axis else (0, 0) for a in range(2)], mode="edge")
        mid = np.take(p, range(1, p.shape[axis] - 1), axis=axis)
        lo = 0.75 * mid + 0.25 * np.take(p, range(0, p.shape[axis] - 2), axis=axis)
        hi = 0.75 * mid + 0.25 * np.take(p, range(2, p.shape[axis]), axis=axis)
        shape = list(mid.shape)
        shape[axis] *= 2
        c = np.stack([lo, hi], axis=axis + 1).reshape(shape)
    return c


def jpeg_roundtrip(img: np.ndarray, quality: int = 92) -> np.ndarray:
    """uint8 RGB HWC -> the pixels a baseline JPEG of ``quality`` decodes
    to: JFIF YCbCr, 2x2 chroma subsampling, 8x8 DCT quantised by the
    libjpeg tables at that quality, libjpeg's fancy upsampling back. A numpy
    model of what PIL's ``save(..., quality=q)`` then ``open`` give (within
    about 1.2 grey levels on average of PIL's pixels for the synthetic pose
    scenes, where the lossless image differs from them by about 11), for a
    host without a JPEG codec."""
    x = np.asarray(img, np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = np.round(0.299 * r + 0.587 * g + 0.114 * b)
    cb = np.round(-0.168736 * r - 0.331264 * g + 0.5 * b + 128.0)
    cr = np.round(0.5 * r - 0.418688 * g - 0.081312 * b + 128.0)
    scale = 5000.0 / quality if quality < 50 else 200.0 - 2.0 * quality
    luma, chroma = (np.clip(np.floor((t * scale + 50) / 100), 1, 255)
                    for t in (_JPEG_LUMA, _JPEG_CHROMA))
    h, w = y.shape

    def chroma_plane(c):
        c = np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge")
        c = c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))
        return _upsample2(_jpeg_plane(c, chroma))[:h, :w] - 128.0

    y = _jpeg_plane(y, luma)
    cb, cr = chroma_plane(cb), chroma_plane(cr)
    rgb = np.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr, y + 1.772 * cb], -1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An uncompressed (BI_RGB) 24- or 32-bit BMP -> RGB uint8 HWC."""
    if not data.startswith(b"BM") or len(data) < 54:
        raise RuntimeError(f"{name}: not a BMP file")
    offset, = struct.unpack("<I", data[10:14])
    header_size, = struct.unpack("<I", data[14:18])
    if header_size < 40:
        raise RuntimeError(f"{name}: BMP core header is not supported")
    w, h, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    if bits not in (24, 32) or compression != 0:
        raise RuntimeError(f"{name}: BMP of {bits} bits, compression {compression} is not "
                           "supported (uncompressed 24- and 32-bit only)")
    bpp = bits // 8
    stride = (w * bpp + 3) // 4 * 4
    rows = np.frombuffer(data, np.uint8, count=stride * abs(h), offset=offset)
    px = rows.reshape(abs(h), stride)[:, : w * bpp].reshape(abs(h), w, bpp)[..., 2::-1]
    return np.ascontiguousarray(px if h < 0 else px[::-1])  # positive height: bottom-up


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Encoded image bytes -> RGB uint8 HWC: PNG and BMP here, anything else
    through PIL (which a host may lack: then a ``RuntimeError`` naming
    ``name``)."""
    for magic, decode in ((PNG_MAGIC, decode_png), (b"BM", decode_bmp)):
        if data.startswith(magic):
            try:
                return decode(data, name)
            except (ValueError, struct.error, zlib.error) as e:  # a damaged file
                raise RuntimeError(f"{name}: {e}") from e
    if not _HAVE_PIL:
        raise RuntimeError(f"{name}: only PNG and BMP decode without PIL, and PIL is not "
                           "installed")
    import io

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def load_image(path) -> np.ndarray:
    """Load an RGB uint8 HWC image file (``decode_image``)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), str(path))


def resize_image(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a uint8 HWC image to ``hw`` (H, W), antialiased
    when it shrinks, as PIL's ``BILINEAR``."""
    if img.shape[:2] == tuple(hw):
        return img
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def letterbox(img: np.ndarray, size: int, pad_value: int = 0
              ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Longest side to ``size``, then centre-pad to a square. Returns
    (image, scale, (pad_top, pad_left)) so annotations can be mapped."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_image(img, (nh, nw))
    out = np.full((size, size, img.shape[2]), pad_value, img.dtype)
    top = (size - nh) // 2
    left = (size - nw) // 2
    out[top: top + nh, left: left + nw] = resized
    return out, scale, (top, left)


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(img: np.ndarray) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
