"""8-bit PNG reading and writing with the standard library (zlib, struct) and numpy.

The JAX package reads dataset images with `cv2.imread` (data/datasets.py
`_read_images`); the port keeps to torch + numpy + the standard library, so
this module takes cv2's place with the same contract: `read_png` returns
uint8 [h, w, 3] in **BGR** channel order with any alpha channel dropped (grey
images are replicated over the three channels), and `write_png` takes a BGR
image and writes an 8-bit RGB PNG, as `cv2.imwrite` does.

Reads non-interlaced 8-bit grey, grey+alpha, RGB and RGBA files with all
five scanline filters. Palette, 16-bit and interlaced files are refused.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel
FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        pos += 12 + length


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left a, up b, upper-left c (int16 arrays)."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Scanlines [h, stride] from filtered data (one filter byte per line)."""
    lines = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind = int(lines[y, 0])
        cur = lines[y, 1:]
        if kind == FILTER_NONE:
            row = cur.copy()
        elif kind == FILTER_SUB:
            # each byte adds the byte bpp to its left: a running sum per channel, mod 256
            row = np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == FILTER_UP:
            row = cur + prev
        elif kind in (FILTER_AVERAGE, FILTER_PAETH):
            # the prediction needs the reconstructed left byte: sequential along the line
            row_b = bytearray(stride)
            cur_b, prev_b = cur.tobytes(), prev.tobytes()
            for i in range(stride):
                left = row_b[i - bpp] if i >= bpp else 0
                up = prev_b[i]
                if kind == FILTER_AVERAGE:
                    pred = (left + up) >> 1
                else:
                    corner = prev_b[i - bpp] if i >= bpp else 0
                    p = left + up - corner
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - corner)
                    pred = left if pa <= pb and pa <= pc else (up if pb <= pc else corner)
                row_b[i] = (cur_b[i] + pred) & 0xFF
            row = np.frombuffer(bytes(row_b), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = row
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """uint8 [h, w, 3] in BGR order, alpha dropped (what `cv2.imread(path)` returns)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only non-interlaced 8-bit grey/RGB(A) PNGs are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    bpp = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp).reshape(h, w, bpp)
    if bpp <= 2:                               # grey (+ alpha): replicate the grey channel
        return np.repeat(pixels[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pixels[..., 2::-1])   # RGB(A) -> BGR


def _filter(rows: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (uint8 [h, stride]) for one filter type on every line."""
    cur = rows.astype(np.int16)
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    corner = np.zeros_like(cur)
    corner[1:, bpp:] = cur[:-1, :-bpp]
    pred = {FILTER_NONE: 0, FILTER_SUB: left, FILTER_UP: up,
            FILTER_AVERAGE: (left + up) >> 1,
            FILTER_PAETH: _paeth(left, up, corner)}[kind]
    return ((cur - pred) & 0xFF).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image_bgr: np.ndarray, filter_type: int = FILTER_UP) -> None:
    """Write uint8 [h, w, 3] BGR as an 8-bit RGB PNG (what `cv2.imwrite` writes).

    Every scanline uses `filter_type` (0 none, 1 sub, 2 up, 3 average, 4 Paeth).
    """
    image = np.asarray(image_bgr)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 [h, w, 3], got {image.dtype} {image.shape}")
    if filter_type not in range(5):
        raise ValueError(f"unknown PNG filter type {filter_type}")
    h, w, _ = image.shape
    rows = _filter(image[..., ::-1].reshape(h, w * 3), filter_type, 3)
    lines = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + _chunk(b"IHDR", header)
                 + _chunk(b"IDAT", zlib.compress(lines.tobytes(), 6)) + _chunk(b"IEND", b""))
