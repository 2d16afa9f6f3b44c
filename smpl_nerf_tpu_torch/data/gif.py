"""Animated GIF89a writing with the standard library and numpy.

The JAX package writes its GIFs with `imageio.mimsave(path, frames, fps=10)`;
the port keeps to torch + numpy + the standard library, so this module writes
the same kind of file by hand: 10 frames per second (a delay of 10
centiseconds, which readers report as a 100 ms duration), looping forever (a
NETSCAPE2.0 block with loop count 0), every frame full-size with no local
colour table.

Colours go through one fixed global palette of 6 x 7 x 6 levels (red, green,
blue; 252 entries, padded to 256), each channel mapped to its nearest level:
levels 0, 51, ..., 255 for red and blue and 0, 42, 85, 128, 170, 212, 255 for
green. The largest per-channel error is therefore 25 for red and blue and 21
for green (`MAX_CHANNEL_ERROR`). No dithering.

Pixel indices are LZW-compressed as the GIF specification asks: 8-bit
minimum code size, a clear code first, code widths growing from 9 to 12 bits
as the table fills, a clear code and a fresh table when it is full, the end
code last, the bits packed least significant first into sub-blocks of at
most 255 bytes.
"""
from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

LEVELS = (6, 7, 6)                      # red, green, blue
MAX_CHANNEL_ERROR = (25, 21, 25)
FPS = 10
_MIN_CODE_SIZE = 8
_MAX_CODES = 4096


def _levels(n: int) -> np.ndarray:
    return np.rint(np.arange(n) * 255.0 / (n - 1)).astype(np.int64)


def palette() -> np.ndarray:
    """uint8 [256, 3] RGB: entry (r * 7 + g) * 6 + b holds the levels, then zeros."""
    r, g, b = (_levels(n) for n in LEVELS)
    grid = np.stack(np.meshgrid(r, g, b, indexing="ij"), -1).reshape(-1, 3)
    out = np.zeros((256, 3), np.uint8)
    out[:len(grid)] = grid
    return out


def _nearest_level(n: int) -> np.ndarray:
    """[256] index of the level nearest to each 8-bit value."""
    return np.abs(np.arange(256)[:, None] - _levels(n)[None, :]).argmin(-1)


def quantize(frame_rgb: np.ndarray) -> np.ndarray:
    """uint8 [h, w, 3] RGB -> palette indices [h, w] (uint8)."""
    r, g, b = (_nearest_level(n)[frame_rgb[..., c]] for c, n in enumerate(LEVELS))
    return ((r * LEVELS[1] + g) * LEVELS[2] + b).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int = _MIN_CODE_SIZE) -> bytes:
    """The LZW code stream of one frame's palette indices, packed into bytes."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = n_bits = 0

    def emit(code: int, width: int) -> None:
        nonlocal acc, n_bits
        acc |= code << n_bits
        n_bits += width
        while n_bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_bits -= 8

    def fresh():
        return {bytes([i]): i for i in range(clear)}, end + 1, min_code_size + 1

    table, next_code, width = fresh()
    emit(clear, width)
    word = indices[:1]
    for i in range(1, len(indices)):
        grown = word + indices[i:i + 1]
        if grown in table:
            word = grown
            continue
        emit(table[word], width)
        table[grown] = next_code
        next_code += 1
        if next_code == _MAX_CODES:
            # the table is full: start afresh (the decoder reads the clear
            # code at the width it has reached, 12 bits)
            emit(clear, width)
            table, next_code, width = fresh()
        elif next_code > (1 << width) and width < 12:
            # the decoder adds each entry one code later than the encoder, so
            # it widens when the table holds 2^width + 1 entries here
            width += 1
        word = indices[i:i + 1]
    if word:
        emit(table[word], width)
    emit(end, width)
    if n_bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return blocks + b"\x00"


def write_gif(path: str, frames_rgb: Sequence[np.ndarray], fps: int = FPS) -> None:
    """Write uint8 [h, w, 3] RGB frames as a looping GIF89a at `fps` frames per second."""
    frames = [np.asarray(f) for f in frames_rgb]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.dtype != np.uint8 or f.shape != (h, w, 3):
            raise ValueError(f"write_gif takes uint8 [{h}, {w}, 3] frames, got {f.dtype} "
                             f"{f.shape}")
    delay = int(round(100 / fps))
    parts = [b"GIF89a",
             # logical screen: global colour table of 2^(7+1) entries, 8-bit colour
             struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette().tobytes(),
             # NETSCAPE2.0 application block: loop forever
             b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for f in frames:
        parts.append(b"\x21\xF9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        parts.append(b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        parts.append(bytes([_MIN_CODE_SIZE])
                     + _sub_blocks(lzw_encode(quantize(f).tobytes())))
    parts.append(b"\x3B")
    with open(path, "wb") as fh:
        fh.write(b"".join(parts))
