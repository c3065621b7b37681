"""TIFF stack IO for microscopy movies, in numpy alone.

Port of ``moleculardiffusion_mivit_tpu/realdata/tiff.py``, which reads and
writes through PIL. This module parses the file itself: baseline TIFF,
little-endian, one grayscale sample a pixel, uncompressed, in strips, any
number of pages; 32-bit float, 16-bit or 8-bit unsigned samples. That
covers what PIL writes for such stacks. Anything else (compression, tiles,
big-endian, several samples a pixel, other sample types) raises rather than
being misread. ``read_tiff_stack`` returns ``(frames, H, W)`` float32.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

# tag numbers of the baseline TIFF fields this module reads or writes
WIDTH, HEIGHT, BITS, COMPRESSION, PHOTOMETRIC = 256, 257, 258, 259, 262
STRIP_OFFSETS, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 277, 278, 279
PLANAR, PREDICTOR, TILE_WIDTH, SAMPLE_FORMAT = 284, 317, 322, 339

# field type → (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1), 7: ("B", 1),
          8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 16: ("Q", 8)}
# (sample format, bits per sample) → numpy type; format 1 = unsigned, 3 = IEEE float
_SAMPLE_TYPES = {(1, 8): "<u1", (1, 16): "<u2", (3, 32): "<f4"}


def _read_ifd(data: bytes, offset: int) -> Tuple[Dict[int, tuple], int]:
    """The fields of the image file directory at ``offset`` (tag → values)
    and the offset of the next one (0 after the last)."""
    (count,) = struct.unpack_from("<H", data, offset)
    fields = {}
    for i in range(count):
        tag, kind, n, value = struct.unpack_from("<HHI4s", data, offset + 2 + 12 * i)
        if kind not in _TYPES:
            raise ValueError(f"TIFF field {tag} has unknown type {kind}")
        code, size = _TYPES[kind]
        where = value if n * size <= 4 else struct.unpack("<I", value)[0]
        if n * size > 4:
            where = data[where: where + n * size]
        fields[tag] = struct.unpack_from(f"<{n * len(code)}{code[0]}", where)
    (next_offset,) = struct.unpack_from("<I", data, offset + 2 + 12 * count)
    return fields, next_offset


def _page(data: bytes, fields: Dict[int, tuple], path: str) -> np.ndarray:
    def one(tag, default=None):
        if tag not in fields:
            if default is None:
                raise ValueError(f"{path}: TIFF page lacks field {tag}")
            return default
        return fields[tag][0]

    if one(COMPRESSION, 1) != 1:
        raise ValueError(f"{path}: compressed TIFF (compression {one(COMPRESSION)}) is not supported")
    if TILE_WIDTH in fields:
        raise ValueError(f"{path}: tiled TIFF is not supported")
    if one(SAMPLES, 1) != 1 or one(PLANAR, 1) != 1 or one(PREDICTOR, 1) != 1:
        raise ValueError(f"{path}: only one uncompressed sample a pixel is supported")
    bits = fields.get(BITS, (1,))
    kind = (one(SAMPLE_FORMAT, 1), bits[0])
    if len(set(bits)) != 1 or kind not in _SAMPLE_TYPES:
        raise ValueError(f"{path}: sample format {kind[0]} with {bits} bits is not supported")
    width, height = one(WIDTH), one(HEIGHT)
    dtype = np.dtype(_SAMPLE_TYPES[kind])
    strips = b"".join(data[o: o + c] for o, c in zip(fields[STRIP_OFFSETS], fields[STRIP_COUNTS]))
    if len(strips) < width * height * dtype.itemsize:
        raise ValueError(f"{path}: TIFF strips hold {len(strips)} bytes for a {height}x{width} page")
    return np.frombuffer(strips, dtype, count=width * height).reshape(height, width).astype(np.float32)


def read_tiff_stack(path: str) -> np.ndarray:
    """Read a (possibly multi-page) grayscale TIFF into (F, H, W) float32."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"II*\x00":
        raise ValueError(f"{path}: not a little-endian TIFF")
    (offset,) = struct.unpack_from("<I", data, 4)
    frames, seen = [], set()
    while offset:
        if offset in seen or offset + 2 > len(data):
            raise ValueError(f"{path}: broken chain of TIFF pages at offset {offset}")
        seen.add(offset)
        fields, offset = _read_ifd(data, offset)
        frames.append(_page(data, fields, path))
    if not frames:
        raise ValueError(f"no frames in {path}")
    return np.stack(frames)


def write_tiff_stack(path: str, stack: np.ndarray) -> None:
    """Write (F, H, W) to a multi-page 32-bit float TIFF: little-endian,
    uncompressed, one strip a page."""
    stack = np.ascontiguousarray(np.asarray(stack, dtype="<f4"))
    if stack.ndim != 3 or stack.shape[0] == 0:
        raise ValueError(f"write_tiff_stack: expected (F, H, W) with F >= 1, got {stack.shape}")
    _, height, width = stack.shape
    page_bytes = height * width * 4
    out = bytearray(b"II*\x00" + struct.pack("<I", 0))
    next_ifd_at = 4  # where the offset of the next page's directory goes
    for frame in stack:
        data_at = len(out)
        out += frame.tobytes()
        struct.pack_into("<I", out, next_ifd_at, len(out))
        # (tag, type, value): SHORT (3) or LONG (4), one value each, by tag
        fields = [(WIDTH, 4, width), (HEIGHT, 4, height), (BITS, 3, 32), (COMPRESSION, 3, 1),
                  (PHOTOMETRIC, 3, 1), (STRIP_OFFSETS, 4, data_at), (SAMPLES, 3, 1),
                  (ROWS_PER_STRIP, 4, height), (STRIP_COUNTS, 4, page_bytes), (SAMPLE_FORMAT, 3, 3)]
        out += struct.pack("<H", len(fields))
        for tag, kind, value in fields:
            packed = struct.pack("<H", value) + b"\x00\x00" if kind == 3 else struct.pack("<I", value)
            out += struct.pack("<HHI", tag, kind, 1) + packed
        next_ifd_at = len(out)
        out += struct.pack("<I", 0)  # 0 after the last page
    with open(path, "wb") as f:
        f.write(out)
