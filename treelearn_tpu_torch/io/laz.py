"""LAZ (LASzip) support: ctypes binding to the native codec in
native/laszip/laszip_tl.cpp plus the LASzip VLR plumbing.

Replaces the reference's laspy+lazrs dependency for compressed I/O
(reference tree_learn/util/data_preparation.py:28-33, util/pipeline.py:349-384).
The shared library is built on demand with g++ (cached next to the source).
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import struct
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

# LASzip item types
ITEM_BYTE = 0
ITEM_POINT10 = 6
ITEM_GPSTIME11 = 7
ITEM_RGB12 = 8

LASZIP_USER_ID = b"laszip encoded"
LASZIP_RECORD_ID = 22204
DEFAULT_CHUNK_SIZE = 50000

_lib = None
_lib_lock = threading.Lock()


def _native_dir() -> str:
    return osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
                    "native", "laszip")


def _build_library(src: str, out: str) -> None:
    # portable flags only: the cached .so can travel with the image to a
    # different microarchitecture (-march=native could SIGILL there)
    cmd = ["g++", "-O3", "-mtune=native", "-funroll-loops", "-Wall",
           "-shared", "-fPIC", "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building LASzip codec failed:\n{proc.stderr}")


def get_library():
    """Load (building if needed) the native LASzip codec."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        d = _native_dir()
        src = osp.join(d, "laszip_tl.cpp")
        so = osp.join(d, "liblaszip_tl.so")
        if not osp.exists(src):
            raise RuntimeError(f"LASzip codec source not found at {src}")
        if (not osp.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            _build_library(src, so)
        lib = ctypes.CDLL(so)
        lib.tl_laz_decompress.restype = ctypes.c_int
        lib.tl_laz_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.tl_laz_compress.restype = ctypes.c_int
        lib.tl_laz_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_uint32, ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.tl_laz_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# LASzip VLR payload
# ---------------------------------------------------------------------------

def parse_laszip_vlr(payload: bytes):
    """Parse a LASzip VLR payload -> (chunk_size, [(type, size, version)])."""
    (compressor, coder, ver_major, ver_minor, ver_rev, options,
     chunk_size) = struct.unpack_from("<HHBBHII", payload, 0)
    if compressor not in (2, 3):  # POINTWISE_CHUNKED / LAYERED_CHUNKED
        raise ValueError(f"unsupported LASzip compressor {compressor}")
    if compressor == 3:
        raise ValueError("LASzip 1.4 layered compression (compressor 3) "
                         "not supported; points use v2 items")
    if coder != 0:
        raise ValueError(f"unsupported LASzip coder {coder}")
    num_items = struct.unpack_from("<H", payload, 32)[0]
    items = []
    for i in range(num_items):
        t, s, v = struct.unpack_from("<HHH", payload, 34 + 6 * i)
        items.append((t, s, v))
    return chunk_size, items


def build_laszip_vlr(items: List[Tuple[int, int]],
                     chunk_size: int = DEFAULT_CHUNK_SIZE) -> bytes:
    """Build a LASzip VLR payload for v2 items [(type, size), ...]."""
    payload = struct.pack("<HHBBHII", 2, 0, 2, 2, 0, 0, chunk_size)
    payload += struct.pack("<qq", -1, -1)  # no special EVLRs
    payload += struct.pack("<H", len(items))
    for t, s in items:
        payload += struct.pack("<HHH", t, s, 2)
    return payload


def items_for_point_format(point_format: int, extra_bytes: int):
    """The LASzip item schema of a legacy LAS point format (0-3)."""
    if point_format not in (0, 1, 2, 3):
        raise ValueError(f"LAZ writing supports point formats 0-3, "
                         f"got {point_format}")
    items = [(ITEM_POINT10, 20)]
    if point_format in (1, 3):
        items.append((ITEM_GPSTIME11, 8))
    if point_format in (2, 3):
        items.append((ITEM_RGB12, 6))
    if extra_bytes:
        items.append((ITEM_BYTE, extra_bytes))
    return items


# ---------------------------------------------------------------------------
# compress / decompress
# ---------------------------------------------------------------------------

def _item_arrays(items):
    types = (ctypes.c_uint16 * len(items))(*[t for t, s, *_ in items])
    sizes = (ctypes.c_uint16 * len(items))(*[s for t, s, *_ in items])
    return types, sizes


def decompress_points(data: bytes, base_offset: int, num_points: int,
                      chunk_size: int, items) -> np.ndarray:
    """Decompress a LAZ point-data block -> (num_points, point_size) uint8.

    ``items`` are (type, size[, version]) tuples from the LASzip VLR; only
    version-2 items are supported (LASzip 2.x, i.e. LAS 1.0-1.3 content).
    """
    for it in items:
        if len(it) > 2 and it[2] not in (0, 2):
            raise ValueError(f"unsupported LASzip item version {it[2]} "
                             f"for item type {it[0]}")
    lib = get_library()
    point_size = sum(s for _, s, *_ in items)
    out = np.empty(int(num_points) * point_size, np.uint8)
    err = ctypes.create_string_buffer(512)
    types, sizes = _item_arrays(items)
    rc = lib.tl_laz_decompress(
        data, len(data), base_offset, int(num_points), int(chunk_size),
        types, sizes, len(items),
        out.ctypes.data_as(ctypes.c_void_p), err, len(err))
    if rc != 0:
        raise ValueError(f"LAZ decompression failed: {err.value.decode()}")
    return out.reshape(int(num_points), point_size)


def compress_points(records: np.ndarray, base_offset: int, items,
                    chunk_size: int = DEFAULT_CHUNK_SIZE) -> bytes:
    """Compress raw point records -> a LAZ point-data block (chunked)."""
    lib = get_library()
    records = np.ascontiguousarray(records, np.uint8)
    num_points = records.shape[0]
    err = ctypes.create_string_buffer(512)
    types, sizes = _item_arrays(items)
    dst = ctypes.POINTER(ctypes.c_uint8)()
    dst_len = ctypes.c_uint64()
    rc = lib.tl_laz_compress(
        records.tobytes(), num_points, chunk_size, types, sizes, len(items),
        base_offset, ctypes.byref(dst), ctypes.byref(dst_len), err, len(err))
    if rc != 0:
        raise ValueError(f"LAZ compression failed: {err.value.decode()}")
    try:
        return ctypes.string_at(dst, dst_len.value)
    finally:
        lib.tl_laz_free(dst)
