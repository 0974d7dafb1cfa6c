"""LAS/LAZ reader/writer (numpy container parsing + native LASzip codec).

The reference delegates LAS/LAZ I/O to laspy(+lazrs) (reference:
tree_learn/util/data_preparation.py:28-33, tree_learn/util/pipeline.py:349-384).
Neither is available in this environment, so we ship our own:

* Reader: LAS 1.0-1.4, all core point formats (0-10); decodes X/Y/Z with
  scale+offset, `classification`, and named extra-bytes dimensions (e.g.
  ``treeID``) declared through an Extra Bytes VLR.  Compressed (.laz, LASzip
  2.x chunked) point data is decoded by the native codec in native/laszip via
  io/laz.py.
* Writer: LAS 1.2, point format 3 (xyz + RGB) with a ``treeID`` uint32 extra
  dimension — the exact layout the reference writes; ``compress=True`` (or a
  ``.laz`` path) writes real LASzip-compressed points.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

# Point record length and position of fields for the core LAS point formats.
# Format: id -> (record_len, gps_time_offset_or_None, rgb_offset_or_None)
_POINT_FORMATS = {
    0: (20, None, None),
    1: (28, 20, None),
    2: (26, None, 20),
    3: (34, 20, 28),
    4: (57, 20, None),
    5: (63, 20, 28),
    6: (30, 22, None),
    7: (36, 22, 30),
    8: (38, 22, 30),
    9: (59, 22, None),
    10: (67, 22, 30),
}

# Extra-bytes VLR data_type ids -> numpy dtype (LAS 1.4 spec, table 24).
_EB_DTYPES = {
    1: np.dtype("<u1"), 2: np.dtype("<i1"), 3: np.dtype("<u2"), 4: np.dtype("<i2"),
    5: np.dtype("<u4"), 6: np.dtype("<i4"), 7: np.dtype("<u8"), 8: np.dtype("<i8"),
    9: np.dtype("<f4"), 10: np.dtype("<f8"),
}
_EB_TYPE_OF_DTYPE = {v: k for k, v in _EB_DTYPES.items()}


@dataclass
class LasData:
    """Decoded LAS contents."""
    xyz: np.ndarray                               # (N, 3) float64, scaled+offset applied
    classification: Optional[np.ndarray] = None   # (N,) uint8
    rgb: Optional[np.ndarray] = None              # (N, 3) uint16
    gps_time: Optional[np.ndarray] = None         # (N,) float64
    intensity: Optional[np.ndarray] = None        # (N,) uint16
    extra: Dict[str, np.ndarray] = field(default_factory=dict)  # named extra dims

    def __getattr__(self, name):
        extra = object.__getattribute__(self, "extra")
        if name in extra:
            return extra[name]
        raise AttributeError(name)

    def has_dim(self, name: str) -> bool:
        return name in self.extra or getattr(self, name, None) is not None


def _parse_extra_bytes_vlr(payload: bytes):
    """Parse an Extra Bytes VLR payload into [(name, dtype), ...]."""
    dims = []
    n = len(payload) // 192
    for i in range(n):
        rec = payload[i * 192:(i + 1) * 192]
        data_type = rec[2]
        name = rec[4:36].split(b"\x00", 1)[0].decode("ascii", errors="replace")
        if data_type in _EB_DTYPES:
            dims.append((name, _EB_DTYPES[data_type]))
        else:
            # deprecated array/undocumented types: skip but keep byte accounting
            options = rec[3]
            dims.append((name, np.dtype(("<u1", max(options, 1)))))
    return dims


def read_las(path: str) -> LasData:
    """Read a .las or .laz file (LAZ through the native LASzip codec in
    native/laszip, see io/laz.py)."""
    with open(path, "rb") as f:
        raw = f.read()

    if raw[:4] != b"LASF":
        raise ValueError(f"{path} is not a LAS file (bad signature)")

    ver_major, ver_minor = raw[24], raw[25]
    header_size = struct.unpack_from("<H", raw, 94)[0]
    offset_to_points = struct.unpack_from("<I", raw, 96)[0]
    n_vlrs = struct.unpack_from("<I", raw, 100)[0]
    point_format = raw[104]
    point_format &= 0x3F  # strip LAZ compressor bits if present
    point_len = struct.unpack_from("<H", raw, 105)[0]
    n_points = struct.unpack_from("<I", raw, 107)[0]
    scales = struct.unpack_from("<3d", raw, 131)
    offsets = struct.unpack_from("<3d", raw, 155)
    if ver_minor >= 4:
        n_points_64 = struct.unpack_from("<Q", raw, 247)[0]
        if n_points_64:
            n_points = n_points_64

    if point_format not in _POINT_FORMATS:
        raise ValueError(f"unsupported LAS point format {point_format}")
    base_len, gps_off, rgb_off = _POINT_FORMATS[point_format]

    # walk VLRs for extra-bytes descriptors and the LASzip record
    extra_dims = []
    laszip_payload = None
    pos = header_size
    for _ in range(n_vlrs):
        user_id = raw[pos + 2:pos + 18].split(b"\x00", 1)[0]
        record_id = struct.unpack_from("<H", raw, pos + 18)[0]
        rec_len = struct.unpack_from("<H", raw, pos + 20)[0]
        payload = raw[pos + 54:pos + 54 + rec_len]
        if user_id == b"LASF_Spec" and record_id == 4:
            extra_dims = _parse_extra_bytes_vlr(payload)
        elif record_id == 22204 and user_id.startswith(b"laszip"):
            laszip_payload = payload
        pos += 54 + rec_len

    if laszip_payload is not None:
        from .laz import decompress_points, parse_laszip_vlr

        chunk_size, items = parse_laszip_vlr(laszip_payload)
        item_len = sum(s for _, s, _ in items)
        if item_len != point_len:
            raise ValueError(f"LASzip item sizes ({item_len}) disagree with "
                             f"header point length ({point_len})")
        records = decompress_points(raw[offset_to_points:], offset_to_points,
                                    n_points, chunk_size, items)
    else:
        body = raw[offset_to_points:offset_to_points + n_points * point_len]
        records = np.frombuffer(body, dtype=np.uint8).reshape(n_points, point_len)

    def view(col_off, dtype, count=1):
        width = np.dtype(dtype).itemsize * count
        arr = records[:, col_off:col_off + width].copy()
        out = arr.view(dtype)
        return out.reshape(n_points, count) if count > 1 else out.reshape(n_points)

    ixyz = view(0, "<i4", 3).astype(np.float64)
    xyz = ixyz * np.asarray(scales) + np.asarray(offsets)
    intensity = view(12, "<u2")
    if point_format >= 6:
        classification = view(16, "<u1")
    else:
        classification = view(15, "<u1") & 0x1F  # low 5 bits in legacy formats

    rgb = view(rgb_off, "<u2", 3) if rgb_off is not None else None
    gps_time = view(gps_off, "<f8") if gps_off is not None else None

    extra = {}
    eb_pos = base_len
    for name, dtype in extra_dims:
        if eb_pos + dtype.itemsize > point_len:
            break
        if dtype.subdtype is None:
            extra[name] = view(eb_pos, dtype)
        eb_pos += dtype.itemsize

    return LasData(xyz=xyz, classification=classification, rgb=rgb,
                   gps_time=gps_time, intensity=intensity, extra=extra)


def write_las(
    path: str,
    xyz: np.ndarray,
    classification: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    extra: Optional[Dict[str, np.ndarray]] = None,
    scales=(0.001, 0.001, 0.001),
    offsets=(0.0, 0.0, 0.0),
    compress: Optional[bool] = None,
) -> None:
    """Write a LAS 1.2 point-format-3 file with optional uint/float extra dims.

    Layout parity with the reference's laspy writer
    (reference: tree_learn/util/pipeline.py:349-384).  ``compress`` selects
    LASzip point compression (default: inferred from a ``.laz`` path).
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    n = len(xyz)
    extra = dict(extra or {})
    scales = np.asarray(scales, dtype=np.float64)
    offsets = np.asarray(offsets, dtype=np.float64)
    if compress is None:
        compress = str(path).lower().endswith(".laz")

    eb_dims = []
    for name, arr in extra.items():
        arr = np.ascontiguousarray(arr)
        dtype = arr.dtype.newbyteorder("<")
        if dtype not in _EB_TYPE_OF_DTYPE:
            raise ValueError(f"unsupported extra-dim dtype {arr.dtype} for '{name}'")
        eb_dims.append((name, dtype, arr))

    base_len = 34
    point_len = base_len + sum(d.itemsize for _, d, _ in eb_dims)

    # --- VLR (extra bytes) ---
    vlr_blobs = b""
    n_vlrs = 0
    if eb_dims:
        payload = b""
        for name, dtype, _ in eb_dims:
            rec = bytearray(192)
            rec[2] = _EB_TYPE_OF_DTYPE[dtype]
            rec[4:4 + min(32, len(name))] = name.encode("ascii")[:32]
            payload += bytes(rec)
        vlr_header = struct.pack("<H16sHH32s", 0, b"LASF_Spec", 4, len(payload), b"Extra Bytes")
        vlr_blobs = vlr_header + payload
        n_vlrs = 1

    laz_items = None
    if compress:
        from .laz import build_laszip_vlr, items_for_point_format

        laz_items = items_for_point_format(3, point_len - base_len)
        laz_payload = build_laszip_vlr(laz_items)
        vlr_header = struct.pack("<H16sHH32s", 0, b"laszip encoded",
                                 22204, len(laz_payload),
                                 b"treelearn_tpu LASzip")
        vlr_blobs += vlr_header + laz_payload
        n_vlrs += 1

    header_size = 227
    offset_to_points = header_size + len(vlr_blobs)

    xyz_min = xyz.min(0) if n else np.zeros(3)
    xyz_max = xyz.max(0) if n else np.zeros(3)
    # int32-range check on the bounds (not per point: that's three more
    # full passes over a 240 MB array at 10M points)
    bounds = np.concatenate([(xyz_min - offsets) / scales,
                             (xyz_max - offsets) / scales])
    if np.any(np.abs(bounds) > np.iinfo(np.int32).max - 1):
        offsets = (xyz_min + xyz_max) / 2.0  # re-center so int32 fits
    cls_u8 = (np.asarray(classification, dtype=np.uint8)
              if classification is not None else None)
    rgb_u2 = np.asarray(rgb, dtype="<u2") if rgb is not None else None

    def fill_records(buf, s, e):
        """Fill ``buf[:e-s]`` with point records for rows [s, e)."""
        m = e - s
        rec = buf[:m]
        rec[:] = 0

        def put(col_off, arr):
            arr = np.ascontiguousarray(arr)
            width = arr.dtype.itemsize * (arr.shape[1] if arr.ndim > 1 else 1)
            rec[:, col_off:col_off + width] = arr.view(np.uint8).reshape(m, width)

        ixyz = np.empty((m, 3), dtype="<i4")
        for a in range(3):
            col = (xyz[s:e, a] - offsets[a]) * (1.0 / scales[a])
            np.rint(col, out=col)
            ixyz[:, a] = col
        put(0, ixyz)
        # intensity (12, u2) zeros; return byte (14) -> 1 return, first
        rec[:, 14] = 0b00001001
        if cls_u8 is not None:
            rec[:, 15] = cls_u8[s:e]
        # gps time at 20 stays zero
        if rgb_u2 is not None:
            put(28, rgb_u2[s:e])
        pos = base_len
        for name, dtype, arr in eb_dims:
            put(pos, arr[s:e].astype(dtype))
            pos += dtype.itemsize
        return rec

    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1   # version major
    header[25] = 2   # version minor
    header[26:26 + 13] = b"treelearn_tpu"
    header[58:58 + 13] = b"treelearn_tpu"
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, offset_to_points)
    struct.pack_into("<I", header, 100, n_vlrs)
    header[104] = 3 | (0x80 if compress else 0)  # point format (+LAZ bit)
    struct.pack_into("<H", header, 105, point_len)
    struct.pack_into("<I", header, 107, n)
    struct.pack_into("<5I", header, 111, n, 0, 0, 0, 0)
    struct.pack_into("<3d", header, 131, *scales)
    struct.pack_into("<3d", header, 155, *offsets)
    struct.pack_into("<6d", header, 179,
                     xyz_max[0], xyz_min[0], xyz_max[1], xyz_min[1], xyz_max[2], xyz_min[2])

    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(vlr_blobs)
        if compress:
            from .laz import compress_points

            # the codec consumes the whole record block at once
            records = fill_records(np.zeros((n, point_len), np.uint8), 0, n)
            f.write(compress_points(records, offset_to_points, laz_items))
        else:
            # chunked build+write through ONE reusable buffer: a full
            # records matrix is 340 MB at 10M points, and faulting those
            # fresh pages in cost more than the strided copies themselves
            # on the 1-core host (measured ~7 s); tofile streams each chunk
            # without a tobytes copy
            chunk = min(n, 2_000_000) or 1
            buf = np.zeros((chunk, point_len), np.uint8)
            for s in range(0, n, chunk):
                fill_records(buf, s, min(s + chunk, n)).tofile(f)
