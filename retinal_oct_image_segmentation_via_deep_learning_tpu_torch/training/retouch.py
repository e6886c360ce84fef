"""RETOUCH challenge volume loader (ITK MetaImage .mhd/.raw, no ITK
dependency; the JAX package's ``training/retouch.py``, numpy and zlib
only).

RETOUCH distributes one directory per case holding ``oct.mhd`` (+ raw
payload) with the OCT volume and ``reference.mhd`` with per-voxel fluid
labels (0 background, 1 IRF, 2 SRF, 3 PED).

MetaImage is a two-part format: a small ``key = value`` text header and a
binary payload (optionally zlib-compressed, possibly embedded in the same
file for ``.mha``). This parser handles both layouts.
"""

from __future__ import annotations

import os
import zlib
from typing import Iterator

import numpy as np

RETOUCH_NUM_CLASSES = 4  # bg + IRF + SRF + PED
CLASS_NAMES = ("background", "IRF", "SRF", "PED")

_MET_DTYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}


def parse_mhd(path: str) -> dict:
    """Parse a MetaImage header into a dict (values kept as strings except
    DimSize/ElementSpacing/Offset, which become numeric arrays)."""
    header: dict = {}
    payload_offset = None
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            if not line:
                break
            text = line.decode("latin-1").strip()
            if "=" not in text:
                continue
            key, _, value = text.partition("=")
            key, value = key.strip(), value.strip()
            header[key] = value
            if key == "ElementDataFile":
                if value.upper() == "LOCAL":
                    payload_offset = f.tell()
                break
    for key in ("DimSize", "ElementSpacing", "Offset"):
        if key in header:
            header[key] = np.array(
                [float(v) for v in header[key].split()]
            )
    header["_payload_offset"] = payload_offset
    return header


def load_mhd_volume(path: str) -> tuple[np.ndarray, np.ndarray]:
    """-> (volume (B, H, W), spacing (3,) mm as (x, y, z) per header).

    MetaImage stores DimSize as (X, Y, Z) = (width, height, n_bscans) with
    x fastest-varying, so the raw buffer reshapes to (Z, Y, X) = (B, H, W).
    """
    header = parse_mhd(path)
    dims = header["DimSize"].astype(int)
    dtype = _MET_DTYPES[header.get("ElementType", "MET_UCHAR")]
    compressed = header.get("CompressedData", "False").lower() == "true"

    data_file = header["ElementDataFile"]
    if data_file.upper() == "LOCAL":
        with open(path, "rb") as f:
            f.seek(header["_payload_offset"])
            raw = f.read()
    else:
        with open(os.path.join(os.path.dirname(path), data_file), "rb") as f:
            raw = f.read()
    if compressed:
        raw = zlib.decompress(raw)
    count = int(np.prod(dims))
    vol = np.frombuffer(raw, dtype=dtype, count=count)
    # (X, Y, Z) dims, x fastest -> C-order shape (Z, Y, X)
    vol = vol.reshape(dims[::-1])
    spacing = header.get("ElementSpacing", np.ones(len(dims)))
    return vol, spacing


def write_mhd_volume(path: str, vol: np.ndarray, spacing=None,
                     compressed: bool = False) -> None:
    """Write (B, H, W) as oct.mhd + .raw (round-trip/test utility)."""
    b, h, w = vol.shape
    met = {np.dtype(v): k for k, v in _MET_DTYPES.items()}[vol.dtype]
    raw_name = os.path.splitext(os.path.basename(path))[0] + ".raw"
    payload = vol.tobytes()
    if compressed:
        payload = zlib.compress(payload)
    spacing = np.ones(3) if spacing is None else np.asarray(spacing)
    with open(path, "w") as f:
        f.write("ObjectType = Image\nNDims = 3\nBinaryData = True\n")
        f.write("BinaryDataByteOrderMSB = False\n")
        f.write(f"CompressedData = {compressed}\n")
        f.write(f"DimSize = {w} {h} {b}\n")
        f.write(f"ElementSpacing = {' '.join(str(s) for s in spacing)}\n")
        f.write(f"ElementType = {met}\n")
        f.write(f"ElementDataFile = {raw_name}\n")
    with open(os.path.join(os.path.dirname(path), raw_name), "wb") as f:
        f.write(payload)


def load_case(case_dir: str) -> dict:
    """Load one RETOUCH case directory -> dict(images, labels?, spacing).

    images: (B, H, W) float32 normalized to [0, 1]; labels: (B, H, W) int32
    fluid classes if reference.mhd exists (training set), else None.
    """
    vol, spacing = load_mhd_volume(os.path.join(case_dir, "oct.mhd"))
    info = np.iinfo(vol.dtype) if vol.dtype.kind in "iu" else None
    images = vol.astype(np.float32)
    if info is not None:
        images /= float(info.max)
    labels = None
    ref_path = os.path.join(case_dir, "reference.mhd")
    if os.path.exists(ref_path):
        ref, _ = load_mhd_volume(ref_path)
        if ref.shape != vol.shape:
            raise ValueError(f"{ref_path}: labels {ref.shape} do not match "
                             f"the volume {vol.shape}")
        labels = ref.astype(np.int32)
    return {"images": images, "labels": labels, "spacing": spacing,
            "case": os.path.basename(os.path.normpath(case_dir))}


def iter_cases(root: str) -> Iterator[dict]:
    """Yield all cases under a RETOUCH split directory (sorted, e.g.
    ``RETOUCH-TrainingSet-Spectralis/TRAIN0XX/``)."""
    for name in sorted(os.listdir(root)):
        case_dir = os.path.join(root, name)
        if os.path.isdir(case_dir) and os.path.exists(
            os.path.join(case_dir, "oct.mhd")
        ):
            yield load_case(case_dir)
