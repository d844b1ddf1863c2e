"""Minimal pure-Python NRRD reader/writer (numpy only).

The port's copy of ``vqvae3d_tpu/data/nrrd_io.py``: the subset of NRRD the
CT pipeline needs, byte-compatible with it in both directions.

  * text header (NRRD0001..5), fields: type, dimension, sizes, encoding
    (raw | gzip), endian, spacings, space directions, space origin;
  * Fortran index order (first axis fastest), pynrrd's default, so a
    (512, 512, D) CT scan reads as shape (512, 512, D);
  * ``read_header`` for metadata-only scans (dataset filtering by size and
    spacing).
"""
from __future__ import annotations

import gzip
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

_MAGIC = "NRRD"

_TYPE_MAP = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "short int": np.int16, "signed short": np.int16,
    "signed short int": np.int16, "int16": np.int16, "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16,
    "unsigned short int": np.uint16, "uint16": np.uint16, "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "long long int": np.int64,
    "signed long long": np.int64, "int64": np.int64, "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64,
    "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}

_DTYPE_TO_NRRD = {
    np.dtype(np.int8): "int8", np.dtype(np.uint8): "uint8",
    np.dtype(np.int16): "int16", np.dtype(np.uint16): "uint16",
    np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
    np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
    np.dtype(np.float32): "float", np.dtype(np.float64): "double",
}


def _parse_vector(s: str) -> Optional[np.ndarray]:
    s = s.strip()
    if s == "none":
        return None
    if not (s.startswith("(") and s.endswith(")")):
        raise ValueError(f"bad NRRD vector {s!r}")
    return np.array([float(v) for v in s[1:-1].split(",")])


def _parse_space_directions(s: str):
    """'(a,b,c) (d,e,f) none ...' -> list of vectors / None."""
    out = []
    for tok in s.split(") "):
        tok = tok.strip()
        if not tok:
            continue
        if not tok.endswith(")") and tok != "none":
            tok += ")"
        out.append(None if tok == "none" else _parse_vector(tok))
    return out


def read_header(path: Union[str, Path]) -> Dict:
    """Parse the NRRD text header into a dict (pynrrd-compatible keys)."""
    header: Dict = {}
    with open(path, "rb") as f:
        magic = f.readline().decode("ascii", "replace").strip()
        if not magic.startswith(_MAGIC):
            raise ValueError(f"{path}: not a NRRD file (magic {magic!r})")
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            line = line.decode("ascii", "replace").rstrip("\r\n")
            if line == "":
                break
            if line.startswith("#"):
                continue
            if ":=" in line:  # key-value pair
                key, val = line.split(":=", 1)
                header[key.strip()] = val.strip()
                continue
            key, val = line.split(": ", 1)
            key, val = key.strip(), val.strip()
            if key == "dimension":
                header[key] = int(val)
            elif key == "sizes":
                header[key] = np.array([int(v) for v in val.split()])
            elif key == "spacings":
                header[key] = np.array([float(v) if v != "nan" else np.nan for v in val.split()])
            elif key == "space directions":
                dirs = _parse_space_directions(val)
                header[key] = np.array([d if d is not None else [np.nan] * 3 for d in dirs])
            elif key == "space origin":
                header[key] = _parse_vector(val)
            else:
                header[key] = val
        header["_data_offset"] = f.tell()
    return header


def read(path: Union[str, Path]) -> Tuple[np.ndarray, Dict]:
    """Read an NRRD file -> (data, header); data has shape ``sizes`` with the
    first axis fastest (pynrrd convention)."""
    header = read_header(path)
    sizes = header["sizes"]
    dtype = np.dtype(_TYPE_MAP[header["type"]])
    if header.get("endian", "little") == "big":
        dtype = dtype.newbyteorder(">")
    encoding = header.get("encoding", "raw").lower()
    with open(path, "rb") as f:
        f.seek(header["_data_offset"])
        payload = f.read()
    if encoding in ("gzip", "gz"):
        payload = zlib.decompress(payload, zlib.MAX_WBITS | 32)
    elif encoding != "raw":
        raise ValueError(f"unsupported NRRD encoding {encoding!r}")
    data = np.frombuffer(payload, dtype=dtype, count=int(np.prod(sizes)))
    return data.reshape(tuple(int(s) for s in sizes), order="F"), header


def write(
    path: Union[str, Path],
    data: np.ndarray,
    header: Optional[Dict] = None,
    encoding: str = "gzip",
) -> None:
    """Write ``data`` as NRRD (Fortran order). ``header`` may carry
    'spacings' / 'space directions' / 'space origin'."""
    header = dict(header or {})
    data = np.ascontiguousarray(np.asarray(data).transpose())  # -> F-order bytes
    shape = tuple(reversed(data.shape))
    dtype = np.dtype(data.dtype)
    if dtype not in _DTYPE_TO_NRRD:
        raise ValueError(f"unsupported dtype {dtype}")
    lines = [
        "NRRD0005",
        "# written by vqvae3d_tpu_torch.data.nrrd_io",
        f"type: {_DTYPE_TO_NRRD[dtype]}",
        f"dimension: {len(shape)}",
        f"sizes: {' '.join(str(s) for s in shape)}",
        f"encoding: {encoding}",
        "endian: little",
    ]
    if "spacings" in header:
        lines.append("spacings: " + " ".join(str(float(v)) for v in header["spacings"]))
    if "space directions" in header:
        toks = []
        for d in header["space directions"]:
            if d is None or (hasattr(d, "__len__") and np.all(np.isnan(d))):
                toks.append("none")
            else:
                toks.append("(" + ",".join(str(float(v)) for v in d) + ")")
        lines.append(f"space directions: {' '.join(toks)}")
    if header.get("space origin") is not None:
        lines.append("space origin: (" + ",".join(str(float(v)) for v in header["space origin"]) + ")")
    payload = data.tobytes()  # C-bytes of the transpose == F-bytes of the original
    if encoding in ("gzip", "gz"):
        payload = gzip.compress(payload, compresslevel=1)
    elif encoding != "raw":
        raise ValueError(f"unsupported encoding {encoding!r}")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("ascii"))
        f.write(payload)
