"""Minimal pure-NumPy NIfTI-1 codec (.nii / .nii.gz): the port's own copy
of the JAX package's ``data/nifti.py``, byte for byte the same decode
and encode (``tests/test_torch_preprocess.py``).

The reference reads volumes with nibabel (``training.py:87``,
``utils/data_loader.py:40``); nibabel is not part of this stack's
dependency budget, so the subset of NIfTI-1 the pipeline needs is
implemented here from the specification: the 348-byte header, raw data
section, affine from srow/qform/pixdim, and scl_slope/inter scaling.
Only single-file ``.nii``(.gz) with scalar voxel types is supported —
exactly what BraTS distributes.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC = (b"n+1\x00", b"ni1\x00")

# NIfTI datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    """In-memory NIfTI volume: data + affine + raw header fields."""

    data: np.ndarray
    affine: np.ndarray           # 4x4 voxel->world
    pixdim: Tuple[float, ...]    # voxel spacing per spatial axis

    def get_fdata(self) -> np.ndarray:
        """nibabel-compatible accessor (float64 view of the data)."""
        return self.data.astype(np.float64)

    @property
    def shape(self):
        return self.data.shape

    @property
    def spacing(self) -> Tuple[float, float, float]:
        return tuple(float(p) for p in self.pixdim[:3])


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# decompressed-size cap for reads: gzip expands up to ~1000x, so an
# uploaded 100 MB .nii.gz bomb could otherwise decompress to ~100 GB
# and exhaust host memory before any shape check runs. The largest
# legitimate volume this stack handles (240x240x155 float64) is
# ~70 MB; 2 GB leaves two orders of magnitude of headroom.
MAX_DECOMPRESSED_BYTES = 2 << 30


def load(path: str) -> NiftiImage:
    """Read a .nii or .nii.gz file."""
    with _open(path, "rb") as f:
        raw = f.read(MAX_DECOMPRESSED_BYTES + 1)
        if len(raw) > MAX_DECOMPRESSED_BYTES:
            raise ValueError(
                f"{path}: decompressed size exceeds "
                f"{MAX_DECOMPRESSED_BYTES} bytes")
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")

    sizeof_hdr = struct.unpack("<i", raw[0:4])[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        endian = ">"
        if struct.unpack(">i", raw[0:4])[0] != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")

    def unpack(fmt, off, n=1):
        vals = struct.unpack_from(endian + fmt, raw, off)
        return vals[0] if n == 1 else vals

    magic = raw[344:348]
    if magic not in _MAGIC:
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(endian + "8h", raw, 40)
    ndim = int(dim[0])
    shape = tuple(int(d) for d in dim[1:1 + max(ndim, 1)])
    # squeeze trailing singleton dims (common in BraTS exports)
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]

    datatype = unpack("h", 70)
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)

    pixdim, sform_code, qform_code = _header_geometry(raw, endian)
    vox_raw = unpack("f", 108)
    # vox_offset is a float field an attacker controls: NaN/inf would
    # raise OverflowError at int(), negative/oversized offsets would
    # turn into confusing frombuffer errors — reject them as the
    # controlled codec error (found by tests/test_nifti_fuzz.py)
    if not np.isfinite(vox_raw) or vox_raw < 0 or vox_raw > len(raw):
        raise ValueError(f"{path}: bad vox_offset {vox_raw}")
    # NIfTI-1 single-file data starts at >= 352; clamp smaller values
    # (incl. fractional 0<v<1) to the header size — never aliases header bytes as voxels
    vox_offset = max(int(vox_raw), _HDR_SIZE)
    scl_slope = unpack("f", 112)
    scl_inter = unpack("f", 116)

    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=dtype, count=count,
                         offset=vox_offset)
    data = data.reshape(shape, order="F").copy()

    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data.astype(np.float32) * slope + scl_inter

    affine = _affine_from_header(raw, endian, pixdim,
                                 sform_code, qform_code)

    return NiftiImage(data=data, affine=affine,
                      pixdim=tuple(pixdim[1:4]))


def _affine_from_header(raw: bytes, endian: str, pixdim,
                        sform_code: int, qform_code: int) -> np.ndarray:
    """sform > qform > pixdim-diagonal fallback (NIfTI-1 precedence)."""
    affine = np.eye(4, dtype=np.float64)
    if sform_code > 0:
        srow = np.array([
            struct.unpack_from(endian + "4f", raw, 280),
            struct.unpack_from(endian + "4f", raw, 296),
            struct.unpack_from(endian + "4f", raw, 312),
        ])
        affine[:3, :] = srow
    elif qform_code > 0:
        affine = _quaternion_affine(raw, endian, pixdim)
    else:
        for i in range(3):
            affine[i, i] = pixdim[i + 1] or 1.0
    return affine


def _header_geometry(raw: bytes, endian: str):
    """(pixdim, sform_code, qform_code) — the one place that knows the
    geometry field offsets (76 / 254 / 252), shared by ``load`` and
    ``load_affine``."""
    pixdim = struct.unpack_from(endian + "8f", raw, 76)
    sform_code = struct.unpack_from(endian + "h", raw, 254)[0]
    qform_code = struct.unpack_from(endian + "h", raw, 252)[0]
    return pixdim, sform_code, qform_code


def load_affine(path: str) -> np.ndarray:
    """Voxel->world affine from just the 352-byte header — no voxel
    decode (a gz stream read stops after the header block), so
    propagating an input scan's registration into prediction masks
    costs microseconds. Raises on non-NIfTI input."""
    with _open(path, "rb") as f:
        raw = f.read(_HDR_SIZE)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    endian = "<"
    if struct.unpack("<i", raw[0:4])[0] != _HDR_SIZE:
        endian = ">"
        if struct.unpack(">i", raw[0:4])[0] != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
    if raw[344:348] not in _MAGIC:
        raise ValueError(f"{path}: bad NIfTI magic {raw[344:348]!r}")
    pixdim, sform_code, qform_code = _header_geometry(raw, endian)
    return _affine_from_header(raw, endian, pixdim,
                               sform_code, qform_code)


def affine_spacing(affine) -> Optional[Tuple[float, float, float]]:
    """Per-axis voxel size in mm (column norms of the 3x3 block);
    None for absent/degenerate affines (callers then assume 1 mm
    isotropic — the reference's standing assumption, main.py:473)."""
    if affine is None:
        return None
    sp = tuple(float(np.linalg.norm(np.asarray(affine)[:3, i]))
               for i in range(3))
    return sp if all(s > 0 for s in sp) else None


def affine_voxel_volume(affine) -> Optional[float]:
    """Voxel volume in mm^3 = |det| of the 3x3 block — exact under
    shear, where the product of column norms overestimates."""
    if affine is None:
        return None
    v = abs(float(np.linalg.det(np.asarray(affine)[:3, :3])))
    return v if v > 0 else None


def _quaternion_affine(raw: bytes, endian: str, pixdim) -> np.ndarray:
    b, c, d = struct.unpack_from(endian + "3f", raw, 256)
    qx, qy, qz = struct.unpack_from(endian + "3f", raw, 268)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array([
        [a*a+b*b-c*c-d*d, 2*(b*c-a*d),     2*(b*d+a*c)],
        [2*(b*c+a*d),     a*a+c*c-b*b-d*d, 2*(c*d-a*b)],
        [2*(b*d-a*c),     2*(c*d+a*b),     a*a+d*d-b*b-c*c],
    ])
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    S = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0,
                 (pixdim[3] or 1.0) * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R @ S
    aff[:3, 3] = (qx, qy, qz)
    return aff


def save(path: str, data: np.ndarray,
         affine: Optional[np.ndarray] = None,
         spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> None:
    """Write a .nii / .nii.gz file (scalar dtypes only)."""
    payload = encode(data, affine=affine, spacing=spacing)
    with _open(path, "wb") as f:
        f.write(payload)


def encode(data: np.ndarray,
           affine: Optional[np.ndarray] = None,
           spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
           ) -> bytes:
    """Uncompressed .nii bytes in memory (``save`` gzips when the path
    says so; callers shipping over HTTP gzip themselves)."""
    data = np.asarray(data)
    if data.dtype not in _CODES:
        if np.issubdtype(data.dtype, np.floating):
            data = data.astype(np.float32)
        else:
            data = data.astype(np.int32)
    if affine is None:
        affine = np.diag([*spacing, 1.0])

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(data.dtype)])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)   # bitpix
    pix = [1.0] + [float(np.linalg.norm(affine[:3, i]))
                   for i in range(min(3, data.ndim))]
    pix += [1.0] * (8 - len(pix))
    struct.pack_into("<8f", hdr, 76, *pix)
    struct.pack_into("<f", hdr, 108, 352.0)     # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)       # scl_slope
    struct.pack_into("<h", hdr, 254, 1)         # sform_code
    aff = np.asarray(affine, np.float64)
    struct.pack_into("<4f", hdr, 280, *aff[0, :])
    struct.pack_into("<4f", hdr, 296, *aff[1, :])
    struct.pack_into("<4f", hdr, 312, *aff[2, :])
    hdr[344:348] = b"n+1\x00"

    return bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")


def load_volume(path: str) -> np.ndarray:
    """Convenience: volume as float32 array (parity with the reference's
    ``load_nifti_volume``, ``data_utils.py:11-19``)."""
    return load(path).data.astype(np.float32)
