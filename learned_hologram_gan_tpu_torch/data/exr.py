"""EXR reading and EXR -> ``.bin`` dataset conversion (counterpart of
``learned_hologram_gan_tpu/data/exr.py``; reference ``data_processor.py``:
read_exr :20-48, dataConverterExr2Bin :51-106, read_exr_in_multi_folders
:109-127).

Host code, no device.  Decoders, first that works: the ``OpenEXR``
bindings where they import; the native scanline-block decoder (the repo's
``native/exr_decode.cpp`` as it is, built once with ``g++ ... -lz`` into
this package's git-ignored ``_build/``, never into ``native/``); a
self-contained pure-Python decoder for single-part scanline images with
NONE/ZIPS/ZIP compression and HALF/FLOAT/UINT channels.  Where g++ or
zlib is missing the native build fails quietly and the pure decoder runs,
as in the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
# compression id -> scanlines per block
_BLOCK_LINES = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32, 5: 16, 6: 32, 7: 32, 8: 32}
_SUPPORTED_COMPRESSION = {0, 2, 3}  # NONE, ZIPS, ZIP

NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "exr_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _read_cstring(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _parse_channels(data: bytes) -> List[Tuple[str, int]]:
    """chlist attribute -> [(name, pixel_type)] in file order."""
    channels = []
    off = 0
    while off < len(data) and data[off] != 0:
        name, off = _read_cstring(data, off)
        pixel_type = struct.unpack_from("<i", data, off)[0]
        off += 16  # pixel_type + pLinear/reserved + xSampling + ySampling
        channels.append((name, pixel_type))
    return channels


def _unpredict_and_interleave(raw: bytes) -> bytes:
    """Undo EXR ZIP's post-deflate reordering: t[0] as stored, t[i] =
    t[i-1] + raw[i] - 128 (mod 256), then the two halves re-interleaved."""
    d = np.frombuffer(raw, dtype=np.uint8).astype(np.int16)
    d = ((np.cumsum(d - 128, dtype=np.int64) + 128) % 256).astype(np.uint8)
    n = len(d)
    half = (n + 1) // 2
    out = np.empty(n, dtype=np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def read_exr(filename: str) -> np.ndarray:
    """An EXR's R, G, B channels as float32 (3, H, W) (reference
    data_processor.read_exr :20-48), by the first decoder that works."""
    try:
        return _read_exr_openexr(filename)
    except ImportError:
        pass
    return _read_exr_pure(filename)


def _read_exr_openexr(filename: str) -> np.ndarray:
    import Imath
    import OpenEXR

    f = OpenEXR.InputFile(filename)
    dw = f.header()["dataWindow"]
    width = dw.max.x - dw.min.x + 1
    height = dw.max.y - dw.min.y + 1
    pt = Imath.PixelType(Imath.PixelType.FLOAT)
    chans = []
    for c in ("R", "G", "B"):
        data = np.frombuffer(f.channel(c, pt), dtype=np.float32).copy()
        data.shape = (height, width)
        chans.append(data)
    return np.stack(chans).astype(np.float32)


def _parse_exr_header(filename: str, buf: bytes):
    """Magic, version, attributes and offset table of a scanline EXR:
    (channels, compression, (y_min, y_max, height, width), block lines,
    block offsets)."""
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{filename}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("multi-part EXR not supported")
    if version & 0x800:
        raise NotImplementedError("deep-data EXR not supported")
    if version & 0x100:
        raise NotImplementedError("tiled EXR not supported (scanline only)")
    off = 8
    attrs: Dict[str, bytes] = {}
    while True:
        name, off = _read_cstring(buf, off)
        if not name:
            break
        _type, off = _read_cstring(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        attrs[name] = buf[off : off + size]
        off += size
    channels = _parse_channels(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in _SUPPORTED_COMPRESSION:
        raise NotImplementedError(
            f"EXR compression id {compression} not supported by the built-in "
            "decoders (NONE/ZIPS/ZIP are); install OpenEXR for PIZ/PXR24/DWA."
        )
    x_min, y_min, x_max, y_max = struct.unpack("<4i", attrs["dataWindow"])
    width = x_max - x_min + 1
    height = y_max - y_min + 1
    block_lines = _BLOCK_LINES[compression]
    num_blocks = (height + block_lines - 1) // block_lines
    offsets = struct.unpack_from(f"<{num_blocks}Q", buf, off)
    return channels, compression, (y_min, y_max, height, width), block_lines, offsets


_NATIVE_LIB = None
_NATIVE_TRIED = False


def native_library_path() -> Path:
    """Where the native decoder's library is built: ``_build/``, named by a
    hash of its source."""
    digest = hashlib.sha256(NATIVE_SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libexr_decode-{digest}.so"


def _build_native() -> Optional[Path]:
    """Build the native decoder once (g++ and zlib), atomically: concurrent
    callers each build into a temporary file and rename it in place."""
    import shutil
    import subprocess
    import tempfile

    if not NATIVE_SOURCE.exists():
        return None
    so = native_library_path()
    if so.exists():
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([gxx, "-O3", "-fPIC", "-shared", "-o", tmp, str(NATIVE_SOURCE), "-lz"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (subprocess.SubprocessError, OSError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _native_lib():
    """ctypes handle to the native decoder, built at first use, or None."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    import ctypes

    so = _build_native()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
        lib.exr_decode_blocks.restype = ctypes.c_int
        lib.exr_decode_blocks.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
        ]
        _NATIVE_LIB = lib
    except OSError:
        _NATIVE_LIB = None
    return _NATIVE_LIB


def _decode_native(buf, channels, compression, window, block_lines, offsets):
    """Every scanline block decoded by the native library; None on failure."""
    import ctypes

    lib = _native_lib()
    if lib is None:
        return None
    y_min, _y_max, height, width = window
    n_ch = len(channels)
    out = np.empty((n_ch, height, width), dtype=np.float32)
    offs = (ctypes.c_uint64 * len(offsets))(*offsets)
    ptypes = (ctypes.c_int32 * n_ch)(*[pt for _, pt in channels])
    rc = lib.exr_decode_blocks(
        buf, len(buf), offs, len(offsets),
        block_lines, 1 if compression in (2, 3) else 0, y_min,
        height, width, n_ch, ptypes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        return None
    return {name: out[i] for i, (name, _) in enumerate(channels)}


def _rgb(filename: str, planes) -> np.ndarray:
    missing = [c for c in ("R", "G", "B") if c not in planes]
    if missing:
        raise ValueError(f"{filename}: missing channels {missing}")
    return np.stack([planes["R"], planes["G"], planes["B"]]).astype(np.float32)


def _read_exr_pure(filename: str) -> np.ndarray:
    """The built-in decoders: the native one where it builds, else numpy."""
    with open(filename, "rb") as fh:
        buf = fh.read()
    channels, compression, window, block_lines, offsets = _parse_exr_header(filename, buf)
    y_min, y_max, height, width = window
    planes = _decode_native(buf, channels, compression, window, block_lines, offsets)
    if planes is not None:
        return _rgb(filename, planes)

    ch_dtypes = [_PIXEL_DTYPES[pt] for _, pt in channels]
    ch_pitch = [np.dtype(d).itemsize * width for d in ch_dtypes]
    line_pitch = sum(ch_pitch)
    planes = {name: np.empty((height, width), dtype=np.float32) for name, _ in channels}
    for block_off in offsets:
        y, size = struct.unpack_from("<ii", buf, block_off)
        data = buf[block_off + 8 : block_off + 8 + size]
        lines_here = min(block_lines, y_max - y + 1)
        if compression in (2, 3) and size < line_pitch * lines_here:
            # ZIPS / ZIP; a block no smaller than its raw size was stored raw
            data = _unpredict_and_interleave(zlib.decompress(data))
        row0 = y - y_min
        pos = 0
        for line in range(lines_here):
            for (name, _pt), dt, pitch in zip(channels, ch_dtypes, ch_pitch):
                chunk = np.frombuffer(data, dtype=dt, count=width, offset=pos)
                planes[name][row0 + line] = chunk.astype(np.float32)
                pos += pitch
    return _rgb(filename, planes)


def get_files_in_dir(directory: str) -> List[str]:
    """Sorted file paths (reference data_processor.py:14-18)."""
    return [os.path.join(directory, n) for n in sorted(os.listdir(directory))]


class DataConverterExr2Bin:
    """Read a directory of EXRs, write one raw float32 ``.bin`` (reference
    dataConverterExr2Bin :51-106): ``<parent>/<dirname>.bin`` (or
    ``<des>/<dirname>.bin``), shape (N, C, H, W), C order."""

    def __init__(self, directory: str, des: Optional[str] = None, channels_num: int = 3,
                 height: int = 192, width: int = 192):
        self.directory = directory
        up_folder, self.folder_name = os.path.split(directory)
        self.file_paths = get_files_in_dir(directory)
        self.samples_num = len(self.file_paths)
        self.channels_num = channels_num
        self.height = height
        self.width = width
        self.des = des if des is not None else up_folder

    def __len__(self) -> int:
        return self.samples_num

    def save_as_np_array(self) -> str:
        out = np.zeros((self.samples_num, self.channels_num, self.height, self.width),
                       dtype=np.float32)
        for i, path in enumerate(self.file_paths):
            out[i] = read_exr(path)
        out_path = os.path.join(self.des, self.folder_name + ".bin")
        out.tofile(out_path)
        print(f"Saved {out_path} and the size is {os.path.getsize(out_path)}")
        return out_path


def read_exr_in_multi_folders(directory: str, channels_num: int = 3, height: int = 192,
                              width: int = 192) -> None:
    """Convert every subfolder of EXRs to a ``.bin`` (reference :109-127)."""
    folders = [f for f in os.listdir(directory) if os.path.isdir(os.path.join(directory, f))]
    print(f"there are {len(folders)} folders in the directory")
    for folder in folders:
        DataConverterExr2Bin(os.path.join(directory, folder), channels_num=channels_num,
                             height=height, width=width).save_as_np_array()
