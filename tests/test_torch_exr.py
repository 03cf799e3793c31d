"""The port's EXR reader, ``.bin`` converter and ``exr2bin`` CLI against the
JAX package's, on the CPU.

EXRs come from this file's own writer (a copy of
``tests/test_data.py::write_exr``): single-part scanline images with
channels B, G, R in float or half, at compressions NONE (0), ZIPS (2) and
ZIP (3), from seeded numpy data.  Decoded arrays and written bins must be
bit for bit the JAX package's; the native decoder (``native/exr_decode.cpp``
built by the port into its ``_build/``) bit for bit the pure one.
"""

import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from learned_hologram_gan_tpu.data import exr as jexr
from learned_hologram_gan_tpu_torch import exr2bin
from learned_hologram_gan_tpu_torch.data import exr

REPO = Path(__file__).resolve().parents[1]


def _attr(name: str, type_: str, payload: bytes) -> bytes:
    return name.encode() + b"\x00" + type_.encode() + b"\x00" + struct.pack("<i", len(payload)) + payload


def _chlist(channels, pixel_type=2) -> bytes:
    out = b""
    for name in channels:
        out += name.encode() + b"\x00"
        out += struct.pack("<i", pixel_type)  # FLOAT=2, HALF=1
        out += b"\x00" * 4  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\x00"


def _zip_predict_interleave(raw: bytes) -> bytes:
    n = len(raw)
    half = (n + 1) // 2
    arr = np.frombuffer(raw, dtype=np.uint8)
    t = np.empty(n, dtype=np.uint8)
    t[:half] = arr[0::2]
    t[half:] = arr[1::2]
    enc = t.astype(np.int32)
    enc[1:] = (enc[1:] - t[:-1].astype(np.int32) + 128 + 256) % 256
    return zlib.compress(enc.astype(np.uint8).tobytes())


def write_exr(path, rgb: np.ndarray, compression: int = 0, half: bool = False):
    """Write a single-part scanline EXR with channels B, G, R (alphabetical)."""
    _, h, w = rgb.shape
    dtype = np.float16 if half else np.float32
    pixel_type = 1 if half else 2
    header = b""
    header += _attr("channels", "chlist", _chlist(["B", "G", "R"], pixel_type))
    header += _attr("compression", "compression", bytes([compression]))
    header += _attr("dataWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += _attr("displayWindow", "box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
    header += _attr("lineOrder", "lineOrder", b"\x00")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"
    block_lines = {0: 1, 2: 1, 3: 16}[compression]
    num_blocks = (h + block_lines - 1) // block_lines
    blocks = []
    for b0 in range(0, h, block_lines):
        lines = min(block_lines, h - b0)
        raw = b""
        for line in range(lines):
            y = b0 + line
            for ch in ("B", "G", "R"):
                raw += rgb[{"R": 0, "G": 1, "B": 2}[ch], y].astype(dtype).tobytes()
        if compression in (2, 3):
            comp = _zip_predict_interleave(raw)
            payload = comp if len(comp) < len(raw) else raw
        else:
            payload = raw
        blocks.append((b0, payload))
    base = 8 + len(header) + 8 * num_blocks
    offsets, off = [], base
    for _, payload in blocks:
        offsets.append(off)
        off += 8 + len(payload)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", 20000630, 2))
        f.write(header)
        f.write(struct.pack(f"<{num_blocks}Q", *offsets))
        for y, payload in blocks:
            f.write(struct.pack("<ii", y, len(payload)))
            f.write(payload)


CASES = [(c, h) for c in (0, 2, 3) for h in (False, True)]


def _image(seed, shape=(3, 21, 18)):
    # a smooth ramp (compresses, so ZIP blocks are stored deflated) plus noise
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 1, shape[1] * shape[2]).reshape(shape[1:])
    return (ramp[None] + 0.01 * rng.random(shape)).astype(np.float32)


@pytest.mark.parametrize("compression,half", CASES)
def test_read_exr_matches_jax_bit_for_bit(tmp_path, compression, half):
    rgb = _image(compression + 10 * half)
    p = str(tmp_path / "t.exr")
    write_exr(p, rgb, compression=compression, half=half)
    got = exr.read_exr(p)
    assert got.dtype == np.float32 and got.shape == rgb.shape
    np.testing.assert_array_equal(got, jexr.read_exr(p))
    want = rgb.astype(np.float16).astype(np.float32) if half else rgb
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compression,half", CASES)
def test_pure_decoder_matches_jax_pure_decoder(tmp_path, compression, half, monkeypatch):
    """Both packages' numpy decoders (the native ones switched off), bit for bit."""
    rgb = _image(20 + compression + 10 * half, (3, 37, 5))  # ZIP: 3 blocks, the last short
    p = str(tmp_path / "p.exr")
    write_exr(p, rgb, compression=compression, half=half)
    for mod in (exr, jexr):
        monkeypatch.setattr(mod, "_NATIVE_TRIED", True)
        monkeypatch.setattr(mod, "_NATIVE_LIB", None)
    np.testing.assert_array_equal(exr._read_exr_pure(p), jexr._read_exr_pure(p))


def test_native_decoder_matches_pure(tmp_path, monkeypatch):
    """native/exr_decode.cpp, built by the port into its _build/ (never into
    native/), bit for bit the numpy decoder."""
    if exr._native_lib() is None:
        pytest.skip("native decoder unavailable (no g++ or zlib)")
    assert Path(exr.native_library_path()).parent == exr.BUILD_DIR
    for comp, half in CASES:
        rgb = _image(30 + comp + 10 * half)
        p = str(tmp_path / f"n_{comp}_{half}.exr")
        write_exr(p, rgb, compression=comp, half=half)
        native = exr._read_exr_pure(p)
        with monkeypatch.context() as m:
            m.setattr(exr, "_NATIVE_LIB", None)
            pure = exr._read_exr_pure(p)
        np.testing.assert_array_equal(native, pure)


def test_header_parse_matches_jax(tmp_path):
    p = str(tmp_path / "h.exr")
    write_exr(p, _image(40, (3, 40, 9)), compression=3)
    buf = Path(p).read_bytes()
    assert exr._parse_exr_header(p, buf) == jexr._parse_exr_header(p, buf)
    with pytest.raises(ValueError, match="not an EXR"):
        exr._parse_exr_header(p, b"\x00" * 16)


def _folders(root, seed=50, n=3, h=6, w=7):
    rng = np.random.default_rng(seed)
    for name, comp in (("img", 3), ("depth", 0)):
        d = root / name
        d.mkdir(parents=True)
        for i in range(n):
            write_exr(str(d / f"{i:03d}.exr"), rng.random((3, h, w)).astype(np.float32), compression=comp)


def test_converter_bins_match_jax_bytes(tmp_path):
    """DataConverterExr2Bin and read_exr_in_multi_folders write the JAX
    package's bytes."""
    for tag in ("port", "jax"):
        _folders(tmp_path / tag / "set")
    out = exr.DataConverterExr2Bin(str(tmp_path / "port" / "set" / "img"), channels_num=3,
                                   height=6, width=7).save_as_np_array()
    want = jexr.DataConverterExr2Bin(str(tmp_path / "jax" / "set" / "img"), channels_num=3,
                                     height=6, width=7).save_as_np_array()
    assert Path(out).read_bytes() == Path(want).read_bytes()
    assert len(exr.DataConverterExr2Bin(str(tmp_path / "port" / "set" / "img"))) == 3
    exr.read_exr_in_multi_folders(str(tmp_path / "port" / "set"), 3, 6, 7)
    jexr.read_exr_in_multi_folders(str(tmp_path / "jax" / "set"), 3, 6, 7)
    for name in ("img", "depth"):
        assert ((tmp_path / "port" / "set" / f"{name}.bin").read_bytes()
                == (tmp_path / "jax" / "set" / f"{name}.bin").read_bytes())


@pytest.mark.parametrize("flags,message", [
    ([], "Error: channelsNum parameter is missing."),
    (["--channelsNum", "3"], "Error: height parameter is missing."),
    (["--channelsNum", "3", "--height", "6"], "Error: width parameter is missing."),
])
def test_cli_missing_parameters(tmp_path, capsys, flags, message):
    assert exr2bin.main([str(tmp_path)] + flags) == 1
    assert capsys.readouterr().out.strip() == message


def test_cli_matches_the_repo_script(tmp_path):
    """The port's CLI and the repo's exr2bin.py on the same folders: the
    same bins, the same output lines (paths aside), and the same message and
    exit code 1 for a missing parameter."""
    for tag in ("port", "jax"):
        _folders(tmp_path / tag / "set")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for tag, cmd in (("port", [sys.executable, "-m", "learned_hologram_gan_tpu_torch.exr2bin"]),
                     ("jax", [sys.executable, str(REPO / "exr2bin.py")])):
        root = tmp_path / tag
        runs[tag] = subprocess.run(cmd + [str(root / "set"), str(root / "missing"), "--channelsNum", "3",
                                          "--height", "6", "--width", "7"],
                                   cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert runs[tag].returncode == 0, runs[tag].stderr
    for name in ("img", "depth"):
        assert ((tmp_path / "port" / "set" / f"{name}.bin").read_bytes()
                == (tmp_path / "jax" / "set" / f"{name}.bin").read_bytes())
    lines = {tag: sorted(r.stdout.replace(str(tmp_path / tag), "ROOT").splitlines())
             for tag, r in runs.items()}
    assert lines["port"] == lines["jax"]
    missing = subprocess.run([sys.executable, str(REPO / "exr2bin.py"), str(tmp_path)], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
    assert missing.returncode == 1
    assert missing.stdout.strip() == "Error: channelsNum parameter is missing."
