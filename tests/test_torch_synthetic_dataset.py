"""The port's ``tools/make_synthetic_dataset.py`` against the repo's JAX tool
at 32 x 32 (pad 8, a 48 x 48 grid), a few samples, on the CPU.

The scenes are the same seeded numpy code, so ``img`` and ``depth`` must
be byte for byte the JAX tool's.  ``amp`` and ``phs`` come through each
package's ASM in float32: amplitudes within 1e-5 (normalized to ~1);
phases, stored as a wrapped angle / 2 pi, compared as phasors where the
amplitude is above 1e-3 (a value near the wrap may land on either side),
within 1e-3 of a turn.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import OpticsConfig as JaxOptics
from learned_hologram_gan_tpu_torch.config import OpticsConfig
from learned_hologram_gan_tpu_torch.tools import make_synthetic_dataset as port_tool

REPO = Path(__file__).resolve().parents[1]
GEOMETRY = dict(rows=32, cols=32, pad_size=8, filter_radius_coefficient=0.45)
SEED = 123


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_make_synthetic_dataset",
                                                  REPO / "tools" / "make_synthetic_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def _read(d, name, n):
    return np.fromfile(d / f"{name}.bin", dtype=np.float32).reshape(n, 3, 32, 32)


def test_scenes_match_jax_tool(jax_tool):
    for seed in (0, 7):
        a = jax_tool.make_scene(np.random.default_rng(seed), 24, 20)
        b = port_tool.make_scene(np.random.default_rng(seed), 24, 20)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_bins_match_jax_tool(tmp_path, jax_tool):
    n = 5
    jsynth, jz = jax_tool.build_synth_fn(JaxOptics(**GEOMETRY), 4, -2e-5, -4e-4)
    jax_tool.generate_split(str(tmp_path / "jax"), n, 32, 32, jsynth, SEED, batch=2)
    synth, z = port_tool.build_synth_fn(OpticsConfig(**GEOMETRY), 4, -2e-5, -4e-4, device="cpu")
    port_tool.generate_split(str(tmp_path / "port"), n, 32, 32, synth, SEED, batch=2, device="cpu")
    np.testing.assert_array_equal(z, jz)
    for name in ("img", "depth"):
        assert (tmp_path / "port" / f"{name}.bin").read_bytes() == (tmp_path / "jax" / f"{name}.bin").read_bytes()
    amp, jamp = _read(tmp_path / "port", "amp", n), _read(tmp_path / "jax", "amp", n)
    np.testing.assert_allclose(amp, jamp, rtol=0, atol=1e-5)
    phs, jphs = _read(tmp_path / "port", "phs", n), _read(tmp_path / "jax", "phs", n)
    d = np.abs(np.exp(2j * np.pi * phs.astype(np.float64)) - np.exp(2j * np.pi * jphs.astype(np.float64)))
    assert np.max(d[jamp > 1e-3]) <= 2 * np.pi * 1e-3
    assert phs.min() >= 0 and phs.max() < 1


def test_cli_writes_both_splits_and_a_preview(tmp_path):
    out = tmp_path / "synth"
    port_tool.main(["--out", str(out), "--train_num", "2", "--val_num", "1", "--rows", "32",
                    "--cols", "32", "--pad_size", "8", "--layers", "3", "--device", "cpu"])
    for split, n in (("train", 2), ("val", 1)):
        for name in ("img", "depth", "amp", "phs"):
            assert (out / split / f"{name}.bin").stat().st_size == n * 3 * 32 * 32 * 4
    png = (out / "preview_train0.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    port_tool.main(["--out", str(out), "--rows", "32", "--cols", "32", "--pad_size", "8",
                    "--preview_only", "--device", "cpu"])


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_tool.main(["--out", str(tmp_path), "--train_num", "1", "--val_num", "1"])


def test_synth_matches_jax_on_one_batch(jax_tool):
    """The synthesizer alone on one seeded batch (no files)."""
    rng = np.random.default_rng(9)
    img = rng.random((2, 3, 32, 32)).astype(np.float32)
    depth = rng.random((2, 32, 32)).astype(np.float32)
    phs0 = (2.5 * rng.random((2, 32, 32))).astype(np.float32)
    jsynth, _ = jax_tool.build_synth_fn(JaxOptics(**GEOMETRY), 5, -2e-5, -4e-4)
    ja, jp = (np.asarray(a) for a in jsynth(*(jnp.asarray(a) for a in (img, depth, phs0))))
    synth, _ = port_tool.build_synth_fn(OpticsConfig(**GEOMETRY), 5, -2e-5, -4e-4, device="cpu")
    a, p = (t.numpy() for t in synth(*(torch.from_numpy(x) for x in (img, depth, phs0))))
    np.testing.assert_allclose(a, ja, rtol=0, atol=1e-5)
    d = np.abs(np.exp(2j * np.pi * p.astype(np.float64)) - np.exp(2j * np.pi * jp.astype(np.float64)))
    assert np.max(d[ja > 1e-3]) <= 2 * np.pi * 1e-3
