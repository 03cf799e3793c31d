"""The port's entry points on the CPU: the generate_poh CLI, its PNG writer,
the import graph, and chip_smoke.py's refusal to run without a card."""

import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu_torch import card_check, convert, generate_poh
from learned_hologram_gan_tpu_torch.data import ImgDepthDataset
from learned_hologram_gan_tpu_torch.utils.plotting import multi_sample_plotter, write_png
from test_torch_models import jax_apply, jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 32


def _write_bins(tmp_path, n=3):
    rng = np.random.default_rng(17)
    paths = {}
    for name in ("img", "depth"):
        p = str(tmp_path / f"{name}.bin")
        rng.random((n, 3, H, W)).astype(np.float32).tofile(p)
        paths[name] = p
    return paths


def _argv(tmp_path, paths, model_path, extra=()):
    return [
        "--img_path", paths["img"], "--depth_path", paths["depth"], "--index", "2",
        "--model_path", model_path, "--poh_output_path", str(tmp_path / "poh.npy"),
        "--samplesNum", "3", "--sample_row_num", str(H), "--sample_col_num", str(W),
        "--pad_size", "16", "--unet_base_features", "2", "--device", "cpu", *extra,
    ]


def test_generate_poh_cpu_writes_npy_and_pngs(tmp_path, capsys):
    paths = _write_bins(tmp_path)
    out_dir = tmp_path / "recon"
    result = generate_poh.main(_argv(
        tmp_path, paths, str(tmp_path / "missing.pt"),
        ["--propagate", "--num_intervals", "3", "--output_image_dir", str(out_dir)],
    ))
    out = capsys.readouterr().out
    assert "WARNING: model path" in out and "using random init" in out
    assert "POH data saved at" in out and "Propagated images saved at" in out
    poh = np.load(tmp_path / "poh.npy")
    assert poh.shape == (3, H, W) and np.isfinite(poh).all()
    assert sorted(os.listdir(out_dir)) == ["0.png", "1.png", "2.png"]
    assert tuple(result["focal_stack"].shape) == (3, 3, H, W)
    from PIL import Image

    img = np.asarray(Image.open(out_dir / "1.png"))
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert img.max() > 0


def test_generate_poh_matches_jax_through_carried_weights(tmp_path):
    """The CLI with a state_dict carried from JAX weights gives the JAX
    generator's POH for the same sample."""
    paths = _write_bins(tmp_path)
    jcfg = JaxGenConfig(rows=H, cols=W, pad_size=16, filter_radius_coefficient=0.45,
                        unet_base_features=2)
    jplan = jax_gen_plan(jcfg)
    jgen = JaxGenerator(jcfg)
    rgbd = ImgDepthDataset(paths["img"], paths["depth"], samples_num=3, height=H, width=W)[2]
    x = jnp.asarray(rgbd)[None]
    variables = jax_variables(jgen, jplan, x, seed=1, train=False)
    want = np.asarray(jax_apply(jgen, variables, jplan, x, train=False))[0]
    sd = convert.generator_state_dict(variables)
    torch.save(sd, tmp_path / "G.pt")

    generate_poh.main(_argv(tmp_path, paths, str(tmp_path / "G.pt")))
    got = np.load(tmp_path / "poh.npy")
    d = np.abs(np.exp(1j * got.astype(np.float64)) - np.exp(1j * want.astype(np.float64)))
    assert np.quantile(d, 0.99) <= 1e-2 and np.max(d) <= 5e-2


def test_generate_poh_runs_convs_in_full_f32(tmp_path):
    """Every convolution of the CLI path runs with TF32 off, whatever the
    caller's setting, and the caller's setting comes back afterwards."""
    paths = _write_bins(tmp_path)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with card_check.record_conv_tf32([]) as seen:
            generate_poh.main(_argv(tmp_path, paths, "none.pt"))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert len(seen) > 0 and not any(seen)


def test_card_check_on_cpu():
    """The card-vs-CPU check, run with the CPU in both places: identical
    results, no TF32, no K1 launch (the CPU takes the plain version), and
    check() names the launch count it misses."""
    stats = card_check.card_vs_cpu("cpu")
    assert stats["poh_max"] == 0 and stats["stack_max"] == 0
    assert stats["convs"] > 0 and stats["convs_tf32"] == 0 and stats["k1_launches"] == 0
    with pytest.raises(AssertionError, match="K1 launched 0 times"):
        card_check.check(stats)
    card_check.check(dict(stats, k1_launches=2))
    with pytest.raises(AssertionError, match="TF32"):
        card_check.check(dict(stats, k1_launches=2, convs_tf32=1))


def test_generate_poh_refuses_what_is_not_ported(tmp_path):
    paths = _write_bins(tmp_path)
    (tmp_path / "G.msgpack").write_bytes(b"\x80")
    with pytest.raises(NotImplementedError):
        generate_poh.main(_argv(tmp_path, paths, str(tmp_path / "G.msgpack")))
    for extra in (["--dtype", "bfloat16"], ["--mesh_devices", "2"]):
        with pytest.raises(NotImplementedError):
            generate_poh.main(_argv(tmp_path, paths, "none.pt", extra))
    with pytest.raises(IndexError, match="Index out of range"):
        generate_poh.main(_argv(tmp_path, paths, "none.pt", ["--index", "99"]))


def test_generate_poh_defaults_to_cuda():
    args = generate_poh.build_parser().parse_args(
        ["--img_path", "a", "--depth_path", "b", "--index", "0",
         "--model_path", "m", "--poh_output_path", "p"]
    )
    assert args.device == "cuda"
    assert (args.sample_row_num, args.pad_size, args.unet_base_features) == (384, 320, 64)


def test_png_writer_round_trip(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_png(str(tmp_path / "x.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")), rgb)
    raw = (tmp_path / "x.png").read_bytes()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n" and zlib.crc32(raw[12:29]) == int.from_bytes(raw[29:33], "big")

    stack = np.random.default_rng(1).random((2, 3, 4, 6)).astype(np.float32) * 1.2 - 0.1
    paths = multi_sample_plotter(stack, save_dir=str(tmp_path / "s"))
    assert [os.path.basename(p) for p in paths] == ["0.png", "1.png"]
    img = np.asarray(Image.open(paths[1]))
    want = (np.clip(stack[1].transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(img, want)


BLOCKER = r"""
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "msgpack", "ml_dtypes", "matplotlib",
           "PIL", "learned_hologram_gan_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None
sys.meta_path.insert(0, Block())
import pkgutil, importlib
import learned_hologram_gan_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names), "modules")
"""


def test_port_imports_nothing_of_jax():
    """The package and chip_smoke import with jax, flax, optax, msgpack,
    ml_dtypes, matplotlib, PIL and the JAX package all blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", BLOCKER], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda(tmp_path, where):
    """On a host without CUDA the script exits non-zero within seconds and
    prints no result line, from the repo and from a directory holding
    chip_smoke.py and nothing else."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path)
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py"), "rb") as f:
            (tmp_path / "chip_smoke.py").write_bytes(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
