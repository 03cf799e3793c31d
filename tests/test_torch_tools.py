"""The port's ``eval_quality`` and ``highres_train_bench``
(``learned_hologram_gan_tpu_torch/tools``) against the JAX package's
(``tools/``), each run in-process on tiny seeded bins on the CPU (UNet
base 2); ``finetune_highres`` is in tests/test_torch_finetune.py.

Tolerances, with their reasons:
  * ``eval_quality``'s summary in float32: PSNR within 1e-3 dB and SSIM
    within 1e-5 (the propagation gate, 1e-3 at p99.9 on the focal stack,
    moves them by far less); in bfloat16, PSNR within 0.05 dB and SSIM
    within 1e-3: the two packages round the UNet's bfloat16 activations
    in different places (flax's dtype rules), and those differences of a
    few u reach the stack;
  * ``highres_train_bench``: its steps with and without the levers equal
    bit for bit (the same float32 math on the CPU).

Every JAX tool here loads its generator from a file, which replaces all of
the variables its state was initialized with, so the JAX generator's
``init`` runs from its shapes alone (:func:`patch_jax_generator_init`):
flax's eager init compiles op by op, ~30 s a tool on a CPU.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import highres_smoke
from learned_hologram_gan_tpu_torch.tools import eval_quality, highres_train_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUMMARY_BOUNDS = {"float32": (1e-3, 1e-5), "bfloat16": (5e-2, 1e-3)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run tiny shapes, where torch's intra-op threads only
    contend with the other test workers' on a shared CPU: one thread each,
    restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def patch_jax_init(mp, module_cls, seed=100, record=None):
    """Make ``module_cls.init`` (a JAX package model) return seeded numpy
    variables of its tree (``jax.eval_shape``, as tests/test_torch_models.py's
    ``jax_variables``) in place of running it; each call's numpy variables
    are appended to ``record`` when given."""
    import functools

    import jax

    from test_torch_models import _fill, to_jax

    init = module_cls.init

    def from_shapes(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(init, self, **kwargs), rngs, *args)
        variables = {k: _fill(v, np.random.default_rng(seed)) for k, v in shapes.items()}
        if record is not None:
            record.append(variables)
        return to_jax(variables)

    mp.setattr(module_cls, "init", from_shapes)


def patch_jax_generator_init(mp):
    """:func:`patch_jax_init` for the JAX generator."""
    from learned_hologram_gan_tpu.models import Generator as JaxGenerator

    patch_jax_init(mp, JaxGenerator)


@pytest.fixture
def jax_init_from_shapes(monkeypatch):
    patch_jax_generator_init(monkeypatch)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _jax_tool(name).main()


def _jax_generator_file(path, base, rows, cols, seed):
    """Seeded flax generator variables written as the JAX package writes
    them (``G.msgpack``)."""
    import jax.numpy as jnp

    from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
    from learned_hologram_gan_tpu.models import Generator as JaxGenerator
    from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
    from learned_hologram_gan_tpu.train import checkpoint as jckpt
    from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
    from test_torch_models import jax_variables

    cfg = JaxGenConfig(rows=rows, cols=cols, pad_size=8, unet_base_features=base)
    v = jax_variables(JaxGenerator(cfg), jax_gen_plan(cfg), jnp.zeros((1, 4, rows, cols)), seed=seed, train=False)
    state = JaxTrainState(step=0, key=None, params_G=v["params"], batch_stats_G=v["batch_stats"], params_D=None,
                          batch_stats_D=None, opt_state_G=None, opt_state_D=None, vgg_params=None)
    jckpt.save_generator(state, path)


def _read(path):
    with open(path) as f:
        return json.load(f)


def _assert_summaries_close(got, want, dtype):
    d_psnr, d_ssim = SUMMARY_BOUNDS[dtype]
    assert set(got) == set(want)
    assert abs(got["val_PSNR"] - want["val_PSNR"]) <= d_psnr
    assert abs(got["val_SSIM"] - want["val_SSIM"]) <= d_ssim
    # the per-plane PSNRs are rounded to 3 decimals: one rounding step more
    np.testing.assert_allclose(got["per_plane_PSNR"], want["per_plane_PSNR"], rtol=0, atol=d_psnr + 1e-3)
    np.testing.assert_array_equal(got["distances_m"], want["distances_m"])


# (dtype, extra flags, rows, cols, pad): the default path on a power-of-two
# grid (32 x 32: K1's fused branch), the same in bfloat16, and the 4K
# levers on a grid that is not one (16 x 32, pads 4 / 6: 24 x 44)
EVAL_CASES = {
    "float32": ("float32", [], 16, 16, 8),
    "bfloat16": ("bfloat16", [], 16, 16, 8),
    "sequential_no_cache_h_pad_cols": ("float32", ["--sequential", "--no_cache_h", "--pad_cols", "6"], 16, 32, 4),
}


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_eval_quality_matches_jax_tool(tmp_path, monkeypatch, jax_init_from_shapes, case):
    dtype, extra, rows, cols, pad = EVAL_CASES[case]
    highres_smoke._write_split(str(tmp_path / "data"), "val", 5, rows, cols, 20)
    run = tmp_path / "run"
    run.mkdir()
    _jax_generator_file(str(run / "G.msgpack"), 2, rows, cols, 21)
    argv = ["--data", str(tmp_path / "data"), "--run_dir", str(run), "--rows", str(rows), "--cols", str(cols),
            "--pad_size", str(pad), "--val_num", "5", "--batch", "2", "--dtype", dtype, "--num_planes", "4",
            "--samples", "0", "--unet_base_features", "2", *extra]
    _run_jax(monkeypatch, "eval_quality", argv + ["--out", str(tmp_path / "jax")])
    got = eval_quality.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    want = _read(tmp_path / "jax" / "summary.json")
    assert got["summary"] == _read(tmp_path / "port" / "summary.json")
    assert got["summary"]["run_dir"] == str(run)
    _assert_summaries_close(got["summary"], want, dtype)
    with open(tmp_path / "port" / "sample0_focalstack.png", "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_eval_quality_skips_curves_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Where matplotlib does not import, the curves are
    skipped and the tool says so; the summary is written all the same."""
    import builtins

    highres_smoke._write_split(str(tmp_path), "val", 2, 16, 16, 22)
    _jax_generator_file(str(tmp_path / "G.msgpack"), 2, 16, 16, 23)
    with open(tmp_path / "history.json", "w") as f:
        json.dump({"n_train": [1], "validate_metrics_tensor": {"PSNR": [1.0]},
                   "train_metrics_tensor": {"PSNR": [1.0]}}, f)
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    eval_quality.main(["--data", str(tmp_path), "--run_dir", str(tmp_path), "--rows", "16", "--cols", "16",
                       "--pad_size", "8", "--val_num", "2", "--num_planes", "2", "--samples",
                       "--unet_base_features", "2", "--dtype", "float32", "--device", "cpu"])
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "eval")) == ["summary.json"]


def test_highres_train_bench_levers_leave_the_step_unchanged():
    """The bench's GAN step with both levers, with neither and with each
    alone: the same metrics bit for bit on the CPU."""
    base = ["--rows", "16", "--cols", "32", "--pad_size", "4", "--unet_base_features", "2", "--steps", "1",
            "--device", "cpu"]
    runs = [highres_train_bench.main(base + extra)
            for extra in ([], ["--no_remat"], ["--cache_h"], ["--no_remat", "--cache_h"])]
    for r in runs:
        assert r["peak_gib"] is None and np.isfinite(r["ms_per_step"])
        assert r["metrics"] == runs[0]["metrics"]
    assert set(runs[0]["metrics"]) >= {"G_loss", "D_loss", "PSNR", "SSIM"}
