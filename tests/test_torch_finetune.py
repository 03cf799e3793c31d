"""The port's ``finetune_highres`` against the JAX package's
``tools/finetune_highres.py``, both run in-process on tiny seeded bins on
the CPU (UNet base 2, float32 data and convolutions).

Tolerances, with their reasons: the history within the train step's gates
over 24 Adam steps (losses and metrics 2e-3 relative; tests/
test_torch_train.py); the port's in-process evaluation against the JAX
``eval_quality`` tool's ``main`` on the port's written generator within
tests/test_torch_tools.py's float32 summary bounds (PSNR 1e-3 dB, SSIM
1e-5).
"""

import os

import numpy as np

from learned_hologram_gan_tpu_torch import highres_smoke
from learned_hologram_gan_tpu_torch.tools import finetune_highres
from test_torch_tools import (_assert_summaries_close, _jax_generator_file, _read, _run_jax,  # noqa: F401
                              jax_init_from_shapes, one_torch_thread)


def test_finetune_highres_matches_jax_tool(tmp_path, monkeypatch, jax_init_from_shapes):
    """Both tools from the same JAX-written generator on the same bins, 6
    epochs of 4 steps (one validation at step 24), float32 data and convs,
    one distance (so the random distance draw is the same in both): the
    histories within the step gates.  The port's in-process evaluation
    against the JAX tool's on the port's generator file."""
    rows, cols = 16, 16
    data = str(tmp_path / "data")
    highres_smoke._write_split(data, "train", 4, rows, cols, 24)
    highres_smoke._write_split(data, "val", 2, rows, cols, 25)
    _jax_generator_file(str(tmp_path / "init.msgpack"), 2, rows, cols, 26)
    argv = ["--data", data, "--init", str(tmp_path / "init.msgpack"), "--rows", str(rows), "--cols", str(cols),
            "--pad_size", "8", "--train_num", "4", "--val_num", "2", "--epochs", "6", "--distances", "1",
            "--eval_planes", "3", "--unet_base_features", "2", "--dtype", "float32", "--data_dtype", "float32"]
    _run_jax(monkeypatch, "finetune_highres", argv + ["--out", str(tmp_path / "jax"), "--skip_eval"])
    got = finetune_highres.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    want = _read(tmp_path / "jax" / "history.json")
    hist = _read(tmp_path / "port" / "history.json")
    assert hist == got["history"] and set(hist) == set(want)
    assert hist["n_batch"] == want["n_batch"] == [24]
    for group in ("train_losses_tensor", "train_metrics_tensor", "validate_losses_tensor",
                  "validate_metrics_tensor"):
        for k, w in want[group].items():
            np.testing.assert_allclose(hist[group][k], w, rtol=2e-3, atol=1e-6, err_msg=f"{group}/{k}")
    assert os.path.exists(tmp_path / "port" / "timings.json")

    _run_jax(monkeypatch, "eval_quality", [
        "--data", data, "--run_dir", str(tmp_path / "port"), "--out", str(tmp_path / "jax_eval"),
        "--rows", str(rows), "--cols", str(cols), "--pad_size", "8", "--val_num", "2", "--batch", "1",
        "--dtype", "float32", "--num_planes", "3", "--no_cache_h", "--samples", "0", "--unet_base_features", "2"])
    _assert_summaries_close(got["evaluation"]["summary"], _read(tmp_path / "jax_eval" / "summary.json"), "float32")
