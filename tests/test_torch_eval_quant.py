"""The port's ``tools/eval_quant.py`` against the JAX package's, each run
in-process on tiny seeded bins on the CPU (16 x 16, pad 8, UNet base 2,
float32, timing off), with the JAX generator's ``init`` from its shapes
(tests/test_torch_tools.patch_jax_generator_init).

Bounds: the fused float32 row (``bf16``, the tool's label for the
unquantized path) within 1e-3 dB PSNR and 1e-5 SSIM, the float32 bound of
tests/test_torch_tools.py; the two int8 rows within 0.05 dB and 1e-3 SSIM:
each package calibrates its own tree from the same weights and samples,
and a weight code or requantized activation may round one code apart.
"""

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import highres_smoke
from learned_hologram_gan_tpu_torch.tools import eval_quant
from test_torch_tools import _jax_generator_file, _read, _run_jax, jax_init_from_shapes  # noqa: F401

ROWS = COLS = 16
BOUNDS = {"bf16": (1e-3, 1e-5), "int8": (5e-2, 1e-3), "int8_static": (5e-2, 1e-3)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_eval_quant_matches_jax_tool(tmp_path, monkeypatch, jax_init_from_shapes):  # noqa: F811
    data = str(tmp_path / "data")
    highres_smoke._write_split(data, "val", 4, ROWS, COLS, 40)
    highres_smoke._write_split(data, "train", 4, ROWS, COLS, 41)
    run = tmp_path / "run"
    run.mkdir()
    _jax_generator_file(str(run / "G.msgpack"), 2, ROWS, COLS, 42)
    argv = ["--data", data, "--run_dir", str(run), "--rows", str(ROWS), "--cols", str(COLS),
            "--pad_size", "8", "--val_num", "4", "--batch", "2", "--calib_num", "4", "--num_planes", "4",
            "--dtype", "float32", "--unet_base_features", "2", "--time_batch", "0", "--cpu"]
    _run_jax(monkeypatch, "eval_quant", argv + ["--out", str(tmp_path / "jax")])
    got = eval_quant.main(argv + ["--out", str(tmp_path / "port")])
    want = _read(str(tmp_path / "jax" / "summary.json"))
    assert got == _read(str(tmp_path / "port" / "summary.json"))
    for label, (d_psnr, d_ssim) in BOUNDS.items():
        assert abs(got[label]["val_PSNR"] - want[label]["val_PSNR"]) <= d_psnr, label
        assert abs(got[label]["val_SSIM"] - want[label]["val_SSIM"]) <= d_ssim, label
    np.testing.assert_allclose(got["stage1_MB"]["f32"], want["stage1_MB"]["f32"], rtol=1e-12)
    np.testing.assert_allclose(got["stage1_MB"]["int8_packed"], want["stage1_MB"]["int8_packed"], rtol=1e-12)
    # the quantized paths really moved the result
    assert got["delta_dB"]["int8_static"] != 0.0
