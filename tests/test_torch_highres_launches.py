"""The kernel launches ``highres_smoke.py`` holds its 1080p and 4K runs to,
counted on the CPU at small grids of the same kind.

At 1080p the padded grid is 1728 x 3048: K1 and K2 take rp = 1728 (a
mixed-radix plan) at any cp, and K3 declines the grid (3048 = 8 * 3 * 127
has no plan).  The same holds at 32 x 16, pad 11: 54 x 26 (54 = 2 * 27,
26 = 2 * 13).
The 4K grid (2880 x 5000) is taken by K1 and K3 alike, as 16 x 32 at pads
4 / 8 (24 x 48) is.  On a CPU tensor each wrapper calls its plain version once
where the card launches the kernel once (``test_torch_remat._LaunchCounter``),
after the same predicates, so the counts are the card's.
"""

import pytest
import torch

from learned_hologram_gan_tpu_torch import highres_smoke
from learned_hologram_gan_tpu_torch.ops.cuda import fft, spectral
from test_torch_remat import _LaunchCounter


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_small_grids_are_of_the_high_resolution_kind():
    assert spectral.supported(1728, 3048) and not fft.supported(1728, 3048)
    assert spectral.supported(54, 26) and not fft.supported(54, 26)
    assert spectral.supported(2880, 5000) and fft.supported(2880, 5000)
    assert spectral.supported(24, 48) and fft.supported(24, 48)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_1080p_bench_launches(monkeypatch, remat):
    """highres_train_bench's steps at a K1-but-not-K3 grid: each step's K1
    and K2 launches, no K3 (on the CPU it runs no split step: the warm-up
    and --steps 2, three steps)."""
    from learned_hologram_gan_tpu_torch.tools import highres_train_bench

    counter = _LaunchCounter(monkeypatch)
    highres_train_bench.main(["--rows", "32", "--cols", "16", "--pad_size", "11", "--distances", "4",
                              "--unet_base_features", "2", "--steps", "2", "--device", "cpu"]
                             + ([] if remat else ["--no_remat"]))
    step = highres_smoke.expected_step_launches(remat, k3_grid=False)
    assert step["k3"] == 0
    assert counter.read() == dict(k1={k: 3 * v for k, v in step["k1"].items()},
                                  k2={k: 3 * v for k, v in step["k2"].items()}, k3=0)


def test_1080p_finetune_launches(monkeypatch, tmp_path):
    """finetune_highres at a K1-but-not-K3 grid: its train steps under
    remat (no validation inside the epoch), then its evaluation's batches
    and sample 0's grid, as highres_smoke.finetune_1080p expects them."""
    from learned_hologram_gan_tpu_torch.tools import finetune_highres

    train, val = highres_smoke.FT_TRAIN, highres_smoke.FT_VAL
    highres_smoke._write_split(str(tmp_path / "data"), "train", train, 32, 16, 10)
    highres_smoke._write_split(str(tmp_path / "data"), "val", val, 32, 16, 11)
    counter = _LaunchCounter(monkeypatch)
    finetune_highres.main(["--data", str(tmp_path / "data"), "--out", str(tmp_path / "out"), "--init", "",
                           "--rows", "32", "--cols", "16", "--pad_size", "11", "--train_num", str(train),
                           "--val_num", str(val), "--epochs", "1", "--distances", "4",
                           "--unet_base_features", "2", "--device", "cpu"])
    assert counter.read() == highres_smoke.expected_finetune_launches(train, val)


def test_4k_eval_launches(monkeypatch, tmp_path):
    """eval_quality --sequential --no_cache_h at a grid K1 and K3 both
    take, batch 1, no sample grids: the 4K run's expectation."""
    from learned_hologram_gan_tpu_torch.config import GeneratorConfig
    from learned_hologram_gan_tpu_torch.models import make_generator
    from learned_hologram_gan_tpu_torch.tools import eval_quality
    from learned_hologram_gan_tpu_torch.train import checkpoint as ckpt_lib

    highres_smoke._write_split(str(tmp_path), "val", 2, 16, 32, 12)
    ckpt_lib.save_weights(str(tmp_path / "G.msgpack"),
                          make_generator(GeneratorConfig(unet_base_features=2), device="cpu"))
    counter = _LaunchCounter(monkeypatch)
    eval_quality.main(["--data", str(tmp_path), "--run_dir", str(tmp_path), "--out", str(tmp_path / "eval"),
                       "--rows", "16", "--cols", "32", "--pad_size", "4", "--pad_cols", "8", "--sequential",
                       "--no_cache_h", "--num_planes", "3", "--batch", "1", "--val_num", "2", "--samples",
                       "--unet_base_features", "2", "--dtype", "float32", "--device", "cpu"])
    assert counter.read() == highres_smoke.expected_eval_launches(2, 3, True)
