"""The port's library surface: the quickstart example end to end on the
CPU, the seed and parity helpers (``utils/seed.py``, ``utils/misc.py``), and
that the modules of the serving slice and of the last slice (the GEMM FFT,
EXR I/O, the timer and profiler, the synthetic dataset, the mixed-radix
FFT plans) import neither JAX nor the JAX package.
"""

import os
import random
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import utils
from learned_hologram_gan_tpu_torch.examples import quickstart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the modules this slice adds (and the ones it extends), each imported in a
# process where importing jax, flax or the JAX package fails
SLICE_MODULES = [
    "learned_hologram_gan_tpu_torch.ops.asm",
    "learned_hologram_gan_tpu_torch.ops.int8",
    "learned_hologram_gan_tpu_torch.nn.quant",
    "learned_hologram_gan_tpu_torch.models.generator",
    "learned_hologram_gan_tpu_torch.utils.seed",
    "learned_hologram_gan_tpu_torch.utils.misc",
    "learned_hologram_gan_tpu_torch.tools.serve_poh",
    "learned_hologram_gan_tpu_torch.tools.bench_serve",
    "learned_hologram_gan_tpu_torch.tools.eval_quant",
    "learned_hologram_gan_tpu_torch.examples.quickstart",
    "learned_hologram_gan_tpu_torch.serve_smoke",
    "learned_hologram_gan_tpu_torch.card_check",
    "learned_hologram_gan_tpu_torch.ops.mxu_fft",
    "learned_hologram_gan_tpu_torch.ops.cuda.fft_plan",
    "learned_hologram_gan_tpu_torch.ops.cuda.build",
    "learned_hologram_gan_tpu_torch.nn.blocks",
    "learned_hologram_gan_tpu_torch.data.exr",
    "learned_hologram_gan_tpu_torch.exr2bin",
    "learned_hologram_gan_tpu_torch.utils.timer",
    "learned_hologram_gan_tpu_torch.utils.profiling",
    "learned_hologram_gan_tpu_torch.tools.make_synthetic_dataset",
    "learned_hologram_gan_tpu_torch.mixed_radix_smoke",
    "learned_hologram_gan_tpu_torch.highres_smoke",
    "learned_hologram_gan_tpu_torch.tools.quality_run",
    "learned_hologram_gan_tpu_torch.tools.ablation_run",
    "learned_hologram_gan_tpu_torch.tools.convert_reference_weights",
    "learned_hologram_gan_tpu_torch.tools.perceptual_study",
    "learned_hologram_gan_tpu_torch.examples.warming_up_asm",
    "learned_hologram_gan_tpu_torch.examples.warming_up_aperture",
    "learned_hologram_gan_tpu_torch.examples.warming_up_resnet",
    "learned_hologram_gan_tpu_torch.quality_smoke",
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_quickstart_runs_and_writes_its_files(tmp_path):
    out = str(tmp_path / "qs")
    result = quickstart.main(out, device="cpu", unet_base_features=2)
    assert sorted(os.listdir(out)) == ["0.png", "1.png", "2.png", "3.png", "G.msgpack", "G_epoch0.msgpack",
                                       "G_epoch1.msgpack", "history.json"]
    assert tuple(result["poh"].shape) == (1, 3, 32, 32) and torch.isfinite(result["poh"]).all()
    assert np.isfinite(result["history"]["train_losses_tensor"]["G_loss"]).all()
    for p in result["png_paths"]:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_slice_modules_import_without_jax():
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'learned_hologram_gan_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_set_seed_pins_the_host_rngs():
    g = utils.set_seed(5)
    a = (np.random.random(), random.random(), torch.rand(2), torch.rand(2, generator=g))
    g = utils.set_seed(5)
    b = (np.random.random(), random.random(), torch.rand(2), torch.rand(2, generator=g))
    assert a[0] == b[0] and a[1] == b[1]
    torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    torch.testing.assert_close(a[3], b[3], rtol=0, atol=0)


def test_misc_helpers(tmp_path):
    amp, phs = torch.rand(2, 3, 4, 4), torch.rand(2, 3, 4, 4)
    c = utils.complex_plain(amp, phs)
    assert c.dtype == torch.complex64
    torch.testing.assert_close(c.abs(), amp, rtol=1e-6, atol=1e-6)
    arr = np.ones((3, 4, 4), np.float32)
    assert torch.equal(utils.phase_tensor_generator(arr), torch.from_numpy(arr))
    re = c.real
    assert utils.phase_tensor_generator(re) is re
    with pytest.raises(ValueError):
        utils.phase_tensor_generator(3)
    from PIL import Image

    Image.fromarray(np.full((4, 5, 3), 255, np.uint8)).save(tmp_path / "p.png")
    p = utils.phase_tensor_generator(str(tmp_path / "p.png"))
    assert tuple(p.shape) == (3, 4, 5)
    torch.testing.assert_close(p, torch.full((3, 4, 5), 2 * np.pi), rtol=1e-6, atol=1e-6)
    with zipfile.ZipFile(tmp_path / "a.zip", "w") as zf:
        zf.writestr("x/y.txt", "hi")
    utils.unzip_file(str(tmp_path / "a.zip"), str(tmp_path / "out"))
    assert (tmp_path / "out" / "x" / "y.txt").read_text() == "hi"
    assert utils.num_devices() == torch.cuda.device_count()
    assert len(utils.devices_info()) == utils.num_devices()
    with pytest.raises(RuntimeError, match="not available"):
        utils.try_device(utils.num_devices())
