"""The port's warming-up examples (``learned_hologram_gan_tpu_torch/examples``)
and ``tools/perceptual_study`` on the CPU, against the JAX package's
``examples/`` where they print figures.

Tolerances, with their reasons: the ASM study's SNRs within 1e-2 dB and its
2-D band-limit difference within 1e-4 relative, the aperture study's tone
energies within 1e-4 relative.  Both sides compute in float32 (the JAX
examples under JAX's default 32-bit types) with different FFT libraries, so
the figures agree to float32 FFT rounding, not bit for bit: the near-field
SNR of ~69 dB is a noise power of ~1e-7 of the signal's, which rounding of
that order moves by ~1e-3 dB.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch.examples import warming_up_aperture, warming_up_asm, warming_up_resnet
from learned_hologram_gan_tpu_torch.tools import perceptual_study
from test_torch_tools import REPO, one_torch_thread  # noqa: F401


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_warming_up_asm_matches_jax_example(capsys):
    got = warming_up_asm.main(["--quick", "--device", "cpu"])
    assert "all assertions passed" in capsys.readouterr().out
    jex = _jax_example("warming_up_asm")
    n, oversample, s = 512, 64, 512 * 2.0  # the --quick configuration
    want = []
    for n_s in (0.5, 10.0, 100.0, 400.0):
        truth = jex.as_1d(1.0, n_s * s, n, oversample=oversample)
        want.append((n_s, jex.snr_db(truth, jex.as_1d(1.0, n_s * s, n)),
                     jex.snr_db(truth, jex.as_1d(1.0, n_s * s, n, band_limit=True))))
    assert [r[0] for r in got["rows"]] == [r[0] for r in want]
    np.testing.assert_allclose(np.asarray(got["rows"])[:, 1:], np.asarray(want)[:, 1:], rtol=0, atol=1e-2)
    outs = jex.compare_2d(n=128)
    want_diff = float(np.mean(np.abs(outs[True] - outs[False])))
    np.testing.assert_allclose(got["diff_2d"], want_diff, rtol=1e-4)


def _jax_tone_fractions():
    """The JAX aperture example's two figures, computed as it computes them
    (its ``main`` only prints them, to 4 decimals)."""
    n, length, cycles = 256, 1e-3, 20
    x = np.linspace(-length / 2, length / 2, n, endpoint=False)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    field = np.sin(cycles * 2 * np.pi * xx / length) * np.sin(cycles * 2 * np.pi * yy / length)
    aperture = (np.sqrt(xx**2 + yy**2) <= 0.1 * length).astype(np.float32)
    c, tone_mask = n // 2, np.zeros((n, n), bool)
    for sx in (-cycles, cycles):
        for sy in (-cycles, cycles):
            tone_mask[c + sx - 1: c + sx + 2, c + sy - 1: c + sy + 2] = True
    out = []
    for f in (field, field * aperture):
        e = np.abs(np.asarray(jnp.fft.fftshift(jnp.fft.fft2(jnp.asarray(f))))) ** 2
        out.append(float(e[tone_mask].sum() / e.sum()))
    return out


def test_warming_up_aperture_matches_jax_example(capsys):
    got = warming_up_aperture.main(["--device", "cpu"])
    assert "all assertions passed" in capsys.readouterr().out
    np.testing.assert_allclose([got["plain"], got["aperture"]], _jax_tone_fractions(), rtol=1e-4)


@pytest.mark.slow
def test_warming_up_resnet_example(capsys):
    got = warming_up_resnet.main(["--device", "cpu", "--steps", "60"])
    assert "all assertions passed" in capsys.readouterr().out
    assert got["accuracy"] > 0.6


def test_strided_residual_block_matches_flax():
    """The ResNet example's downsampling block: ``ResidualBlock(strides=2)``
    with a 1x1 shortcut, train mode, on an odd and an even input, against
    flax's (the SAME padding's extra row and column at the high end)."""
    import jax

    from learned_hologram_gan_tpu.nn import blocks as jblocks
    from learned_hologram_gan_tpu_torch import convert
    from learned_hologram_gan_tpu_torch.nn import blocks
    from test_torch_models import jax_variables, to_jax

    rng = np.random.default_rng(91)
    for size in (9, 8):
        x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
        jm = jblocks.ResidualBlock(5, use_1x1conv=True, strides=2)
        v = jax_variables(jm, jnp.asarray(x), train=True)
        want, _ = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(to_jax(v), jnp.asarray(x))
        m = blocks.ResidualBlock(3, 5, use_1x1conv=True, strides=2).train()
        m.load_state_dict(convert.generator_state_dict(v))
        got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert got.shape[-1] == (size + 1) // 2
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="identity shortcut"):
        blocks.ResidualBlock(3, 3, strides=2)


@pytest.mark.parametrize("module", [warming_up_asm, warming_up_aperture, warming_up_resnet, perceptual_study],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_refuses_cuda_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_perceptual_study_runs_both_arms(capsys, monkeypatch):
    """Both arms, shortened to 4 steps (one metrics interval): finite
    figures, the perceptual term 0 without it and positive with it."""
    monkeypatch.setattr(perceptual_study, "run", functools.partial(perceptual_study.run, steps=4))
    got = perceptual_study.main(["--device", "cpu"])
    runs = got["runs"]
    assert set(runs) == {"none", "random"}
    for run in runs.values():
        assert np.isfinite([run["final_PSNR"], run["final_SSIM"], run["final_pixel_loss"]]).all()
        assert len(run["PSNR_trajectory"]) == 1
    assert runs["none"]["final_perceptual_loss"] == 0 < runs["random"]["final_perceptual_loss"]
    assert set(got["random_minus_none"]) == {"PSNR", "SSIM", "pixel_loss"}
    assert '"random_minus_none"' in capsys.readouterr().out
