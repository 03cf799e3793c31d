"""The port's four-step GEMM FFT (``ops/mxu_fft.py``) and the FFT backend
switch of its ``ops/asm.py``, against the JAX package on the CPU.

The shapes and tolerances are ``tests/test_mxu_fft.py``'s: 2e-5 of
max |want| forward, 1e-5 absolute for the inverse and the round trip,
1e-4 for a prime size (the ``torch.fft`` / ``jnp.fft`` fallback).  Inputs
are seeded numpy arrays handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.ops import asm as jasm
from learned_hologram_gan_tpu.ops import mxu_fft as jmxu
from learned_hologram_gan_tpu_torch.config import OpticsConfig
from learned_hologram_gan_tpu_torch.ops import asm, mxu_fft


def _rand_c(seed, *shape):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) + 1j * rng.random(shape)).astype(np.complex64)


@pytest.mark.parametrize("n", [4, 12, 13, 36, 100, 1000, 1024, 1280, 768, 5000])
def test_best_factor_pair_matches_jax(n):
    assert mxu_fft.best_factor_pair(n) == jmxu.best_factor_pair(n)


def test_best_factor_pair():
    assert mxu_fft.best_factor_pair(1024) == (32, 32)
    assert mxu_fft.best_factor_pair(1000) == (25, 40)
    assert mxu_fft.best_factor_pair(12) == (3, 4)
    assert mxu_fft.best_factor_pair(13) is None


@pytest.mark.parametrize("n,inverse", [(6, False), (40, True), (1280, False)])
def test_tables_match_jax(n, inverse):
    """The DFT matrices and twiddles, built in float64 and rounded, bit for
    bit the JAX package's."""
    for got, want in zip(mxu_fft._dft_mats(n, inverse), jmxu._dft_mats(n, inverse)):
        np.testing.assert_array_equal(got, want)
    n1, n2 = mxu_fft.best_factor_pair(n)
    for got, want in zip(mxu_fft._twiddle(n1, n2, inverse), jmxu._twiddle(n1, n2, inverse)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (1, 64, 48), (2, 3, 36, 100)])
def test_fft2_mxu_matches_jax_and_torch(shape):
    x = _rand_c(61, *shape)
    got = mxu_fft.fft2_mxu(torch.from_numpy(x)).numpy()
    scale = np.max(np.abs(np.fft.fft2(x)))
    np.testing.assert_allclose(got, np.asarray(jmxu.fft2_mxu(jnp.asarray(x))), atol=2e-5 * scale)
    np.testing.assert_allclose(got, torch.fft.fft2(torch.from_numpy(x)).numpy(), atol=2e-5 * scale)


def test_ifft2_mxu_matches_jax_and_torch():
    x = _rand_c(62, 2, 3, 40, 60)
    got = mxu_fft.ifft2_mxu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmxu.ifft2_mxu(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(got, torch.fft.ifft2(torch.from_numpy(x)).numpy(), atol=1e-5)


def test_roundtrip():
    x = _rand_c(63, 1, 3, 48, 48)
    rt = mxu_fft.ifft2_mxu(mxu_fft.fft2_mxu(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(rt, x, atol=1e-5)


def test_prime_size_falls_back():
    x = _rand_c(64, 1, 13, 13)
    got = mxu_fft.fft2_mxu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.fft.fft2(jnp.asarray(x))), atol=1e-4)


def test_fft2_mxu_gradient_matches_torch_fft():
    """The GEMM FFT is differentiable: its gradient is torch.fft's."""
    x = torch.from_numpy(_rand_c(65, 2, 12, 20)).requires_grad_(True)
    g = torch.from_numpy(_rand_c(66, 2, 12, 20))
    (got,) = torch.autograd.grad(mxu_fft.fft2_mxu(x), x, g)
    (want,) = torch.autograd.grad(torch.fft.fft2(x), x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5 * float(want.abs().max()))


@pytest.fixture
def restore_backend():
    yield
    asm.set_fft_backend("auto")


def test_backend_names_match_jax(restore_backend):
    """set/get/_resolved_backend with the JAX package's four names; an
    unknown name raises in both; "auto" is torch.fft (``xla``) on the CPU
    and K3 (``pallas``) on a CUDA device."""
    assert asm.get_fft_backend() == jasm.get_fft_backend() == "auto"
    for name in ("xla", "mxu", "pallas", "auto"):
        asm.set_fft_backend(name)
        assert asm.get_fft_backend() == name
    for mod in (asm, jasm):
        with pytest.raises(ValueError):
            mod.set_fft_backend("cufft")
    assert asm._resolved_backend(torch.device("cpu")) == jasm._resolved_backend() == "xla"
    assert asm._resolved_backend(torch.device("cuda")) == "pallas"
    asm.set_fft_backend("mxu")
    assert asm._resolved_backend(torch.device("cuda")) == "mxu"


def test_pallas_backend_refuses_a_cpu_tensor(restore_backend):
    """"pallas" names kernels K1 and K3: on a CPU tensor it raises, and
    never runs torch.fft or K1's plain version under their name."""
    asm.set_fft_backend("pallas")
    x = torch.zeros((1, 3, 16, 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA"):
        asm._fft2(x)
    with pytest.raises(ValueError, match="CUDA"):
        asm._ifft2(x)
    optics = OpticsConfig(rows=16, cols=16, pad_size=8)
    plan = asm.make_plan(optics, distances=[1e-3], device="cpu")
    amp = torch.ones((1, 3, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        asm.propagate(plan, amp, torch.zeros_like(amp))


@pytest.mark.parametrize("backend", ["xla", "mxu"])
def test_propagation_on_each_backend_matches_jax(restore_backend, backend):
    """propagate_batch_multi (the focal stack) under the same backend in
    both packages: the composable chain on torch.fft or the GEMM FFT, no
    fused K1, against the JAX package's; tolerance of
    tests/test_torch_asm_serving.py (1e-3 at p99.9, 4e-3 worst)."""
    rows, cols, pad = 16, 24, 8
    dists = np.linspace(4e-4, 1e-3, 3)
    optics = OpticsConfig(rows=rows, cols=cols, pad_size=pad)
    plan = asm.make_plan(optics, distances=dists, device="cpu")
    from learned_hologram_gan_tpu.config import OpticsConfig as JOptics

    jplan = jasm.make_plan(JOptics(rows=rows, cols=cols, pad_size=pad), distances=dists)
    rng = np.random.default_rng(3)
    amp = rng.random((2, 3, rows, cols)).astype(np.float32)
    phs = (2 * np.pi * rng.random((2, 3, rows, cols))).astype(np.float32)
    asm.set_fft_backend(backend)
    assert not asm._fused_ok(plan)
    got_a = asm.propagate_batch_multi(plan, torch.from_numpy(amp), torch.from_numpy(phs))
    jasm.set_fft_backend(backend)
    try:
        want_a = jasm.propagate_batch_multi(jplan, jnp.asarray(amp), jnp.asarray(phs))
    finally:
        jasm.set_fft_backend("auto")
    err = np.abs(got_a.numpy() - np.asarray(want_a)).ravel()
    assert np.quantile(err, 0.999) <= 1e-3 and err.max() <= 4e-3
