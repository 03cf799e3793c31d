"""The port's entry points on the CPU: the generate_poh and training_model
CLIs, the PNG writer, checkpoints, the data loader, the import graph, and
chip_smoke.py's refusal to run without a card."""

import json
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu_torch import card_check, convert, generate_poh, training_model
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


def test_generate_poh_reads_the_jax_packages_msgpack(tmp_path, capsys):
    """--model_path G.msgpack written by the JAX package's save_generator:
    the CLI loads it and gives the JAX generator's POH for the sample."""
    from learned_hologram_gan_tpu.train import checkpoint as jckpt
    from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState

    paths = _write_bins(tmp_path)
    jcfg = JaxGenConfig(rows=H, cols=W, pad_size=16, filter_radius_coefficient=0.45,
                        unet_base_features=2)
    jplan = jax_gen_plan(jcfg)
    jgen = JaxGenerator(jcfg)
    x = jnp.asarray(ImgDepthDataset(paths["img"], paths["depth"], samples_num=3, height=H, width=W)[2])[None]
    variables = jax_variables(jgen, jplan, x, seed=2, train=False)
    want = np.asarray(jax_apply(jgen, variables, jplan, x, train=False))[0]
    jstate = JaxTrainState(step=0, key=None, params_G=variables["params"],
                           batch_stats_G=variables["batch_stats"], params_D=None, batch_stats_D=None,
                           opt_state_G=None, opt_state_D=None, vgg_params=None)
    jckpt.save_generator(jstate, str(tmp_path / "G.msgpack"))

    generate_poh.main(_argv(tmp_path, paths, str(tmp_path / "G.msgpack")))
    assert f"Generator loaded from {tmp_path / 'G.msgpack'}" in capsys.readouterr().out
    got = np.load(tmp_path / "poh.npy")
    d = np.abs(np.exp(1j * got.astype(np.float64)) - np.exp(1j * want.astype(np.float64)))
    assert np.mean(d) <= 2e-3 and np.quantile(d, 0.99) <= 1e-2 and np.max(d) <= 5e-2


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


def test_card_check_bf16_on_cpu():
    """The bfloat16 card-vs-CPU checks, run with the CPU in both places:
    identical POHs and train steps, bfloat16 convolutions (and float32
    VGG19), and each check names what it misses."""
    stats = card_check.card_vs_cpu("cpu", dtype="bfloat16")
    assert stats["poh_gate"] == 0 and stats["conv_dtypes"] == ["torch.bfloat16"]
    card_check.check(dict(stats, k1_launches=2))
    with pytest.raises(AssertionError, match="computed in"):
        card_check.check(dict(stats, k1_launches=2, conv_dtypes=["torch.float32"]))
    stats = card_check.train_step_card_vs_cpu("cpu", dtype="bfloat16")
    assert stats["conv_dtypes"] == ["torch.bfloat16", "torch.float32"]
    assert stats["grad_G_rel"] == 0 and stats["grad_D_rel"] == 0
    card_check.check_train_step(dict(stats, k1_launches=2, k2_launches=2, k3_launches=6))
    with pytest.raises(AssertionError, match="computed in"):
        card_check.check_train_step(dict(stats, k1_launches=2, k2_launches=2, k3_launches=6,
                                         conv_dtypes=["torch.float32"]))


def test_train_step_card_check_on_cpu():
    """The train-step card-vs-CPU check with the CPU in both places:
    identical results, no TF32, no kernel launch, and check_train_step()
    names what it misses."""
    stats = card_check.train_step_card_vs_cpu("cpu")
    assert all(a == b for a, b in stats["metrics"].values())
    assert stats["grad_G_rel"] == 0 and stats["grad_D_rel"] == 0
    assert stats["convs_forward"] > 0 and stats["convs_backward"] > 0
    with pytest.raises(AssertionError, match="K1 did not launch"):
        card_check.check_train_step(stats)
    ran = dict(stats, k1_launches=2, k2_launches=2, k3_launches=6)
    card_check.check_train_step(ran)
    with pytest.raises(AssertionError, match="backward with TF32 on"):
        card_check.check_train_step(dict(ran, convs_backward_tf32=1))
    # float32: a critic running-mean excess the recorded cause does not explain
    with pytest.raises(AssertionError, match="moved apart by < lr/2"):
        card_check.check_train_step(dict(ran, stats_D_mean_unexplained=2e-5))


@pytest.mark.parametrize("option", [dict(two_h_hat=True), dict(critic_batching="separate"),
                                    dict(critic_batching="full")], ids=["two_h_hat", "separate", "full"])
def test_train_step_card_check_options_on_cpu(option):
    """The train-step card check with each step option, the CPU in both
    places: identical results, the critic's running means identical in
    every channel, and check_train_step() wants the two-H path's launches
    (K1 twice and K2 once in field+per_plane mode, no K3)."""
    stats = card_check.train_step_card_vs_cpu("cpu", **option)
    assert all(a == b for a, b in stats["metrics"].values())
    assert stats["grad_G_rel"] == 0 and stats["grad_D_rel"] == 0
    assert stats["stats_D_mean_over_1e5"] == [] and stats["stats_D_mean_unexplained"] == 0
    ran = dict(k1_launches=3, k2_launches=2, k3_launches=0, k1_modes={"conj_h": 1, "field+per_plane": 2},
               k2_modes={"conj_h": 1, "field+per_plane": 1})
    if not stats["two_h_hat"]:
        ran = dict(k1_launches=2, k2_launches=2, k3_launches=6)
    card_check.check_train_step(dict(stats, **ran))
    if stats["two_h_hat"]:
        with pytest.raises(AssertionError, match="K3 launched 6 times on the two-H path"):
            card_check.check_train_step(dict(stats, **dict(ran, k3_launches=6)))
        with pytest.raises(AssertionError, match="K1 launched 1 times in mode field"):
            card_check.check_train_step(dict(stats, **dict(ran, k1_modes={"field+per_plane": 1})))


def test_stage2_card_check_on_cpu():
    """The stage-2 card-vs-CPU check, run with the CPU in both places:
    identical loss and gradients, no kernel launch (the CPU takes the plain
    versions), and the check names the launches it misses."""
    stats = card_check.stage2_step_card_vs_cpu("cpu")
    assert stats["loss"][0] == stats["loss"][1] and stats["grad_rel"] == 0
    with pytest.raises(AssertionError, match="K3 launched 0 times, want 12"):
        card_check.check_stage2_step(stats)
    ran = dict(k1_modes={"conj_h": 1}, k3_launches=12)
    card_check.check_stage2_step(dict(stats, **ran))
    with pytest.raises(AssertionError, match="K2 launched 1 times"):
        card_check.check_stage2_step(dict(stats, **ran, k2_launches=1))
    with pytest.raises(AssertionError, match="grad_rel"):
        card_check.check_stage2_step(dict(stats, **dict(ran, grad_rel=0.5)))


def test_generate_poh_refuses_what_is_not_ported(tmp_path):
    """Flax checkpoints, --dtype bfloat16 and --mesh_devices, refused before
    they were ported, now load and run (a .msgpack without flax variables,
    an empty map, is named as such): --mesh_devices 2 starts two gloo
    ranks, each with its half of the 4 distances, and rank 0's POH and
    focal stack are the one-process run's (the planes within 1e-6, the JAX
    package's distance-sharding bound)."""
    paths = _write_bins(tmp_path)
    (tmp_path / "G.msgpack").write_bytes(b"\x80")
    with pytest.raises(ValueError, match="holds no flax variables"):
        generate_poh.main(_argv(tmp_path, paths, str(tmp_path / "G.msgpack")))
    stack = ["--propagate", "--num_intervals", "4", "--output_image_dir", str(tmp_path / "recon")]
    whole = generate_poh.main(_argv(tmp_path, paths, "none.pt", stack))
    sharded = generate_poh.main(_argv(tmp_path, paths, "none.pt", stack + ["--mesh_devices", "2"]))
    torch.testing.assert_close(sharded["poh"], whole["poh"], rtol=0, atol=0)
    np.testing.assert_allclose(sharded["focal_stack"].numpy(), whole["focal_stack"].numpy(), atol=1e-6)
    assert sharded["png_paths"] == whole["png_paths"] and len(whole["png_paths"]) == 4
    with pytest.raises(RuntimeError, match="do not split into 2 ranks"):
        generate_poh.main(_argv(tmp_path, paths, "none.pt", ["--propagate", "--num_intervals", "3",
                                                             "--mesh_devices", "2"]))
    poh = generate_poh.main(_argv(tmp_path, paths, "none.pt", ["--dtype", "bfloat16"]))["poh"]
    assert poh.dtype == torch.float32 and torch.isfinite(poh).all()
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


# ---------------------------------------------------------------------------
# training_model
# ---------------------------------------------------------------------------


def _write_training_bins(tmp_path, hw=16, n_train=4):
    rng = np.random.default_rng(18)
    argv = []
    for split, n in (("train", n_train), ("validate", 100)):  # the CLI reads 100 validation samples
        for name in ("img", "depth", "amp", "phs"):
            p = str(tmp_path / f"{split}_{name}.bin")
            rng.random((n, 3, hw, hw)).astype(np.float32).tofile(p)
            argv += [f"--{split}_{name}_path", p]
    return argv + ["--samplesNum", str(n_train), "--channlesNum", "3",
                   "--height", str(hw), "--width", str(hw)]


def _train_argv(tmp_path, extra=()):
    out = tmp_path / "out"
    return _write_training_bins(tmp_path) + [
        "--save_path_G", str(out / "G.pt"), "--save_path_D", str(out / "D.pt"),
        "--loss_metrics_file", str(out / "history.json"), "--save_path_img", str(out / "imgs"),
        "--unet_base_features", "2", "--epoch_num", "1", "--device", "cpu", *extra,
    ]


def test_training_model_cpu_writes_checkpoints_history_and_pngs(tmp_path, capsys):
    """One GAN epoch of one step at 16 x 16 (the CLI's pad 320 gives a
    656 x 656 grid: the composable path) on the CPU."""
    trainer, history = training_model.main(_train_argv(tmp_path, ["--use_gan", "--perceptual", "none"]))
    out = capsys.readouterr().out
    assert "Generator saved to" in out and "visualization saved at epoch 0" in out
    names = set(os.listdir(tmp_path / "out"))
    assert {"G.pt", "D.pt", "G_epoch0.pt", "D_epoch0.pt", "history.json", "imgs"} <= names
    sd = torch.load(tmp_path / "out" / "G.pt", weights_only=True)
    assert set(sd) == set(trainer.state.generator.state_dict())
    torch.testing.assert_close(sd["part1.unet.enc_0.Conv_0.weight"],
                               trainer.state.generator.part1.unet.enc_0.Conv_0.weight.detach())
    sd_d = torch.load(tmp_path / "out" / "D.pt", weights_only=True)
    assert "BatchNorm_4.running_var" in sd_d
    with open(tmp_path / "out" / "history.json") as f:
        hist = json.load(f)
    # the JAX package's key layout (train/watermelon.py:history)
    from learned_hologram_gan_tpu.train.watermelon import LOSS_KEYS, METRIC_KEYS

    assert set(hist) == {"epoch", "n_batch_in_epoch", "n_train", "n_batch", "train_losses_tensor",
                         "train_metrics_tensor", "validate_losses_tensor", "validate_metrics_tensor"}
    assert set(hist["train_losses_tensor"]) == set(LOSS_KEYS)
    assert set(hist["validate_metrics_tensor"]) == set(METRIC_KEYS)
    assert sorted(os.listdir(tmp_path / "out" / "imgs")) == ["amp_hat in epoch 0.png", "phs_hat in epoch 0.png"]
    assert trainer.state.step == 1
    for p in trainer.state.discriminator.parameters():
        assert torch.isfinite(p).all()


@pytest.mark.parametrize("extra", [["--two_h_hat"], ["--critic_batching", "separate"],
                                   ["--critic_batching", "full"]],
                         ids=["two_h_hat", "separate", "full"])
def test_training_model_cpu_runs_the_step_options(tmp_path, extra):
    """The train step's options through the CLI at 16 x 16 (656 x 656 grid:
    the composable two-H branch): one step, the checkpoints of both nets
    and the history, as the default step writes them, and finite weights."""
    trainer, history = training_model.main(_train_argv(tmp_path, ["--use_gan", "--perceptual", "none", *extra]))
    assert (trainer.two_h_hat, trainer.critic_batching) == (
        "--two_h_hat" in extra, extra[1] if "--critic_batching" in extra else "pair")
    assert trainer.state.step == 1
    names = set(os.listdir(tmp_path / "out"))
    assert {"G.pt", "D.pt", "G_epoch0.pt", "D_epoch0.pt", "history.json", "imgs"} <= names
    for name, net in (("G.pt", trainer.state.generator), ("D.pt", trainer.state.discriminator)):
        sd = torch.load(tmp_path / "out" / name, weights_only=True)
        assert set(sd) == set(net.state_dict())
        assert all(torch.isfinite(p).all() for p in net.parameters())
    with open(tmp_path / "out" / "history.json") as f:
        assert set(json.load(f)) == set(history)
    assert all(np.isfinite(v).all() for v in history["train_losses_tensor"].values())


def test_training_model_cpu_bfloat16(tmp_path):
    """training_model --use_gan --dtype bfloat16 on the CPU: the UNet and the
    critic compute in bfloat16, their parameters and Adam's state stay
    float32, and the step's losses and weights come out finite."""
    trainer, history = training_model.main(_train_argv(
        tmp_path, ["--use_gan", "--perceptual", "none", "--dtype", "bfloat16"]))
    state = trainer.state
    assert state.step == 1
    assert state.generator.part1.unet.enc_0.Conv_0.compute_dtype == torch.bfloat16
    assert state.discriminator.Conv_0.compute_dtype == torch.bfloat16
    for net in (state.generator, state.discriminator):
        for p in net.parameters():
            assert p.dtype == torch.float32 and torch.isfinite(p).all()
    for opt in (state.opt_G, state.opt_D):
        assert all(s["exp_avg"].dtype == torch.float32 for s in opt.state.values())
    assert all(np.isfinite(v).all() for v in history["train_losses_tensor"].values())
    sd = torch.load(tmp_path / "out" / "G.pt", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64) for v in sd.values())


def test_generate_poh_cpu_bfloat16_matches_jax(tmp_path):
    """generate_poh --dtype bfloat16 on carried weights against the JAX
    bfloat16 generator, with the JAX package's bfloat16 POH gate (5e-2,
    tests/test_fused_unet.py:83) on the phasors; the focal stack runs."""
    paths = _write_bins(tmp_path)
    jcfg = JaxGenConfig(rows=H, cols=W, pad_size=16, filter_radius_coefficient=0.45,
                        unet_base_features=2, dtype="bfloat16")
    jplan = jax_gen_plan(jcfg)
    jgen = JaxGenerator(jcfg)
    rgbd = ImgDepthDataset(paths["img"], paths["depth"], samples_num=3, height=H, width=W)[2]
    x = jnp.asarray(rgbd)[None]
    variables = jax_variables(jgen, jplan, x, seed=2, train=False)
    want = np.asarray(jax_apply(jgen, variables, jplan, x, train=False))[0]
    torch.save(convert.generator_state_dict(variables), tmp_path / "G.pt")
    result = generate_poh.main(_argv(tmp_path, paths, str(tmp_path / "G.pt"), [
        "--dtype", "bfloat16", "--propagate", "--num_intervals", "3",
        "--output_image_dir", str(tmp_path / "recon")]))
    got = np.load(tmp_path / "poh.npy")
    d = np.abs(np.exp(1j * got.astype(np.float64)) - np.exp(1j * want.astype(np.float64)))
    assert np.max(d) <= 5e-2
    assert torch.isfinite(result["focal_stack"]).all()
    assert sorted(os.listdir(tmp_path / "recon")) == ["0.png", "1.png", "2.png"]


def test_trainer_records_history_like_jax(tmp_path):
    """The Watermelon loop on reusable loaders: the validation interval, the
    history counters and finite losses, as the JAX package's own test checks
    (tests/test_train.py::test_gan_training_runs_and_records_history)."""
    from learned_hologram_gan_tpu_torch.train import Watermelon
    from learned_hologram_gan_tpu_torch.train import checkpoint as ckpt

    rng = np.random.default_rng(19)

    def batches(n):
        return [tuple(torch.from_numpy(rng.random((2, c, 16, 16)).astype(np.float32)) for c in (4, 3, 3))
                for _ in range(n)]

    trainer = Watermelon(filter_radius_coefficient=0.45, pad_size=8,
                         distance_stack=np.linspace(-4e-4, 0.0, 5)[:-1], input_shape=(2, 4, 16, 16),
                         use_gan=True, perceptual="none", unet_base_features=2, feature_d=2, device="cpu")
    train, val = batches(2), batches(1)
    hist = trainer.train(lambda: iter(train), lambda: iter(val), epoch_num=2, info_print_interval=2,
                         info_plot_interval=1000, checkpoint_iterval=1, discriminator_train_ratio=2,
                         save_path_G=str(tmp_path / "G.pt"), save_path_D=str(tmp_path / "D.pt"),
                         loss_metrics_file=str(tmp_path / "hist.json"))
    assert hist["n_batch"] == [2, 4] and hist["n_train"] == [4, 8]
    for k in ("focal_phase_gradient_loss", "G_loss", "D_loss"):
        assert len(hist["train_losses_tensor"][k]) == 2
        assert np.isfinite(hist["train_losses_tensor"][k]).all()
    assert hist["validate_losses_tensor"]["D_loss"] == [0.0, 0.0]
    assert os.path.exists(tmp_path / "G_epoch1.pt") and os.path.exists(tmp_path / "D.pt")
    # per-network checkpoints load back into a fresh trainer's state
    other = Watermelon(filter_radius_coefficient=0.45, pad_size=8,
                       distance_stack=np.linspace(-4e-4, 0.0, 5)[:-1], input_shape=(2, 4, 16, 16),
                       use_gan=True, perceptual="none", unet_base_features=2, feature_d=2, device="cpu",
                       pretrained_model_path_G=str(tmp_path / "G.pt"),
                       pretrained_model_path_D=str(tmp_path / "D.pt"))
    other._init_state(1, 1e-3, 1e-3)
    for a, b in zip(trainer.state.generator.state_dict().values(), other.state.generator.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ckpt.epoch_path("a/G.pth", 3) == "a/G_epoch3.pth"


def _jax_training_parser():
    """trainingModel.py's parser, built by its own code (it lives under the
    script's __main__ guard)."""
    import argparse
    import ast

    src = open(os.path.join(REPO, "trainingModel.py")).read()
    main = next(n for n in ast.parse(src).body if isinstance(n, ast.If))
    body = [n for n in main.body if not (isinstance(n, ast.Expr) and isinstance(n.value, ast.Call)
                                          and getattr(n.value.func, "id", "") == "train_gan")]
    scope = {"argparse": argparse}
    exec(compile(ast.Module(body=body, type_ignores=[]), "trainingModel.py", "exec"), scope)
    return scope["parser"]


def test_training_model_flag_parity():
    """Every trainingModel.py flag, with the same type, default, choices and
    required-ness, plus --device (default cuda)."""
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.type, a.default, tuple(a.choices or ()), a.required,
                         type(a).__name__) for a in parser._actions if a.dest != "help"}

    jax_flags, port_flags = table(_jax_training_parser()), table(training_model.build_parser())
    assert set(port_flags) - set(jax_flags) == {"device"}
    for dest, want in jax_flags.items():
        assert port_flags[dest] == want, dest
    assert port_flags["device"][2] == "cuda"


# --remat, --no_cache_h and --device_resident_data run: tests/test_torch_cli_highres.py
UNPORTED_TRAINING_FLAGS = [
    ["--mesh_devices", "2"], ["--spatial_mesh_devices", "2"], ["--polyphase_level0"],
]


@pytest.mark.parametrize("extra", UNPORTED_TRAINING_FLAGS, ids=lambda e: e[0].lstrip("-"))
def test_training_model_refuses_what_is_not_ported(tmp_path, extra):
    """The flags refused before they were ported now run one GAN step:
    the two mesh flags start two gloo ranks (rank 0 writes the files and
    its history comes back), --polyphase_level0 trains the phase-domain
    UNet in-process.  What the JAX package refuses stays refused."""
    trainer, history = training_model.main(_train_argv(tmp_path, ["--use_gan", "--perceptual", "none", *extra]))
    if extra[0] == "--polyphase_level0":
        assert trainer.state.step == 1 and trainer.state.generator.part1.unet.polyphase_level0
    else:
        assert trainer is None
        assert set(history) == set(json.load(open(tmp_path / "out" / "history.json")))
    sd = torch.load(tmp_path / "out" / "G.pt", weights_only=True)
    assert "part1.unet.enc_0.Conv_0.weight" in sd and all(torch.isfinite(v).all() for v in sd.values())
    assert sorted(os.listdir(tmp_path / "out" / "imgs")) == ["amp_hat in epoch 0.png", "phs_hat in epoch 0.png"]
    if extra[0] == "--mesh_devices":
        with pytest.raises(SystemExit, match="--device_resident_data with --mesh_devices"):
            training_model.main(_train_argv(tmp_path, [*extra, "--device_resident_data"]))
        with pytest.raises(ValueError, match="pass one"):
            training_model.main(_train_argv(tmp_path, [*extra, "--spatial_mesh_devices", "2"]))


def _stage_files(tmp_path, hw=16, base=2):
    """Stage weights as the JAX package's pretraining writes them (seeded
    flax variables of RGBD2AP and AP2POH): part 1's with its statistics,
    part 2's with ``batch_stats: {}``."""
    from learned_hologram_gan_tpu.config import OpticsConfig as JaxOpticsConfig
    from learned_hologram_gan_tpu.models import AP2POH as JaxAP2POH
    from learned_hologram_gan_tpu.models import RGBD2AP as JaxRGBD2AP
    from learned_hologram_gan_tpu.ops import asm as jasm
    from learned_hologram_gan_tpu.train import checkpoint as jckpt

    x = jnp.zeros((1, 4, hw, hw))
    v1 = jax_variables(JaxRGBD2AP(base_features=base), x, seed=5)
    plan = jasm.make_plan(JaxOpticsConfig(rows=hw, cols=hw, pad_size=320), distances=[1e-3])
    v2 = jax_variables(JaxAP2POH(kernel_size=3), plan, x[:, :3], x[:, :3], seed=6)
    paths = str(tmp_path / "rgbd2ap.msgpack"), str(tmp_path / "ap2poh.msgpack")
    jckpt._write(paths[0], v1)
    jckpt._write(paths[1], {"params": v2["params"], "batch_stats": {}})
    return paths, v1, v2


def test_training_model_cpu_fine_tunes_from_stage_files_and_resumes(tmp_path, capsys):
    """The fine-tune stage through the CLI: --pretrained_part1/2 (the JAX
    package's stage files), --freeze_part1, .msgpack saves, --resume_dir.
    Run for 1 epoch, then again to 2 epochs from the same resume_dir: the
    second run resumes and ends bit for bit where an uninterrupted 2-epoch
    run ends; part 1 keeps the stage file's parameters; the saved
    generator loads in the JAX package."""
    from learned_hologram_gan_tpu.train import checkpoint as jckpt
    from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState

    (part1, part2), v1, v2 = _stage_files(tmp_path)
    out = tmp_path / "out"
    tune = ["--use_gan", "--perceptual", "none", "--pretrained_part1", part1, "--pretrained_part2", part2,
            "--freeze_part1", "--save_path_G", str(out / "G.msgpack"), "--save_path_D", str(out / "D.msgpack")]
    full, _ = training_model.main(_train_argv(tmp_path, tune) + ["--epoch_num", "2"])
    logs = capsys.readouterr().out
    assert "Generator part1 loaded from" in logs and "Generator part2 loaded from" in logs
    resume = ["--resume_dir", str(tmp_path / "resume")]
    training_model.main(_train_argv(tmp_path, tune + resume))
    again, _ = training_model.main(_train_argv(tmp_path, tune + resume) + ["--epoch_num", "2"])
    assert "Resumed training from" in capsys.readouterr().out
    assert again.state.step == full.state.step == 2
    for a, b in ((again.state.generator, full.state.generator),
                 (again.state.discriminator, full.state.discriminator)):
        want = b.state_dict()
        for k, v in a.state_dict().items():
            assert torch.equal(v, want[k]), k
    for a, b in zip(again.state.opt_G.state_dict()["state"].values(), full.state.opt_G.state_dict()["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    carried = convert.generator_state_dict(v1)
    for k, p in again.state.generator.part1.named_parameters():
        assert torch.equal(p.detach(), carried[k]), k
    assert sorted(os.listdir(tmp_path / "resume")) == ["history.json", "meta.json", "step_1", "step_2"]

    jtemplate = JaxTrainState(step=0, key=None, params_G={"part1": v1["params"], "part2": v2["params"]},
                              batch_stats_G={"part1": v1["batch_stats"]}, params_D=None,
                              batch_stats_D=None, opt_state_G=None, opt_state_D=None, vgg_params=None)
    loaded = jckpt.load_generator(jtemplate, str(out / "G.msgpack"))
    want = convert.flax_variables(again.state.generator)
    for a, b in zip(jax.tree_util.tree_leaves(loaded.params_G), jax.tree_util.tree_leaves(want["params"])):
        assert np.array_equal(np.asarray(a), b)


def test_batches_match_jax_loader(tmp_path):
    """Same seed, same shuffle: both CLIs draw the same batches."""
    from learned_hologram_gan_tpu.data import memmap as jmemmap
    from learned_hologram_gan_tpu_torch.data import ImgDepthAmpPhsDataset, batch_indices, epoch_loader

    for kw in (dict(shuffle=True, drop_last=True, seed=122732), dict(shuffle=False, drop_last=False)):
        got = [b.tolist() for b in batch_indices(10, 4, **kw)]
        assert got == [b.tolist() for b in jmemmap.batch_indices(10, 4, **kw)]
    argv = _write_training_bins(tmp_path, hw=8, n_train=5)
    paths = [argv[i + 1] for i in range(0, 8, 2)]
    ds = ImgDepthAmpPhsDataset(*paths, samples_num=5, height=8, width=8)
    jds = jmemmap.ImgDepthAmpPhsDataset(*paths, samples_num=5, height=8, width=8)
    batches = list(epoch_loader(ds, 2, shuffle=True, drop_last=True, seed=3, device="cpu"))
    assert len(batches) == 2
    for got, idx in zip(batches, jmemmap.batch_indices(5, 2, shuffle=True, drop_last=True, seed=3)):
        want = jmemmap.gather_batch(jds, idx)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    with pytest.raises(IndexError, match="Index out of range"):
        ds[5]


def test_training_model_defaults_to_cuda():
    args = training_model.build_parser().parse_args([
        "--train_img_path", "a", "--train_depth_path", "b", "--train_amp_path", "c",
        "--train_phs_path", "d", "--validate_img_path", "e", "--validate_depth_path", "f",
        "--validate_amp_path", "g", "--validate_phs_path", "h", "--samplesNum", "4",
        "--channlesNum", "3", "--height", "384", "--width", "384", "--save_path_G", "G",
        "--save_path_D", "D", "--loss_metrics_file", "m", "--save_path_img", "i"])
    assert args.device == "cuda"
    assert (args.batch_size, args.unet_base_features, args.critic_batching) == (4, 64, "pair")


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
