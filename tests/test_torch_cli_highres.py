"""``training_model``'s high-resolution flags (``--remat``, ``--no_cache_h``,
``--device_resident_data``) against ``trainingModel.py`` with the same
flags, in-process on the CPU.

Both CLIs start from the same JAX-written generator (``--pretrained_G``)
on the same bins (16 x 16, the CLIs' pad 320: a 656 x 656 grid, the
composable branch), train one non-GAN step at batch 4 and write the
generator as ``.msgpack``.  For the comparison both take SGD in place of
Adam at ``--lr_G 1`` (so the update reads back the gradient) and the
port takes JAX's distance draw, recomputed from the JAX state's key.

Tolerances: the step gates of tests/test_torch_train.py (gradients within
1e-2 of the largest |g|, BatchNorm statistics rtol 1e-4); and each flag's
port run writes the same bytes as the port's run without it (the same
float32 math on the CPU).
"""

import importlib.util
import os

import jax
import numpy as np
import optax
import pytest
import torch

from learned_hologram_gan_tpu_torch import training_model
from learned_hologram_gan_tpu_torch.train import flax_msgpack, steps
from test_torch_cli import REPO, _jax_training_parser, _write_training_bins
from test_torch_tools import one_torch_thread, patch_jax_generator_init  # noqa: F401

SEED = 122731  # both CLIs' (reference trainingModel.py:18)
DISTANCES = 20  # both CLIs' stack, linspace(-4e-4, 0, 21)[:-1]
BATCH = 4
FLAGS = ["--remat", "--no_cache_h", "--device_resident_data"]


def _common(tmp, out):
    return _write_training_bins(tmp) + [
        "--save_path_G", str(out / "G.msgpack"), "--save_path_D", str(out / "D.msgpack"),
        "--loss_metrics_file", str(out / "history.json"), "--save_path_img", str(out / "imgs"),
        "--unet_base_features", "2", "--epoch_num", "1", "--perceptual", "none", "--lr_G", "1.0",
        "--batch_size", str(BATCH), "--pretrained_G", str(tmp / "G_init.msgpack"),
    ]


def _jax_draw():
    """The first train step's distance indices of the JAX CLI's state
    (train/state.py: the state key is split off the seed's key; the step
    splits it again)."""
    key, _, _ = jax.random.split(jax.random.key(SEED), 3)
    _, dist_key, _ = jax.random.split(key, 3)
    return torch.from_numpy(np.array(jax.random.permutation(dist_key, DISTANCES)[:BATCH]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX CLI with all three flags, and the port's CLI without them."""
    from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
    from learned_hologram_gan_tpu.models import Generator as JaxGenerator
    from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
    from learned_hologram_gan_tpu.train import checkpoint as jckpt
    from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
    from test_torch_models import jax_variables

    tmp = tmp_path_factory.mktemp("cli_highres")
    cfg = JaxGenConfig(rows=16, cols=16, pad_size=320, unet_base_features=2)
    v = jax_variables(JaxGenerator(cfg), jax_gen_plan(cfg), jax.numpy.zeros((1, 4, 16, 16)), seed=41, train=False)
    jckpt.save_generator(JaxTrainState(step=0, key=None, params_G=v["params"], batch_stats_G=v["batch_stats"],
                                       params_D=None, batch_stats_D=None, opt_state_G=None, opt_state_D=None,
                                       vgg_params=None), str(tmp / "G_init.msgpack"))
    spec = importlib.util.spec_from_file_location("trainingModel", os.path.join(REPO, "trainingModel.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(optax, "adam", optax.sgd)
        patch_jax_generator_init(mp)  # --pretrained_G replaces the init
        cli.train_gan(_jax_training_parser().parse_args(_common(tmp, tmp / "jax") + FLAGS))
    with pytest.MonkeyPatch.context() as mp:
        _port_setup(mp)
        training_model.main(_common(tmp, tmp / "plain") + ["--device", "cpu"])
    return tmp


def _port_setup(mp):
    mp.setattr(torch.optim, "Adam", torch.optim.SGD)
    draw = steps.draw_step_randoms

    def jax_draw(state, multi_plan, batch_size, ratio):
        _, alphas = draw(state, multi_plan, batch_size, ratio)
        return _jax_draw(), alphas

    mp.setattr(steps, "draw_step_randoms", jax_draw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _flat(v, f"{prefix}{k}/")
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f.lstrip("-"))
def test_training_model_runs_the_highres_flag_as_jax_does(runs, monkeypatch, flag):
    tmp = runs
    _port_setup(monkeypatch)
    trainer, _ = training_model.main(_common(tmp, tmp / flag.lstrip("-")) + ["--device", "cpu", flag])
    if flag == "--remat":
        assert trainer.gen_config.remat and trainer.generator.part1.unet.remat
    if flag == "--no_cache_h":
        assert trainer.gen_plan.H is None and trainer.multi_plan.H is None
    assert trainer.state.step == 1

    path = tmp / flag.lstrip("-") / "G.msgpack"
    with open(path, "rb") as f, open(tmp / "plain" / "G.msgpack", "rb") as g:
        assert f.read() == g.read()

    init = _flat(flax_msgpack.read_file(str(tmp / "G_init.msgpack")))
    got = _flat(flax_msgpack.read_file(str(path)))
    want = _flat(flax_msgpack.read_file(str(tmp / "jax" / "G.msgpack")))
    assert set(got) == set(want) == set(init)
    params = [k for k in init if k.startswith("params/")]
    grad = {k: init[k] - got[k] for k in params}  # SGD at lr 1
    jgrad = {k: init[k] - want[k] for k in params}
    scale = max(np.abs(g).max() for g in jgrad.values())
    assert scale > 0
    for k in params:
        assert np.abs(grad[k] - jgrad[k]).max() <= 1e-2 * scale, k
    for k in init:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
