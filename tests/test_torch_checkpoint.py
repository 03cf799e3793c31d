"""The port's checkpoints against flax and the JAX package, on the CPU.

* ``train/flax_msgpack.py`` against ``flax.serialization`` (msgpack-python
  underneath) on generated trees and on the four ``output/quality_run``
  files: the same trees out, the same bytes in, byte for byte.
* ``train/checkpoint.py``'s per-network layer against the JAX package's:
  files the port writes are the bytes the JAX package writes for the same
  variables and load in its ``load_generator`` / ``load_discriminator``;
  ``load_generator_part`` loads both parts as the JAX package does.
* The full-state layer: save, restore and prune, and a kill-and-restart
  resume of the trainer bitwise equal to an uninterrupted run, after
  ``tests/test_train.py::test_resume_kill_restart``.
* ``freeze_part1`` pins part 1's parameters while part 2 and the critic
  move and part 1's BatchNorm statistics keep updating; a resume under the
  other setting is a named error (after ``tests/test_train.py:409, 449``).

Every comparison here is exact: no arithmetic separates the two sides.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
from learned_hologram_gan_tpu.models import Generator as JaxGenerator
from learned_hologram_gan_tpu.models import WGANGPDiscriminator192 as JaxCritic
from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan
from learned_hologram_gan_tpu.train import checkpoint as jckpt
from learned_hologram_gan_tpu.train.state import TrainState as JaxTrainState
from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig, LossConfig
from learned_hologram_gan_tpu_torch.models import Generator
from learned_hologram_gan_tpu_torch.models.discriminator import WGANGPDiscriminator192
from learned_hologram_gan_tpu_torch.train import Watermelon, build_train_step
from learned_hologram_gan_tpu_torch.train import checkpoint as ckpt_lib
from learned_hologram_gan_tpu_torch.train import flax_msgpack as fm
from learned_hologram_gan_tpu_torch.train.state import TrainState, create_train_state
from test_torch_models import jax_variables, to_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITY_RUN = os.path.join(REPO, "output", "quality_run")
QUALITY_FILES = ["generator", "rgbd2ap", "ap2poh", "discriminator"]
SMALL = dict(rows=32, cols=32, pad_size=16, filter_radius_coefficient=0.45,
             unet_base_features=4, distance=1e-3)


def assert_same_tree(got, want, path=""):
    """Equal trees: the same keys in the same order, leaves of the same
    type; arrays of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


def _tree(kind: str):
    rng = np.random.default_rng(len(kind))
    if kind == "ranks":
        return {f"r{n}": rng.standard_normal((3, 2, 4, 5)[:n]).astype(np.float32) for n in range(5)}
    if kind == "dtypes":
        return {"f32": rng.standard_normal((7, 3)).astype(np.float32),
                "i32": rng.integers(-2**31, 2**31 - 1, (4, 4), dtype=np.int32),
                "f64": rng.standard_normal(5), "u8": rng.integers(0, 255, 300, dtype=np.uint8),
                "empty": np.zeros((0, 3), np.float32)}
    if kind == "empty_maps":
        return {"params": {"modulation": {"w": np.ones(3, np.float32)}}, "batch_stats": {},
                "z": {"a": {}, "b": {"c": {}}}}
    if kind == "scalars":
        ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63, -1, -32, -33,
                -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
        return {"ints": {str(i): n for i, n in enumerate(ints)}, "floats": {"a": 1.5, "b": -0.0,
                "c": 1e300}, "none": None, "flags": {"t": True, "f": False}, "c": 1 - 2j,
                "np": {"f": np.float32(2.5), "i": np.int32(-3)}, "s": "x" * 40, "t": "y" * 300}
    if kind == "wide":
        # more than 15 keys (map16), long keys (str8), 70000-byte array bodies (ext32)
        return {("k" * 40 + str(i)): rng.standard_normal(i + 1).astype(np.float32)
                for i in range(20)} | {"big": rng.standard_normal(17500).astype(np.float32)}
    raise KeyError(kind)


TREES = ["ranks", "dtypes", "empty_maps", "scalars", "wide"]


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


@pytest.mark.parametrize("kind", TREES)
def test_codec_matches_flax_on_generated_trees(kind):
    """``encode`` writes flax's bytes for the tree as it stands, and
    ``to_bytes`` flax's bytes for it with its keys sorted, as the JAX
    package's checkpoint writer sorts them (through ``jax.device_get``);
    ``decode`` reads flax's tree (key order, types, values) back, and
    re-encodes it to the same bytes."""
    tree = _tree(kind)
    assert fm.encode(tree) == serialization.to_bytes(tree)
    want = serialization.to_bytes(_sorted(tree))
    assert fm.to_bytes(tree) == want
    got = fm.decode(want)
    assert_same_tree(got, serialization.msgpack_restore(want))
    assert fm.encode(got) == want


def test_codec_chunks_arrays_as_flax(monkeypatch):
    """Arrays over the chunk size go in flax's chunked form, and come back
    whole (the size lowered on both sides so the test stays small)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", 64)
    tree = {"s": np.ones(3, np.float32), "w": np.arange(50, dtype=np.float32).reshape(5, 10)}
    want = serialization.to_bytes(tree)
    assert fm.to_bytes(tree) == want
    assert_same_tree(fm.decode(want), serialization.msgpack_restore(want))
    assert_same_tree(fm.decode(want), tree)


def test_codec_refuses_bad_input():
    with pytest.raises(ValueError, match="truncated"):
        fm.decode(serialization.to_bytes({"a": np.ones(3, np.float32)})[:-2])
    with pytest.raises(ValueError, match="after the msgpack value"):
        fm.decode(b"\x80\x80")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        fm.decode(serialization.to_bytes({"a": jnp.ones(3, jnp.bfloat16)}))
    with pytest.raises(TypeError, match="cannot serialize"):
        fm.encode({"a": object()})
    with pytest.raises(ValueError, match="extension type 9"):
        fm.decode(b"\xd4\x09\x00")  # fixext 1 of an unknown type


def _quality_file(name):
    path = os.path.join(QUALITY_RUN, f"{name}.msgpack")
    if not os.path.exists(path):
        pytest.skip(f"{path} is not in this checkout")
    with open(path, "rb") as f:
        return path, f.read()


@pytest.mark.parametrize("name", QUALITY_FILES)
def test_quality_run_files_decode_as_flax(name):
    """The port reads each in-repo flax file to the tree flax reads: the
    same keys in the file's order (``batch_stats: {}`` kept in AP2POH's),
    the same float32 arrays bit for bit."""
    path, data = _quality_file(name)
    want = serialization.msgpack_restore(data)
    got = fm.read_file(path)
    assert_same_tree(got, want)
    assert set(got) == {"params", "batch_stats"}
    top = {"generator": {"part1", "part2"}, "rgbd2ap": {"unet"}, "ap2poh": {"modulation"},
           "discriminator": None}[name]
    if top is not None:
        assert set(got["params"]) == top
    if name == "ap2poh":
        assert got["batch_stats"] == {}


@pytest.mark.parametrize("name", QUALITY_FILES)
def test_quality_run_files_reencode_to_their_bytes(name):
    """Decode then encode gives each file's bytes back (msgpack-python's
    packb(unpackb(b)) == b holds for all four), and so does the walk
    flax -> port module -> flax for the two networks."""
    path, data = _quality_file(name)
    tree = fm.decode(data)
    assert fm.encode(tree) == data
    assert fm.to_bytes(tree) == data
    if name in ("generator", "discriminator"):
        module = (Generator(GeneratorConfig(rows=16, cols=16)) if name == "generator"
                  else WGANGPDiscriminator192(feature_d=32))
        ckpt_lib.load_weights(path, module)
        assert fm.to_bytes(convert.flax_variables(module)) == data


# ---------------------------------------------------------------------------
# Per-network files against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """Seeded flax variables of the small generator and critic, the port's
    modules carrying them, and a JAX TrainState holding them."""
    jcfg = JaxGenConfig(**SMALL)
    rgbd = jnp.zeros((1, 4, 32, 32), jnp.float32)
    vg = jax_variables(JaxGenerator(jcfg), jax_gen_plan(jcfg), rgbd, train=False, seed=41)
    vd = jax_variables(JaxCritic(feature_d=2), jnp.zeros((1, 3, 32, 32)), train=False, seed=42)
    g = Generator(GeneratorConfig(**SMALL))
    g.load_state_dict(convert.generator_state_dict(vg))
    d = WGANGPDiscriminator192(2)
    d.load_state_dict(convert.discriminator_state_dict(vd))
    jstate = JaxTrainState(step=0, key=None, params_G=to_jax(vg["params"]),
                           batch_stats_G=to_jax(vg["batch_stats"]), params_D=to_jax(vd["params"]),
                           batch_stats_D=to_jax(vd["batch_stats"]), opt_state_G=None,
                           opt_state_D=None, vgg_params=None)
    state = TrainState(step=0, generator=g, discriminator=d, opt_G=None, opt_D=None,
                       rng=torch.Generator())
    return dict(vg=vg, vd=vd, jstate=jstate, state=state)


def _zeroed(jstate):
    zero = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    return jstate.replace(params_G=zero(jstate.params_G), batch_stats_G=zero(jstate.batch_stats_G),
                          params_D=zero(jstate.params_D), batch_stats_D=zero(jstate.batch_stats_D))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_port_writes_what_the_jax_package_writes(carried, tmp_path):
    """``save_generator`` / ``save_discriminator`` to ``.msgpack``: the
    JAX package's bytes for the same variables, loaded by its
    ``load_generator`` / ``load_discriminator`` to the carried arrays."""
    state, jstate = carried["state"], carried["jstate"]
    for net, save, jsave, jload, key in (
        ("G", ckpt_lib.save_generator, jckpt.save_generator, jckpt.load_generator, "vg"),
        ("D", ckpt_lib.save_discriminator, jckpt.save_discriminator, jckpt.load_discriminator, "vd"),
    ):
        ours, theirs = str(tmp_path / f"{net}.msgpack"), str(tmp_path / f"{net}_jax.msgpack")
        save(state, ours)
        jsave(jstate, theirs)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), net
        loaded = jload(_zeroed(jstate), ours)
        params, stats = ((loaded.params_G, loaded.batch_stats_G) if net == "G"
                         else (loaded.params_D, loaded.batch_stats_D))
        want = carried[key]
        for a, b in zip(jax.tree_util.tree_leaves(_host(params)), jax.tree_util.tree_leaves(want["params"])):
            assert np.array_equal(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(_host(stats)), jax.tree_util.tree_leaves(want["batch_stats"])):
            assert np.array_equal(a, b)


def test_port_reads_what_the_jax_package_writes(carried, tmp_path):
    """A ``.msgpack`` the JAX package writes loads into fresh port modules
    to the carried state, and torch paths keep the ``state_dict`` format."""
    jstate = carried["jstate"]
    jckpt.save_generator(jstate, str(tmp_path / "G.msgpack"))
    jckpt.save_discriminator(jstate, str(tmp_path / "D.msgpack"))
    fresh = TrainState(step=0, generator=Generator(GeneratorConfig(**SMALL)),
                       discriminator=WGANGPDiscriminator192(2), opt_G=None, opt_D=None,
                       rng=torch.Generator())
    ckpt_lib.load_generator(fresh, str(tmp_path / "G.msgpack"))
    ckpt_lib.load_discriminator(fresh, str(tmp_path / "D.msgpack"))
    for a, b in ((fresh.generator, carried["state"].generator),
                 (fresh.discriminator, carried["state"].discriminator)):
        want = b.state_dict()
        for k, v in a.state_dict().items():
            assert torch.equal(v, want[k]), k
    ckpt_lib.save_generator(fresh, str(tmp_path / "G.pt"))
    assert set(torch.load(tmp_path / "G.pt", weights_only=True)) == set(fresh.generator.state_dict())


@pytest.mark.parametrize("part", ["part1", "part2"])
def test_load_generator_part_matches_jax(carried, tmp_path, part):
    """A stage file, as the pretraining stages write it (part 1: ``unet``
    params and statistics; part 2: ``modulation`` params, ``batch_stats:
    {}``), loads into one part of a fresh generator in both packages, the
    other part untouched."""
    vg, jstate = carried["vg"], carried["jstate"]
    path = str(tmp_path / f"{part}.msgpack")
    jckpt._write(path, {"params": vg["params"][part], "batch_stats": vg["batch_stats"].get(part, {})})
    jloaded = jckpt.load_generator_part(_zeroed(jstate), path, part)

    fresh = Generator(GeneratorConfig(**SMALL))
    with torch.no_grad():
        for t in fresh.state_dict().values():
            t.zero_()
    state = TrainState(step=0, generator=fresh, discriminator=None, opt_G=None, opt_D=None,
                       rng=torch.Generator())
    ckpt_lib.load_generator_part(state, path, part)
    got = convert.flax_variables(fresh)
    assert_same_tree(got["params"], _host(jloaded.params_G))
    assert_same_tree(got["batch_stats"], _host(jloaded.batch_stats_G))


def test_load_generator_part_skips_an_ablation_stub(tmp_path, capsys):
    """use_modulation=False leaves part 2 without parameters: the load is
    skipped with the JAX package's warning."""
    g = Generator(GeneratorConfig(**dict(SMALL, use_modulation=False)))
    state = TrainState(step=0, generator=g, discriminator=None, opt_G=None, opt_D=None,
                       rng=torch.Generator())
    ckpt_lib.load_generator_part(state, str(tmp_path / "absent.msgpack"), "part2")
    assert "ablation stub" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# Full-state checkpoints
# ---------------------------------------------------------------------------

TINY = dict(filter_radius_coefficient=0.45, pad_size=4,
            distance_stack=np.linspace(-4e-4, 0.0, 5)[:-1], input_shape=(2, 4, 16, 16),
            use_gan=True, perceptual="none", unet_base_features=2, feature_d=2, device="cpu")


def tiny_trainer(**kw):
    return Watermelon(**{**TINY, **kw})


def synthetic_batches(n_batches=2, batch=2, seed=9):
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.random((batch, c, 16, 16), dtype=np.float32)) for c in (4, 3, 3))
            for _ in range(n_batches)]


def _stepped_state(seed, batches, **kw):
    """A trainer's state after one GAN step per batch (Adam state and BN
    statistics non-trivial)."""
    trainer = tiny_trainer(**kw)
    trainer._init_state(seed, 1e-3, 1e-3)
    step = build_train_step(LossConfig(perceptual="none"), True, 1, 10.0)
    for batch in batches:
        step(trainer.state, batch, trainer.gen_plan, trainer.multi_plan)
    return trainer


def _tensors(state: TrainState) -> dict:
    out = {f"G.{k}": v for k, v in state.generator.state_dict().items()}
    out |= {f"D.{k}": v for k, v in state.discriminator.state_dict().items()}
    for name, opt in (("opt_G", state.opt_G), ("opt_D", state.opt_D)):
        for i, s in opt.state_dict()["state"].items():
            out |= {f"{name}.{i}.{k}": v for k, v in s.items()}
    out["rng"] = state.rng.get_state()
    return out


def assert_states_equal(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step
    ta, tb = _tensors(a), _tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k
    assert a.opt_G.state_dict()["param_groups"] == b.opt_G.state_dict()["param_groups"]


@pytest.mark.parametrize("wait", [True, False])
def test_full_state_round_trip(tmp_path, wait):
    """save_train_state -> restore_train_state into a state built from
    another seed gives back every tensor bit for bit (both nets with their
    BatchNorm buffers, both Adam states, the draws' generator, the step),
    finalized under ``step_{n}`` with no temporary left behind."""
    trainer = _stepped_state(3, synthetic_batches(2))
    path = ckpt_lib.save_train_state(trainer.state, str(tmp_path), wait=wait)
    ckpt_lib.wait_for_saves()
    assert os.path.basename(path) == "step_2" and os.listdir(tmp_path) == ["step_2"]
    other = _stepped_state(4, synthetic_batches(1, seed=10))
    restored = ckpt_lib.restore_latest(str(tmp_path), other.state)
    assert restored is other.state
    assert_states_equal(restored, trainer.state)
    assert torch.equal(torch.rand(3, generator=restored.rng), torch.rand(3, generator=trainer.state.rng))
    assert ckpt_lib.restore_latest(str(tmp_path / "none"), other.state) is None


def test_prune_checkpoints(tmp_path):
    """keep=n keeps the n newest step directories (by step, not by name);
    keep=0 deletes every one; other entries stay."""
    for n in (1, 2, 10, 3):
        os.makedirs(tmp_path / f"step_{n}")
    os.makedirs(tmp_path / "step_x")
    ckpt_lib.prune_checkpoints(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_10", "step_3", "step_x"]
    assert ckpt_lib.latest_step_dir(str(tmp_path)).endswith("step_10")
    ckpt_lib.prune_checkpoints(str(tmp_path), keep=0)
    assert os.listdir(tmp_path) == ["step_x"]
    assert ckpt_lib.latest_step_dir(str(tmp_path)) is None
    with pytest.raises(ValueError, match="keep"):
        ckpt_lib.prune_checkpoints(str(tmp_path), keep=-1)
    ckpt_lib.prune_checkpoints(str(tmp_path / "absent"))


def _epoch_loader(batches, start=0):
    """2 batches an epoch, the same on every run (keyed off a counter)."""
    counter = {"epoch": start}

    def loader():
        e = counter["epoch"] % 2
        counter["epoch"] += 1
        return iter(batches[2 * e:2 * e + 2])

    return loader


# validation and the history record every 2 steps, at each epoch's end: a
# record's train averages then span steps of one run, as they do in the
# uninterrupted one
RESUME = dict(info_print_interval=2, checkpoint_iterval=1, discriminator_train_ratio=1, seed=7)


@pytest.mark.parametrize("fast_forward", [True, False], ids=["fast_forward", "chunked"])
def test_resume_kill_restart(tmp_path, fast_forward):
    """Kill-and-restart with resume_dir is bitwise the uninterrupted run:
    train 1 epoch into resume_dir, then a fresh trainer resumes to 2
    epochs, either fast-forwarding the loader past the trained batches or
    (chunked) starting at epoch 1 with the loader positioned there.  The
    history carries over."""
    batches = synthetic_batches(4)
    val = lambda: iter(batches[:1])
    full = tiny_trainer()
    hist_full = full.train(data_loader_train=_epoch_loader(batches), data_loader_val=val,
                           epoch_num=2, **RESUME)

    resume_dir = str(tmp_path / "resume")
    tiny_trainer().train(data_loader_train=_epoch_loader(batches), data_loader_val=val,
                         epoch_num=1, resume_dir=resume_dir, **RESUME)
    assert ckpt_lib.latest_step_dir(resume_dir).endswith("step_2")
    with open(os.path.join(resume_dir, "meta.json")) as f:
        assert json.load(f) == {"freeze_part1": False}

    again = tiny_trainer()
    extra = {} if fast_forward else dict(start_epoch=1, resume_data_fast_forward=False)
    hist = again.train(data_loader_train=_epoch_loader(batches, 0 if fast_forward else 1),
                       data_loader_val=val, epoch_num=2, resume_dir=resume_dir, **RESUME, **extra)
    assert again.state.step == full.state.step == 4
    assert_states_equal(again.state, full.state)
    assert hist == hist_full and hist["n_batch"] == [2, 4]
    assert sorted(os.listdir(resume_dir)) == ["history.json", "meta.json", "step_2", "step_4"]


def test_freeze_part1_pins_part1_while_part2_and_D_move():
    """freeze_part1 (reference RGBD2AP.py:37-41): part 1's parameters stay
    bit for bit over three GAN steps, Adam holds no state for them, part 2
    and the critic move, and part 1's BatchNorm running statistics keep
    updating in train mode, as in the JAX package."""
    trainer = tiny_trainer(freeze_part1=True)
    trainer._init_state(3, 1e-3, 1e-3)
    g = trainer.state.generator
    part1 = {id(p) for p in g.part1.parameters()}
    assert not any(id(p) in part1 for grp in trainer.state.opt_G.param_groups for p in grp["params"])
    snap = lambda m: {k: v.detach().clone() for k, v in m.state_dict().items()}
    before = dict(part1=snap(g.part1), part2=snap(g.part2), D=snap(trainer.state.discriminator))
    step = build_train_step(LossConfig(perceptual="none"), True, 2, 10.0)
    for batch in synthetic_batches(3):
        step(trainer.state, batch, trainer.gen_plan, trainer.multi_plan)
    after = dict(part1=snap(g.part1), part2=snap(g.part2), D=snap(trainer.state.discriminator))
    params1 = {k for k, _ in g.part1.named_parameters()}
    for k in params1:
        assert torch.equal(before["part1"][k], after["part1"][k]), k
    assert any(not torch.equal(before["part1"][k], after["part1"][k])
               for k in before["part1"] if k.endswith("running_mean"))
    for net in ("part2", "D"):
        assert any(not torch.equal(before[net][k], after[net][k]) for k in before[net]), net


def test_unfrozen_part1_moves():
    """Control for the freeze test: by default one step moves part 1."""
    trainer = tiny_trainer()
    trainer._init_state(3, 1e-3, 1e-3)
    before = {k: v.detach().clone() for k, v in trainer.state.generator.part1.named_parameters()}
    build_train_step(LossConfig(perceptual="none"), True, 1, 10.0)(
        trainer.state, synthetic_batches(1)[0], trainer.gen_plan, trainer.multi_plan)
    assert any(not torch.equal(v, dict(trainer.state.generator.part1.named_parameters())[k])
               for k, v in before.items())


def test_resume_freeze_part1_mismatch_is_a_named_error(tmp_path):
    """A resume_dir stamped under the other freeze_part1 setting raises an
    error naming the flag; the same setting is accepted."""
    resume_dir = str(tmp_path / "resume")
    common = dict(data_loader_train=lambda: iter([]), data_loader_val=lambda: iter([]),
                  epoch_num=0, resume_dir=resume_dir)
    tiny_trainer().train(**common)
    assert os.path.exists(os.path.join(resume_dir, "meta.json"))
    with pytest.raises(ValueError, match="freeze_part1"):
        tiny_trainer(freeze_part1=True).train(**common)
    tiny_trainer().train(**common)


def test_create_train_state_freeze_builds_opt_over_part2():
    """``create_train_state(freeze_part1=True)``: opt_G over the generator's
    parameters outside part 1 only, which alone require gradients."""
    from learned_hologram_gan_tpu_torch.config import DiscriminatorConfig
    from learned_hologram_gan_tpu_torch.train.state import build_modules

    g, d = build_modules(GeneratorConfig(**SMALL), DiscriminatorConfig(feature_d=2), True)
    state = create_train_state(0, g, d, 1e-3, 1e-3, "cpu", freeze_part1=True)
    opt_params = [p for grp in state.opt_G.param_groups for p in grp["params"]]
    assert [id(p) for p in opt_params] == [id(p) for p in g.part2.parameters()]
    assert all(not p.requires_grad for p in g.part1.parameters())
