"""The port's ``quality_run`` (``learned_hologram_gan_tpu_torch/tools``)
against the JAX package's ``tools/quality_run.py``, both run in-process on
tiny seeded bins on the CPU (16 x 16, UNet base 2).

* Arguments: with the trainer, the two pretrain functions and the
  evaluation replaced by recorders (nothing trains), the ``Watermelon(...)``
  and ``.train(...)`` keyword arguments, the pretrain calls' and the
  evaluation's argv are equal in both tools (paths relative to ``--out``,
  the port's ``--device`` left out), and every loader hands out the same
  batches, bit for bit, for the default route, ``--streaming --start_epoch
  1 --data_dtype bfloat16`` and ``--resident_shards 2``.  The GAN stage's
  random draws differ between the packages (JAX keys, torch generators),
  which is why its arguments are held here and not its numbers.
* ``stage_resume``: on copies of one directory of epoch files and ``.done``
  sidecars, both tools load the same file, write the same sidecar, delete
  the same files and skip a complete stage.
* Stages 1 and 2 end to end from the same seeded initial variables: the
  stage histories within rtol 1e-4 (tests/test_torch_pretrain.py's bound
  for an epoch's losses: a few Adam steps through float32 convs and FFTs).
* The port alone: a chunked ``--streaming`` run in two calls, the second
  resuming, with a finite evaluation summary.
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from learned_hologram_gan_tpu_torch import convert, highres_smoke
from learned_hologram_gan_tpu_torch.tools import quality_run
from learned_hologram_gan_tpu_torch.train import flax_msgpack
from test_torch_tools import _read, _run_jax, one_torch_thread, patch_jax_init  # noqa: F401

ROWS = COLS = 16
TRAIN, VAL = 8, 4


@pytest.fixture
def data(tmp_path):
    d = str(tmp_path / "data")
    highres_smoke._write_split(d, "train", TRAIN, ROWS, COLS, 40)
    highres_smoke._write_split(d, "val", VAL, ROWS, COLS, 41)
    return d


def _argv(data, out, extra=()):
    return ["--data", data, "--out", out, "--rows", str(ROWS), "--cols", str(COLS), "--pad_size", "8",
            "--num_planes", "5", "--unet_base_features", "2", "--train_num", str(TRAIN), "--val_num",
            str(VAL), "--perceptual", "none", "--dtype", "float32", *extra]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def _epochs(loader, n):
    """``n`` epochs of a loader callable, each batch's fields as float32
    numpy arrays (bfloat16 widens exactly)."""
    return [[tuple(_np(f) for f in batch) for batch in loader()] for _ in range(n)]


def _touch(path):
    with open(path, "wb"):
        pass


def _done(save_path):
    p = os.path.splitext(save_path)[0] + ".done"
    return _read(p) if os.path.exists(p) else None


class _Recorder:
    """The calls one tool makes, in order: (name, arguments)."""

    def __init__(self, summary=None):
        self.calls = []
        self.summary = summary

    def stage(self, name, train, val, kw, weights):
        self.calls.append((name, dict(kw, train=_epochs(train, 2), val=_epochs(val, 1),
                                      done=_done(kw["save_path"]), weights=weights)))
        _touch(kw["save_path"])  # the GAN stage then finds the part files

    def trainer(self):
        calls = self.calls

        class Trainer:
            def __init__(self, **kw):
                kw.pop("device", None)
                calls.append(("Watermelon", kw))

            def train(self, **kw):
                kw["data_loader_train"] = _epochs(kw["data_loader_train"], 2)
                kw["data_loader_val"] = _epochs(kw["data_loader_val"], 1)
                if "visualization_RGBD_AP" in kw:
                    kw["visualization_RGBD_AP"] = tuple(_np(a) for a in kw["visualization_RGBD_AP"])
                calls.append(("train", kw))
                return {}

        return Trainer

    def evaluation(self, argv):
        argv = list(argv)
        if "--device" in argv:
            del argv[argv.index("--device"):argv.index("--device") + 2]
        self.calls.append(("eval_quality", argv))
        if self.summary is not None:  # what the evaluation would write
            run_dir = argv[argv.index("--run_dir") + 1]
            os.makedirs(os.path.join(run_dir, "eval"), exist_ok=True)
            with open(os.path.join(run_dir, "eval", "summary.json"), "w") as f:
                json.dump(self.summary(run_dir), f)


def _jax_recorded(monkeypatch, argv):
    """The JAX tool's calls with its trainer, pretrain functions and
    evaluation subprocess recorded."""
    from learned_hologram_gan_tpu import train as jtrain
    from learned_hologram_gan_tpu.models import AP2POH as JaxAP2POH
    from learned_hologram_gan_tpu.models import RGBD2AP as JaxRGBD2AP

    rec = _Recorder()
    patch_jax_init(monkeypatch, JaxRGBD2AP)
    patch_jax_init(monkeypatch, JaxAP2POH)

    def rgbd2ap(model, params, batch_stats, train, val, **kw):
        rec.stage("train_rgbd2ap", train, val, kw, {"params": params, "batch_stats": batch_stats})
        return params, batch_stats, [1.0], [0.5]

    def ap2poh(model, plan, params, train, val, **kw):
        rec.stage("train_ap2poh", train, val, kw, {"params": params, "batch_stats": {}})
        return params, {}, [1.0], [0.5]

    run = subprocess.run

    def fake_run(cmd, *a, **kw):
        if "tools/eval_quality.py" not in cmd:
            return run(cmd, *a, **kw)
        rec.evaluation(cmd[2:])

    monkeypatch.setattr(jtrain, "train_rgbd2ap", rgbd2ap)
    monkeypatch.setattr(jtrain, "train_ap2poh", ap2poh)
    monkeypatch.setattr(jtrain, "Watermelon", rec.trainer())
    monkeypatch.setattr(subprocess, "run", fake_run)
    _run_jax(monkeypatch, "quality_run", argv)
    monkeypatch.undo()
    return rec.calls


def _port_recorded(monkeypatch, argv, **patches):
    rec = _Recorder()

    def rgbd2ap(model, train, val, **kw):
        rec.stage("train_rgbd2ap", train, val, kw, model)
        return model, [1.0], [0.5]

    def ap2poh(model, plan, train, val, **kw):
        rec.stage("train_ap2poh", train, val, kw, model)
        return model, [1.0], [0.5]

    with monkeypatch.context() as mp:
        mp.setattr(quality_run, "train_rgbd2ap", rgbd2ap)
        mp.setattr(quality_run, "train_ap2poh", ap2poh)
        mp.setattr(quality_run, "Watermelon", rec.trainer())
        mp.setattr(quality_run.eval_quality, "main", rec.evaluation)
        for name, value in patches.items():
            mp.setattr(quality_run, name, value)
        quality_run.main(argv + ["--device", "cpu"])
    return rec.calls


def _relative(value, out):
    if isinstance(value, str):
        return value.replace(out, "<out>")
    if isinstance(value, (list, tuple)):
        return type(value)(_relative(v, out) for v in value)
    if isinstance(value, dict):
        return {k: _relative(v, out) for k, v in value.items()}
    return value


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=where)
    else:
        assert got == want, (where, got, want)


def _assert_calls_equal(got, want, port_out, jax_out):
    assert [c[0] for c in got] == [c[0] for c in want]
    for (name, g), (_, w) in zip(got, want):
        if name.startswith("train_"):
            g, w = dict(g), dict(w)
            g.pop("weights"), w.pop("weights")
        _assert_same(_relative(g, port_out), _relative(w, jax_out), name)


ROUTES = {
    "device_resident": ["--stage1_epochs", "3", "--stage2_epochs", "2", "--gan_epochs", "2"],
    "streaming_start_epoch": ["--skip_stage1", "--skip_stage2", "--streaming", "--start_epoch", "1",
                              "--gan_epochs", "3", "--data_dtype", "bfloat16", "--val_batch", "3"],
    "resident_shards": ["--resident_shards", "2", "--stage1_epochs", "1", "--stage2_epochs", "1",
                        "--gan_epochs", "2", "--info_interval", "7"],
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_quality_run_arguments_match_jax_tool(tmp_path, monkeypatch, data, route):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    want = _jax_recorded(monkeypatch, _argv(data, jax_out, ROUTES[route]))
    got = _port_recorded(monkeypatch, _argv(data, port_out, ROUTES[route]))
    _assert_calls_equal(got, want, port_out, jax_out)
    names = [c[0] for c in got]
    assert names[-3:] == ["Watermelon", "train", "eval_quality"]
    if route != "streaming_start_epoch":
        assert names[:2] == ["train_rgbd2ap", "train_ap2poh"]
    train_kw = dict(got)["train"]
    assert all(len(epoch) == 2 for epoch in train_kw["data_loader_train"] if route != "resident_shards")
    assert all(len(epoch) > 0 for epoch in train_kw["data_loader_train"] + train_kw["data_loader_val"])
    assert train_kw["resume_dir"] == os.path.join(port_out, "resume")
    assert train_kw["resume_data_fast_forward"] == (route != "streaming_start_epoch")
    assert _read(os.path.join(port_out, "timings.json"))["total_s"] >= 0


def _stage_tree(module_cls, *args, seed):
    """Seeded numpy variables of a JAX stage model's tree."""
    from test_torch_models import jax_variables

    return jax_variables(module_cls, *args, seed=seed)


def test_stage_resume_matches_jax_tool(tmp_path, monkeypatch, data):
    """Stage 1 resumes from its newest epoch file (by mtime, not by index)
    after 3 epochs recorded in its sidecar: both tools load that file, write
    ``done`` 3 + k + 1, delete every stage-1 epoch file and train the
    remaining epochs with the epoch seed moved on; stage 2 is complete
    (its sidecar says so) and neither trains nor touches its files."""
    import jax.numpy as jnp

    from learned_hologram_gan_tpu.config import GeneratorConfig as JaxGenConfig
    from learned_hologram_gan_tpu.models import AP2POH as JaxAP2POH
    from learned_hologram_gan_tpu.models import RGBD2AP as JaxRGBD2AP
    from learned_hologram_gan_tpu.models import make_generator_plan as jax_gen_plan

    base = tmp_path / "base"
    base.mkdir()
    trees = {k: _stage_tree(JaxRGBD2AP(base_features=2, dtype=jnp.float32), jnp.zeros((1, 4, ROWS, COLS)),
                            seed=50 + k) for k in (0, 1, 4)}
    for k, mtime in ((0, 2_000), (4, 1_000), (1, 3_000)):  # epoch 1 is the newest
        p = str(base / f"rgbd2ap_epoch{k}.msgpack")
        flax_msgpack.write_file(p, trees[k])
        os.utime(p, (mtime, mtime))
    with open(base / "rgbd2ap.done", "w") as f:
        json.dump({"done": 3}, f)
    plan = jax_gen_plan(JaxGenConfig(rows=ROWS, cols=COLS, pad_size=8))
    amp0 = jnp.zeros((1, 3, ROWS, COLS))
    stage2 = _stage_tree(JaxAP2POH(kernel_size=3), plan, amp0, amp0, seed=60)
    stage2 = {"params": stage2["params"], "batch_stats": {}}
    for name in ("ap2poh.msgpack", "ap2poh_epoch1.msgpack"):
        flax_msgpack.write_file(str(base / name), stage2)
    with open(base / "ap2poh.done", "w") as f:
        json.dump({"done": 4}, f)

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    shutil.copytree(base, jax_out)
    shutil.copytree(base, port_out)
    extra = ["--stage1_epochs", "10", "--stage2_epochs", "4", "--skip_gan", "--skip_eval"]
    want = _jax_recorded(monkeypatch, _argv(data, jax_out, extra))
    got = _port_recorded(monkeypatch, _argv(data, port_out, extra))
    _assert_calls_equal(got, want, port_out, jax_out)
    assert [c[0] for c in got] == ["train_rgbd2ap"]
    kw = got[0][1]
    assert kw["epochs"] == 10 - (3 + 2) and kw["done"] == {"done": 5}
    # the loaded weights: the newest file's, in both
    jax_weights = {k: {n: np.asarray(v) for n, v in _flatten(t).items()}
                   for k, t in want[0][1]["weights"].items()}
    assert {k: set(v) for k, v in jax_weights.items()} == {k: set(_flatten(v)) for k, v in trees[1].items()}
    for k, leaves in _flatten(trees[1]["params"]).items():
        np.testing.assert_array_equal(jax_weights["params"][k], leaves)
    port_sd = kw["weights"].state_dict()
    for k, v in convert.generator_state_dict(trees[1]).items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(port_sd[k], v), k
    for out in (jax_out, port_out):
        assert sorted(os.listdir(out)) == sorted(["ap2poh.done", "ap2poh.msgpack", "ap2poh_epoch1.msgpack",
                                                  "rgbd2ap.done", "rgbd2ap.msgpack", "stage1_history.json", "timings.json"])
        assert _read(os.path.join(out, "rgbd2ap.done")) == {"done": 10}
        with open(os.path.join(out, "ap2poh.msgpack"), "rb") as f, open(base / "ap2poh.msgpack", "rb") as g:
            assert f.read() == g.read()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_stages_match_jax_tool(tmp_path, monkeypatch, data):
    """Stage 1 (2 epochs) and stage 2 (2 epochs) of both tools from the same
    seeded initial variables: the histories within rtol 1e-4, the written
    part files of the same trees."""
    from learned_hologram_gan_tpu.models import AP2POH as JaxAP2POH
    from learned_hologram_gan_tpu.models import RGBD2AP as JaxRGBD2AP

    from learned_hologram_gan_tpu_torch.models import AP2POH, RGBD2AP

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    extra = ["--stage1_epochs", "2", "--stage2_epochs", "2", "--skip_gan", "--skip_eval"]
    initial = {}
    with monkeypatch.context() as mp:
        for cls, name, seed in ((JaxRGBD2AP, "stage1", 70), (JaxAP2POH, "stage2", 71)):
            patch_jax_init(mp, cls, seed=seed, record=initial.setdefault(name, []))
        _run_jax(mp, "quality_run", _argv(data, jax_out, extra))

    def loaded(cls, variables, **kw):
        def make(args, device):
            model = cls(**kw)
            model.load_state_dict(convert.generator_state_dict(variables))
            return model.to(device)
        return make

    (v1,), (v2,) = initial["stage1"], initial["stage2"]
    with monkeypatch.context() as mp:
        mp.setattr(quality_run, "make_rgbd2ap", loaded(RGBD2AP, v1, base_features=2))
        mp.setattr(quality_run, "make_ap2poh", loaded(AP2POH, {"params": v2["params"]}, kernel_size=3))
        got = quality_run.main(_argv(data, port_out, extra) + ["--device", "cpu"])
    for stage in ("stage1", "stage2"):
        want = _read(os.path.join(jax_out, f"{stage}_history.json"))
        hist = _read(os.path.join(port_out, f"{stage}_history.json"))
        assert hist == got["histories"][stage]
        for split in ("train", "val"):
            assert len(hist[split]) == 2
            np.testing.assert_allclose(hist[split], want[split], rtol=1e-4, err_msg=f"{stage} {split}")
    for name in ("rgbd2ap.msgpack", "ap2poh.msgpack"):
        a = flax_msgpack.read_file(os.path.join(port_out, name))
        b = flax_msgpack.read_file(os.path.join(jax_out, name))
        assert {k: v.shape for k, v in _flatten(a).items()} == {k: v.shape for k, v in _flatten(b).items()}


def test_quality_run_streaming_chunked(tmp_path, data, capsys):
    """The chunked streaming workflow (tests/test_cli.py's JAX test, on the
    port): two calls share one --out; the second resumes without data
    replay and ends with a finite evaluation."""
    out = str(tmp_path / "q")
    common = _argv(data, out, ["--skip_stage1", "--skip_stage2", "--streaming", "--batch_size", "4",
                               "--val_batch", "2", "--pad_size", "4"]) + ["--device", "cpu"]
    first = quality_run.main(common + ["--gan_epochs", "1", "--start_epoch", "0", "--skip_eval"])
    assert first["evaluation"] is None and first["memory"] is None
    assert os.path.exists(os.path.join(out, "resume", "history.json"))
    capsys.readouterr()
    second = quality_run.main(common + ["--gan_epochs", "2", "--start_epoch", "1"])
    assert "Resumed training" in capsys.readouterr().out
    summary = _read(os.path.join(out, "eval", "summary.json"))
    assert summary == second["evaluation"]["summary"]
    assert np.isfinite(summary["val_PSNR"]) and len(summary["per_plane_PSNR"]) == 5
    assert set(_read(os.path.join(out, "timings.json"))) == {"gan_s", "eval_s", "total_s"}


def test_quality_run_refuses_streaming_pretrain_and_absent_card(tmp_path, data):
    with pytest.raises(SystemExit, match="stage 3 only"):
        quality_run.main(_argv(data, str(tmp_path / "q"), ["--streaming"]) + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            quality_run.main(_argv(data, str(tmp_path / "q")))
    assert quality_run.build_parser().parse_args([]).out == "output/quality_run_torch"
