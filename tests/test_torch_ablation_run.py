"""The port's ``ablation_run`` (``learned_hologram_gan_tpu_torch/tools``)
against the JAX package's ``tools/ablation_run.py``, in-process on tiny
seeded bins on the CPU, with the trainer and the evaluation replaced by
recorders (nothing trains; the evaluation recorder writes a summary, as
the tool would): the same variants with the same overrides, the same
``Watermelon(...)`` / ``.train(...)`` arguments and evaluation argv for
each (paths relative to ``--out``, the port's ``--device`` left out), the
same batches from every loader, and ``ordering.json`` aggregated from the
summaries on disk as the JAX tool aggregates them.  Nothing here is
approximate: everything compared is exact.
"""

import json
import os

import pytest

from learned_hologram_gan_tpu_torch import highres_smoke
from learned_hologram_gan_tpu_torch.tools import ablation_run
from test_torch_quality_run import _assert_calls_equal, _Recorder
from test_torch_tools import _jax_tool, _read, _run_jax, one_torch_thread  # noqa: F401

ROWS = COLS = 16


def _summary(run_dir):
    """A summary that differs from variant to variant."""
    name = os.path.basename(run_dir)
    return {"val_PSNR": 10.0 + len(name) / 7, "val_SSIM": len(name) / 100, "per_plane_PSNR": [1.0]}


def _jax_recorded(monkeypatch, argv):
    import subprocess

    from learned_hologram_gan_tpu import train as jtrain

    rec = _Recorder(_summary)
    run = subprocess.run

    def fake_run(cmd, *a, **kw):
        if "tools/eval_quality.py" not in cmd:
            return run(cmd, *a, **kw)
        rec.evaluation(cmd[2:])

    with monkeypatch.context() as mp:
        mp.setattr(jtrain, "Watermelon", rec.trainer())
        mp.setattr(subprocess, "run", fake_run)
        _run_jax(mp, "ablation_run", argv)
    return rec.calls


def _port_recorded(monkeypatch, argv):
    rec = _Recorder(_summary)
    with monkeypatch.context() as mp:
        mp.setattr(ablation_run, "Watermelon", rec.trainer())
        mp.setattr(ablation_run.eval_quality, "main", rec.evaluation)
        result = ablation_run.main(argv + ["--device", "cpu"])
    return rec.calls, result


def test_variants_match_jax_tool():
    assert ablation_run.VARIANTS == _jax_tool("ablation_run").VARIANTS
    assert len(ablation_run.VARIANTS) == 7
    defaults = ablation_run.build_parser().parse_args([])
    assert (defaults.out, defaults.parts) == ("output/ablations_torch", "output/quality_run")


@pytest.mark.parametrize("variants", [None, ["without_GAN_without_modulation", "full_GAN"]],
                         ids=["all", "two_with_earlier_summaries"])
def test_ablation_run_matches_jax_tool(tmp_path, monkeypatch, variants):
    """Every variant (or two, into an ``--out`` that already holds other
    variants' summaries, which ``ordering.json`` must take in), from parts
    that exist: the recorded calls and ``ordering.json`` equal."""
    data, parts = str(tmp_path / "data"), str(tmp_path / "parts")
    highres_smoke._write_split(data, "train", 8, ROWS, COLS, 80)
    highres_smoke._write_split(data, "val", 4, ROWS, COLS, 81)
    os.makedirs(parts)
    for name in ("rgbd2ap.msgpack", "ap2poh.msgpack"):
        open(os.path.join(parts, name), "wb").close()
    outs = {}
    for tool in ("jax", "port"):
        outs[tool] = str(tmp_path / tool)
        if variants:  # earlier calls' variants, one with a summary and one without
            for name, summary in (("without_GAN", True), ("without_GAN_and_plain_phase_loss", False)):
                run_dir = os.path.join(outs[tool], name)
                os.makedirs(os.path.join(run_dir, "eval"))
                if summary:
                    with open(os.path.join(run_dir, "eval", "summary.json"), "w") as f:
                        json.dump(_summary(run_dir), f)
    argv = ["--data", data, "--parts", parts, "--epochs", "2", "--rows", str(ROWS), "--cols", str(COLS),
            "--train_num", "8", "--val_num", "4", "--batch_size", "4"]
    if variants:
        argv += ["--variants", *variants]
    want = _jax_recorded(monkeypatch, argv + ["--out", outs["jax"]])
    got, result = _port_recorded(monkeypatch, argv + ["--out", outs["port"]])
    _assert_calls_equal(got, want, outs["port"], outs["jax"])
    trained = variants or list(ablation_run.VARIANTS)
    assert [c[0] for c in got] == ["Watermelon", "train", "eval_quality"] * len(trained)
    for (_, kw), name in zip(got[0::3], trained):
        assert kw["pretrained_part1_path"] == os.path.join(parts, "rgbd2ap.msgpack")
        for key, value in ablation_run.VARIANTS[name].items():
            assert kw[key] == value
    evals = [argv for name, argv in got if name == "eval_quality"]
    assert [("--no_modulation" in a) for a in evals] == [n == "without_GAN_without_modulation" for n in trained]
    ordering = _read(os.path.join(outs["port"], "ordering.json"))
    assert ordering == _read(os.path.join(outs["jax"], "ordering.json")) == result["ordering"]
    assert list(ordering) == trained + (["without_GAN"] if variants else [])
    assert set(result["runs"]) == set(trained)
