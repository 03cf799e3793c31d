"""The port's ``convert_reference_weights`` against the JAX package's
``tools/convert_reference_weights.py``: reference-pipeline ``state_dict``s
synthesized as tests/test_weight_converter.py synthesizes them (the
reference's key names and shapes, the generator at its full width), for all
four ``--kind``s.  The port's file is byte for byte the JAX tool's, and
both the file and the flax tree of :func:`convert` load strictly into the
port's modules, with distinctive values where the JAX test places them.
Everything here is exact.
"""

import datetime

import pytest
import torch

from learned_hologram_gan_tpu_torch import convert
from learned_hologram_gan_tpu_torch.config import GeneratorConfig
from learned_hologram_gan_tpu_torch.models import AP2POH, RGBD2AP, Generator, WGANGPDiscriminator192
from learned_hologram_gan_tpu_torch.tools import convert_reference_weights as tool
from learned_hologram_gan_tpu_torch.train import checkpoint as ckpt_lib
from test_torch_tools import _run_jax, one_torch_thread  # noqa: F401
from test_weight_converter import make_reference_discriminator_state_dict, make_reference_generator_state_dict


def _state_dict(kind):
    with torch.random.fork_rng():
        torch.manual_seed(90)
        return _synthesized(kind)


def _synthesized(kind):
    if kind == "discriminator":
        return make_reference_discriminator_state_dict(feature_d=4)
    sd = make_reference_generator_state_dict()
    # distinctive values for placement checks
    sd["part1.part1.encoder1.0.0.convolution_layer_1.weight"][0, 1, 2, 0] = 42.0
    sd["part2.part1.conv_g.params"][1] = 7.0
    if kind == "generator":
        return sd
    # the stage models' own checkpoints: the generator's halves
    prefix = {"rgbd2ap": "part1.", "ap2poh": "part2."}[kind]
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _module(kind):
    return {
        "generator": lambda: Generator(GeneratorConfig(unet_base_features=64)),
        "rgbd2ap": lambda: RGBD2AP(base_features=64),
        "ap2poh": lambda: AP2POH(kernel_size=3),
        "discriminator": lambda: WGANGPDiscriminator192(feature_d=4),
    }[kind]()


@pytest.mark.parametrize("kind", ["generator", "rgbd2ap", "ap2poh", "discriminator"])
def test_converter_matches_jax_tool_and_loads_strictly(tmp_path, monkeypatch, kind):
    pth = str(tmp_path / "reference.pth")
    torch.save(_state_dict(kind), pth)
    jax_out, port_out = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    _run_jax(monkeypatch, "convert_reference_weights", ["--kind", kind, "--in", pth, "--out", jax_out])
    result = tool.main(["--kind", kind, "--in", pth, "--out", port_out, "--device", "cpu"])
    with open(jax_out, "rb") as f, open(port_out, "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and result["bytes"] == len(want)

    tree = tool.convert(kind, tool.load_state_dict(pth))
    to_sd = convert.discriminator_state_dict if kind == "discriminator" else convert.generator_state_dict
    module = _module(kind)
    module.load_state_dict(to_sd(tree))  # strict
    from_file = _module(kind)
    ckpt_lib.load_weights(port_out, from_file)
    for (k, a), (_, b) in zip(module.state_dict().items(), from_file.state_dict().items()):
        assert torch.equal(a, b), k
    sd = module.state_dict()
    if kind in ("generator", "rgbd2ap"):
        key = ("part1." if kind == "generator" else "") + "unet.enc_0.Conv_0.weight"
        assert sd[key][0, 1, 2, 0] == 42.0  # OIHW, as the reference wrote it
    if kind in ("generator", "ap2poh"):
        key = ("part2." if kind == "generator" else "") + "modulation.conv_g.radial_weights"
        assert sd[key][1] == 7.0


def test_converted_generator_runs(tmp_path):
    """The converted full-width generator drives a forward pass on the CPU
    (the JAX test's last check): a finite POH of the input's shape."""
    from learned_hologram_gan_tpu_torch.models import make_generator_plan

    cfg = GeneratorConfig(rows=32, cols=32, pad_size=8, unet_base_features=64)
    gen = Generator(cfg).eval()
    gen.load_state_dict(convert.generator_state_dict(tool.convert("generator", _state_dict("generator"))))
    with torch.no_grad():
        poh = gen(make_generator_plan(cfg, device="cpu"), torch.ones(1, 4, 32, 32))
    assert poh.shape == (1, 3, 32, 32) and torch.isfinite(poh).all()


def test_converter_refuses_what_the_port_cannot_load(tmp_path):
    """The strict load before writing: a stage-1 checkpoint whose final
    layer has 5 channels converts, but no port module takes it, so no file
    is written; ``--device cuda`` without a card is refused."""
    sd = _state_dict("rgbd2ap")
    sd["part1.final_layer.0.weight"] = sd["part1.final_layer.0.weight"][:5]
    sd["part1.final_layer.0.bias"] = sd["part1.final_layer.0.bias"][:5]
    pth, out = str(tmp_path / "bad.pth"), str(tmp_path / "bad.msgpack")
    torch.save(sd, pth)
    with pytest.raises(RuntimeError, match="size mismatch"):
        tool.main(["--kind", "rgbd2ap", "--in", pth, "--out", out, "--device", "cpu"])
    assert not (tmp_path / "bad.msgpack").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tool.main(["--kind", "rgbd2ap", "--in", pth, "--out", out])


def test_converter_refuses_a_pickled_object(tmp_path):
    """``weights_only``: a checkpoint that needs arbitrary unpickling is
    refused, not executed."""
    path = str(tmp_path / "obj.pth")
    torch.save({"w": torch.zeros(1), "obj": datetime.date(2020, 1, 1)}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        tool.load_state_dict(path)
