"""Training state (counterpart of ``learned_hologram_gan_tpu/train/state.py``).

Where the JAX package threads one immutable pytree through a jitted step,
the port keeps the two networks, their ``torch.optim.Adam`` optimizers (the
update rule of ``optax.adam``: eps outside the square root), the step
count and a CPU ``torch.Generator`` for the random draws in one mutable
object that the train step updates in place.

``freeze_part1`` trains stage 2 against a frozen stage 1 (reference
RGBD2AP.py:37-41): part 1's parameters stop requiring gradients and
``opt_G`` holds only the others, as the JAX package's ``multi_transform``
keeps no Adam state for ``part1`` and zeroes its updates.  Part 1's
BatchNorm running statistics still update in train mode, as in the JAX
package (``train/watermelon.py:158-162``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..config import DiscriminatorConfig, GeneratorConfig
from ..losses.perceptual import VGG19Features
from ..models.discriminator import FakeDiscriminator, WGANGPDiscriminator192, init_discriminator
from ..models.generator import Generator
from ..nn.blocks import init_weights


@dataclasses.dataclass
class TrainState:
    step: int
    generator: Generator
    discriminator: nn.Module
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    rng: torch.Generator  # distance indices and GP alphas, drawn on the CPU
    vgg: Optional[VGG19Features] = None


def build_modules(
    gen_config: GeneratorConfig, disc_config: DiscriminatorConfig, use_gan: bool
) -> Tuple[Generator, nn.Module]:
    generator = Generator(gen_config)
    critic = WGANGPDiscriminator192 if use_gan else FakeDiscriminator
    return generator, critic(feature_d=disc_config.feature_d, dtype=disc_config.dtype)


def create_train_state(
    seed: int,
    generator: Generator,
    discriminator: nn.Module,
    lr_G: float,
    lr_D: float,
    device: str | torch.device = "cuda",
    vgg: Optional[VGG19Features] = None,
    freeze_part1: bool = False,
) -> TrainState:
    """Initialize both networks from ``seed`` on the CPU (the JAX package's
    schemes, torch's numbers), move them to ``device`` in train mode and
    build their Adam optimizers, the generator's without part 1 when
    ``freeze_part1``.  The same generator then draws the step's random
    numbers."""
    rng = torch.Generator().manual_seed(seed)
    init_weights(generator, rng)
    init_discriminator(discriminator, rng)
    generator.to(device).train()
    discriminator.to(device).train()
    generator.part1.requires_grad_(not freeze_part1)
    return TrainState(
        step=0,
        generator=generator,
        discriminator=discriminator,
        opt_G=torch.optim.Adam([p for p in generator.parameters() if p.requires_grad], lr=lr_G),
        opt_D=torch.optim.Adam(discriminator.parameters(), lr=lr_D),
        rng=rng,
        vgg=vgg,
    )
