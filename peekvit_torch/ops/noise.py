"""Channel-noise injection (counterpart of peekvit_tpu/ops/noise.py; the
reference's NoiseBlock, models/blocks.py:100-186).

- ``gaussian_snr_noise``: noise power = signal power / 10^(snr_db / 10),
  the signal power the fp32 mean of x² over the last axis; **snr_db == 0
  is the no-noise sentinel**, not infinite noise. The noise is cast to
  x's dtype before it is added.
- ``token_drop_noise``: zero ``floor(prob * N)`` of the N tokens of the
  stream (every token: class, register and budget tokens included), chosen
  by one random permutation **shared across the batch**: token i is
  dropped iff its position in the permutation is below that count.
- the noise is drawn outside autograd (JAX's ``stop_gradient``).

Draws come from an explicit ``torch.Generator`` on the tensor's device
(one seeded 0 when none is given, the counterpart of JAX's
``rngs={"noise": key(0)}``): standard normals of x's shape, or one
permutation of N. JAX draws from its own PRNG key, so the two streams
differ; each function takes an already-drawn ``noise=`` (the standard
normals, or the permutation), so that a parity test feeds both packages
the same realization.

A value given as a Python number stays on the host: its fp32 arithmetic
(10^(snr/10), floor(prob * N)) is done there in numpy float32, as JAX
does it in float32, so that a forward on the card never stops for a
blocking host-to-device copy of a scalar; a tensor value is used on the
tokens' device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from peekvit_torch.ops.global_batch import per_sample

NOISE_TYPES = ("gaussian", "token_drop")


class NoiseSpec(NamedTuple):
    """Noise before block ``layer`` of a forward: the module's
    ``noise_layer`` / ``noise_type``, the call's value (snr in dB or drop
    probability) and its generator."""

    layer: int
    noise_type: str
    value: object
    generator: Optional[torch.Generator]


def default_generator(device) -> torch.Generator:
    """The generator a forward draws from when none is given: seeded 0 on
    ``device``."""
    return torch.Generator(device=torch.device(device)).manual_seed(0)


def _generator_for(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        return default_generator(x.device)
    if generator.device.type != x.device.type:
        raise ValueError(f"the noise generator is on {generator.device}, the tokens on "
                         f"{x.device}: the noise is drawn on the tokens' device")
    return generator


def standard_normal(x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """fp32 standard normals of x's shape on x's device (over the global
    batch under data parallelism, ops/global_batch.py)."""
    gen = _generator_for(x, generator)
    return per_sample(lambda s: torch.randn(s, generator=gen, device=x.device,
                                            dtype=torch.float32), x.shape)


def token_permutation(x: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One permutation of x's N = x.shape[1] tokens on x's device."""
    return torch.randperm(x.shape[1], generator=_generator_for(x, generator), device=x.device)


def gaussian_snr_noise(x: torch.Tensor, snr_db, generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x plus Gaussian noise at ``snr_db`` dB (0: x unchanged). ``noise``:
    the standard normals (x's shape) in place of a draw."""
    with torch.no_grad():
        signal_power = x.float().square().mean(dim=-1, keepdim=True)
        if isinstance(snr_db, torch.Tensor):
            snr = snr_db.to(x.device, torch.float32)
            std = torch.sqrt(signal_power / torch.pow(10.0, snr / 10.0))
            std = torch.where(snr == 0.0, torch.zeros_like(std), std)
        else:
            snr = np.float32(snr_db)
            power = float(np.power(np.float32(10.0), snr / np.float32(10.0)))
            std = torch.sqrt(signal_power / power) * (0.0 if snr == 0.0 else 1.0)
        if noise is None:
            noise = standard_normal(x, generator)
        noise = (noise.to(x.device, torch.float32) * std).to(x.dtype)
    return x + noise


def token_drop_noise(x: torch.Tensor, prob, generator: Optional[torch.Generator] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x with ``floor(prob * N)`` tokens zeroed, the same ones in every
    image. ``noise``: the permutation of N in place of a draw."""
    n = x.shape[1]
    with torch.no_grad():
        if isinstance(prob, torch.Tensor):
            num_mask = torch.floor(prob.to(x.device, torch.float32) * n).to(torch.int64)
        else:
            num_mask = int(np.floor(np.float32(prob) * np.float32(n)))
        perm = token_permutation(x, generator) if noise is None else noise.to(x.device)
        keep = (torch.argsort(perm) >= num_mask).to(x.dtype)[None, :, None]
    return x * keep


def apply_noise(x: torch.Tensor, noise_type: str, value,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch on ``noise_type`` ('gaussian' | 'token_drop')."""
    if noise_type == "gaussian":
        return gaussian_snr_noise(x, value, generator, noise)
    if noise_type == "token_drop":
        return token_drop_noise(x, value, generator, noise)
    raise ValueError(f"unknown noise_type {noise_type!r}")


def inject_noise(tokens: torch.Tensor, i: int, spec: Optional[NoiseSpec]) -> torch.Tensor:
    """The NoiseBlock before block ``i`` (JAX inference.py:118-131): the
    noised tokens where ``spec`` names layer i, else the tokens. A value
    of None or a number 0 is the no-noise sentinel: the tokens come back
    as they are, with no draw (JAX draws and adds zeros)."""
    if spec is None or i != spec.layer:
        return tokens
    if spec.value is None or (isinstance(spec.value, (int, float)) and spec.value == 0):
        return tokens
    return apply_noise(tokens, spec.noise_type, spec.value, spec.generator)
