"""What the benchmark makes from ``--seed``: weights, scenes, cubes, draws.

Every tensor is made on the run's device from a ``torch.Generator`` of that
device, in a few large calls, so the same seed gives the same inputs and
set-up stays short. Each kind of input draws from its own generator,
seeded by ``derive(seed, tag, ...)``, so that adding a draw of one kind
moves no other.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from .reference import nets


def derive(seed, *parts):
    """A 63-bit seed from ``seed`` (any whole number) and the tags in
    ``parts`` (strings or whole numbers)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for p in parts:
        words.append(zlib.crc32(p.encode()) if isinstance(p, str) else int(p) & 0xFFFFFFFF)
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed, *parts):
    return torch.Generator(device=device).manual_seed(derive(seed, *parts))


def _norm_params(module):
    """Names of the GroupNorm parameters of a reference module."""
    return {f"{m}.{p}" if m else p
            for m, mod in module.named_modules() if isinstance(mod, nets.GroupNorm)
            for p in ("weight", "bias")}


def make_state(module, seed, tag, device):
    """A reference-layout state_dict for ``module``'s shapes, drawn in one
    call: conv and linear weights N(0, 1/fan_in), biases N(0, 0.05^2),
    GroupNorm scales 1 + N(0, 0.1^2) and shifts N(0, 0.1^2)."""
    shapes = [(k, tuple(v.shape)) for k, v in module.state_dict().items()]
    sizes = [int(np.prod(s)) for _, s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, "weights", tag),
                       device=device, dtype=torch.float32)
    norms = _norm_params(module)
    state, off = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        if name in norms:
            t = 1.0 + 0.1 * t if name.endswith("weight") else 0.1 * t
        elif len(shape) >= 2:
            t = t * (1.0 / np.sqrt(n / shape[0]))
        else:
            t = 0.05 * t
        state[name] = t
    return state


def model_states(cfg, seed, device):
    """(GAE state_dict, UNet state_dict) of the configuration, from the seed;
    None for a network the configuration does not have (no ``gae_widths``,
    no ``model.unet``). Each network draws from its own generator."""
    with torch.device("meta"):
        gae = nets.gae_from_config(cfg) if "gae_widths" in cfg else None
        unet = nets.UNet.from_config(cfg) if "unet" in cfg.get("model", {}) else None
    return (None if gae is None else make_state(gae, seed, "gae", device),
            None if unet is None else make_state(unet, seed, "unet", device))


def scenes(seed, tag, n, hw, bands, device, block=16):
    """``n`` structured scenes (n, hw, hw, bands) in [0, 1]: blocky fields of
    6 materials with smooth spectra, plus 5 % noise, min-max normalised per
    scene."""
    g = generator(device, seed, "scenes", tag)
    fields = torch.rand((n, hw // block, hw // block, 6), generator=g, device=device)
    fields = fields.repeat_interleave(block, 1).repeat_interleave(block, 2)
    spectra = torch.rand((n, 6, bands), generator=g, device=device)
    for _ in range(3):
        spectra = 0.5 * spectra + 0.25 * (spectra.roll(1, 2) + spectra.roll(-1, 2))
    noise = torch.rand((n, hw, hw, bands), generator=g, device=device)
    x = torch.einsum("nhwk,nkc->nhwc", fields, spectra) + 0.05 * noise
    lo = x.amin((1, 2, 3), keepdim=True)
    hi = x.amax((1, 2, 3), keepdim=True)
    return (x - lo) / (hi - lo)


def sr_cubes(seed, n, hw, bands, scale, device):
    """``n`` bicubic-upsampled LR cubes (n, hw, hw, bands): structured scenes,
    box-downsampled by ``scale``, upsampled by torch's bicubic, clipped to
    [0, 1]."""
    hr = scenes(seed, "cubes", n, hw, bands, device).permute(0, 3, 1, 2)
    lr = F.avg_pool2d(hr, scale)
    del hr
    sr = F.interpolate(lr, scale_factor=scale, mode="bicubic", align_corners=False)
    return sr.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()


def chain_noise(seed, k, steps, shape, device):
    """The noise of call ``k``'s chain: ``steps`` draws of ``shape``, the last
    one zeros (the chain's last step adds none)."""
    noise = torch.empty((steps, *shape), device=device)
    noise[:-1].normal_(generator=generator(device, seed, "noise", k))
    noise[-1].zero_()
    return noise
