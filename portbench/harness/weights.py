"""Random weights in the published checkpoints' key format, drawn on the
device from the run's seed: one normal draw for all of a model's floats,
then sliced and scaled per tensor (each family binding's ``specs``).
float32, the masters that the program converts and casts to the type it
serves them in."""

import zlib

import torch

from harness import families

# The offsets of the first three families' seeds, kept so that their
# draws stay those of every earlier run.
LEGACY = {"retinaface": 0, "arcface": 1, "openpose": 2}


def family_seed(seed, family):
    """A seed of its own for each model, so that one model's draw does not
    depend on another's size: a fixed hash of the family's name beside the
    run's seed."""
    if family in LEGACY:
        return (int(seed) * len(LEGACY) + LEGACY[family]) % (2 ** 63)
    return ((int(seed) << 32) + zlib.crc32(family.encode())) % (2 ** 63)


def make_state_dict(family, seed, device):
    """{key: tensor} of ``family`` on ``device``, the same for the same
    seed."""
    table = families.binding(family).specs()
    sizes = [torch.Size(shape).numel() for _, shape, init in table
             if init[0] != "zero_int"]
    gen = torch.Generator(device=device)
    gen.manual_seed(family_seed(seed, family))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    out, offset = {}, 0
    for key, shape, init in table:
        if init[0] == "zero_int":
            out[key] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = torch.Size(shape).numel()
        draw = flat[offset:offset + n].reshape(shape)
        offset += n
        if init[0] == "normal":
            out[key] = draw * init[1]
        elif init[0] == "one_plus":
            out[key] = 1.0 + draw * init[1]
        elif init[0] == "abs_plus":
            out[key] = (draw * init[1]).abs_() + init[2]
        else:
            raise ValueError(f"unknown init {init} for {key}")
    return out


def make_weights(seed, device, names):
    """{family: state dict} of the named families, drawn in their order."""
    return {name: make_state_dict(name, seed, device) for name in names}
