"""Readings of the recognizer's embed programs, from the program's own
StageTimer records, kept by ``PerceptionPipeline`` where a batch's
embeddings reach the host: ``embed_device`` (one an embed-program call:
its device seconds, a CUDA event pair around the call, items the faces
embedded) and ``embed_slots`` (items the slots the call computed, no
clock read). Each returns None where the run gave it nothing to read: no
timer, or a program that keeps no such record."""

import functools

import torch

from harness import bounds, families, flops


class _Split(flops._Counting):
    """The operation count, with the products of two activations also
    counted on their own."""

    def __init__(self):
        super().__init__()
        self.products = 0

    def matmul(self, a, b):
        before = self.flops
        y = super().matmul(a, b)
        self.products += self.flops - before
        return y


@functools.lru_cache(maxsize=None)
def split_flops(family, height, width):
    """(all operations, those of the products of two activations) of one
    (height, width) input through ``family``'s reference forward, counted
    on the ``meta`` device."""
    binding = families.binding(family)
    ops = _Split()
    x = torch.empty((1, 3, height, width), device="meta")
    binding.forward(flops._meta_state_dict(binding.specs()), x, ops)
    return ops.flops, ops.products


def least_s_per_face(ctx):
    """The least seconds one face's embedding takes at the published
    peaks: the products of two activations at the float32 rate where the
    binding declares float32 attention (``ATTENTION``), the rest at the
    rate of the embed precision (bf16, or int8)."""
    rec = ctx.cell.families["recognizer"]
    c = ctx.cell.pipe_cfg
    total, products = split_flops(
        rec.name, *rec.binding.input_size(*ctx.cell.mix["frame"], c))
    rate = (bounds.PEAK_INT8_OPS
            if c[families.PRECISION["recognizer"]] == "int8"
            else bounds.PEAK_BF16_FLOPS)
    product_rate = (bounds.PEAK_FP32_OPS
                    if getattr(rec.binding, "ATTENTION", None) == "float32"
                    else rate)
    return (total - products) / rate + products / product_rate


def embed_device_ms(ctx):
    """Mean device ms of an embed-program call over the run's window."""
    timer = ctx.timer
    calls = timer.counts.get("embed_device", 0) if timer else 0
    if not calls:
        return None
    return 1e3 * timer.times["embed_device"] / calls


def embed_mfu(ctx):
    """The least time of the faces embedded, at the published peaks, over
    the device seconds of the embed calls that embedded them."""
    timer = ctx.timer
    seconds = timer.times.get("embed_device", 0.0) if timer else 0.0
    if not seconds or "recognizer" not in ctx.cell.families:
        return None
    faces = timer.items["embed_device"]
    return 100.0 * faces * least_s_per_face(ctx) / seconds
