"""The int8 convs whole, from quantisation to dequantisation: the least
time of each profiled terran::quant_conv range's conv, from the dims its
name carries, over the device time of the kernels launched inside it."""

import torch

from harness import spans


def read(ctx):
    dtype = getattr(torch, ctx.cell.pipe_cfg["compute_dtype"])
    return spans.quant_conv_roofline(
        ctx.tracer, torch.empty(0, dtype=dtype).element_size())
