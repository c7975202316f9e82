"""Plain PyTorch forwards of RetinaFace (mobilenet-0.25), FaceResNet100
(LResNet100E-IR) and OpenPose (CMU 2017 body), as the published
reference implementations compute them, on state dicts in the published
checkpoints' key format.

A frozen copy of the repository's test oracle forwards (not imported:
the benchmark's reference imports nothing of the program or its tests),
with two changes: the weights are tensors already on the input's
device, and every convolution and dense layer goes through an ``ops``
object, so that the same forward computes the float32 reference
(:data:`FLOAT`), the control in a lower precision (:class:`Quantized`)
and the benchmark's operation count (``harness/flops.py``).

Also here: the key names, shapes and initialisation of the random
weights that ``harness/weights.py`` draws on the card (``*_specs``, each
named by its family's binding under ``families/``).
"""

import torch
import torch.nn.functional as F


class Float:
    """float32 convolutions, dense layers and products of two
    activations."""

    def conv(self, x, w, b, stride=1, pad=0, groups=1):
        return F.conv2d(x, w, b, stride=stride, padding=pad, groups=groups)

    def linear(self, x, w, b):
        return F.linear(x, w, b)

    def matmul(self, a, b):
        return a @ b


FLOAT = Float()


class Quantized(Float):
    """Convolutions, dense layers and products of two activations on a
    lower-precision number format,
    the products and sums in float64 so that only the rounding of their
    operands departs from :data:`FLOAT`: ``"int8"`` or ``"int4"``
    (symmetric integers, the largest magnitude over ``2**(bits-1) - 1``)
    or ``"fp8"`` (e4m3, the largest magnitude onto 448), with one scale
    per output channel for weights and one per tensor for activations
    (both operands of a product of two activations)."""

    LEVELS = {"int8": 127.0, "int4": 7.0, "fp8": 448.0}

    def __init__(self, kind):
        self.kind = kind
        self.levels = self.LEVELS[kind]

    def _q(self, t, dims):
        scale = t.abs().amax(dim=dims, keepdim=True) / self.levels
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        x = t / scale
        if self.kind == "fp8":
            x = x.to(torch.float8_e4m3fn).to(torch.float32)
        else:
            x = torch.round(x).clamp_(-self.levels, self.levels)
        return x, scale

    def conv(self, x, w, b, stride=1, pad=0, groups=1):
        xq, xs = self._q(x, None)
        wq, ws = self._q(w, tuple(range(1, w.dim())))
        acc = F.conv2d(xq.double(), wq.double(), None, stride=stride,
                       padding=pad, groups=groups)
        y = acc * (xs.double() * ws.double().reshape(1, -1, 1, 1))
        if b is not None:
            y = y + b.double().reshape(1, -1, 1, 1)
        return y.float()

    def linear(self, x, w, b):
        xq, xs = self._q(x, None)
        wq, ws = self._q(w, (1,))
        y = (xq.double() @ wq.double().t()) * (xs.double()
                                              * ws.double().reshape(1, -1))
        return (y + b.double()).float()

    def matmul(self, a, b):
        aq, a_s = self._q(a, None)
        bq, b_s = self._q(b, None)
        return ((aq.double() @ bq.double())
                * (a_s.double() * b_s.double())).float()


def _bn(x, sd, name, eps):
    return F.batch_norm(x, sd[f"{name}.running_mean"],
                        sd[f"{name}.running_var"], sd[f"{name}.weight"],
                        sd[f"{name}.bias"], training=False, eps=eps)


def _conv(ops, x, sd, name, stride=1, pad=0, groups=1, bias=False):
    return ops.conv(x, sd[f"{name}.weight"],
                    sd[f"{name}.bias"] if bias else None, stride=stride,
                    pad=pad, groups=groups)


# ---------------------------------------------------------------------------
# RetinaFace, mobilenet-0.25 backbone
# ---------------------------------------------------------------------------

RF_SEP_BLOCKS = {
    "base.scales.0.0": (8, 16, 2),
    "base.scales.0.1": (16, 32, 1),
    "base.scales.0.2": (32, 32, 2),
    "base.scales.0.3": (32, 64, 1),
    "base.scales.0.4": (64, 64, 2),
    "base.scales.1.0": (64, 128, 1),
    "base.scales.1.1": (128, 128, 1),
    "base.scales.1.2": (128, 128, 1),
    "base.scales.1.3": (128, 128, 1),
    "base.scales.1.4": (128, 128, 1),
    "base.scales.1.5": (128, 128, 2),
    "base.final_conv.0": (128, 256, 1),
}


def retinaface_forward(sd, x, ops=FLOAT):
    """(N, 3, H, W) float32 BGR pixels in [0, 255] -> the 9 head outputs
    [cls32, bbox32, lmk32, cls16, ..., lmk8], cls softmaxed per anchor."""
    eps_b, eps_f = 1e-5, 2e-5

    def conv_bn(x, conv, bn, eps, stride=1, pad=0, groups=1, bias=False):
        x = _conv(ops, x, sd, conv, stride=stride, pad=pad, groups=groups,
                  bias=bias)
        return F.relu(_bn(x, sd, bn, eps))

    x = conv_bn(x, "base.first_conv_block.0", "base.first_conv_block.1",
                eps_b, stride=2, pad=1)
    x = conv_bn(x, "base.first_conv_block.3", "base.first_conv_block.4",
                eps_b, pad=1, groups=8)
    feats = []
    for prefix, (_in_c, out_c, stride) in RF_SEP_BLOCKS.items():
        conv = conv_bn(x, f"{prefix}.conv_block.0", f"{prefix}.conv_block.1",
                       eps_b)
        x = conv_bn(conv, f"{prefix}.sep_block.0", f"{prefix}.sep_block.1",
                    eps_b, stride=stride, pad=1, groups=out_c)
        if prefix in ("base.scales.0.4", "base.scales.1.5"):
            feats.append(conv)
    feats.append(conv_bn(x, "base.final_conv.1", "base.final_conv.2", eps_b))

    f8, f16, f32 = feats
    p8 = conv_bn(f8, "refiner.conv_stride8.0", "refiner.conv_stride8.1",
                 eps_f, bias=True)
    p16 = conv_bn(f16, "refiner.conv_stride16.0", "refiner.conv_stride16.1",
                  eps_f, bias=True)
    p32 = conv_bn(f32, "refiner.conv_stride32.0", "refiner.conv_stride32.1",
                  eps_f, bias=True)
    ups32 = F.interpolate(p32, scale_factor=2)[:, :, :p16.shape[2],
                                               :p16.shape[3]]
    p16 = conv_bn(p16 + ups32, "refiner.aggr_stride16.0",
                  "refiner.aggr_stride16.1", eps_f, pad=1, bias=True)
    ups16 = F.interpolate(p16, scale_factor=2)[:, :, :p8.shape[2],
                                               :p8.shape[3]]
    p8 = conv_bn(p8 + ups16, "refiner.aggr_stride8.0",
                 "refiner.aggr_stride8.1", eps_f, pad=1, bias=True)

    def context(x, p):
        ctx3 = conv_bn(x, f"{p}.context_3x3.0", f"{p}.context_3x3.1", eps_f,
                       pad=1, bias=True)
        red = conv_bn(x, f"{p}.dimension_reducer.0",
                      f"{p}.dimension_reducer.1", eps_f, pad=1, bias=True)
        ctx5 = conv_bn(red, f"{p}.context_5x5.0", f"{p}.context_5x5.1",
                       eps_f, pad=1, bias=True)
        ctx7 = conv_bn(red, f"{p}.context_7x7.0", f"{p}.context_7x7.1",
                       eps_f, pad=1, bias=True)
        ctx7 = conv_bn(ctx7, f"{p}.context_7x7.3", f"{p}.context_7x7.4",
                       eps_f, pad=1, bias=True)
        return torch.cat([ctx3, ctx5, ctx7], dim=1)

    outs = []
    for stride, feat in ((32, context(p32, "refiner.context_stride32")),
                         (16, context(p16, "refiner.context_stride16")),
                         (8, context(p8, "refiner.context_stride8"))):
        cls = _conv(ops, feat, sd, f"outputs.cls_stride{stride}", bias=True)
        n, a, h, w = cls.shape
        cls = F.softmax(cls.reshape(n, 2, -1, w), dim=1).reshape(n, a, h, w)
        box = _conv(ops, feat, sd, f"outputs.bbox_stride{stride}", bias=True)
        lmk = _conv(ops, feat, sd, f"outputs.landmark_stride{stride}",
                    bias=True)
        outs.extend([cls, box, lmk])
    return outs


# ---------------------------------------------------------------------------
# FaceResNet100 (ArcFace LResNet100E-IR)
# ---------------------------------------------------------------------------

ARC_UNITS = (3, 13, 30, 3)
ARC_CHANNELS = (64, 64, 128, 256, 512)


def arcface_forward(sd, x, ops=FLOAT):
    """(N, 3, 112, 112) float32 BGR crops in [0, 255] -> (N, 512)
    features, not normalised."""
    eps = 2e-5
    x = (x - 127.5) * 0.0078125
    x = _conv(ops, x, sd, "initial_layer.0", pad=1)
    x = F.prelu(_bn(x, sd, "initial_layer.1", eps),
                sd["initial_layer.2.weight"])
    for stage, num_units in enumerate(ARC_UNITS):
        for unit in range(num_units):
            p = f"stages.{stage}.{unit}"
            stride = 2 if unit == 0 else 1
            body = _bn(x, sd, f"{p}.body.0", eps)
            body = _conv(ops, body, sd, f"{p}.body.1", pad=1)
            body = _bn(body, sd, f"{p}.body.2", eps)
            body = F.prelu(body, sd[f"{p}.body.3.weight"])
            body = _conv(ops, body, sd, f"{p}.body.4", stride=stride, pad=1)
            body = _bn(body, sd, f"{p}.body.5", eps)
            if unit == 0:
                shortcut = _bn(_conv(ops, x, sd, f"{p}.shortcut.0",
                                     stride=stride),
                               sd, f"{p}.shortcut.1", eps)
            else:
                shortcut = x
            x = body + shortcut
    x = torch.flatten(_bn(x, sd, "final_layer.0", eps), 1)
    x = ops.linear(x, sd["final_layer.3.weight"], sd["final_layer.3.bias"])
    return F.batch_norm(x, sd["final_layer.4.running_mean"],
                        sd["final_layer.4.running_var"],
                        sd["final_layer.4.weight"], sd["final_layer.4.bias"],
                        training=False, eps=eps)


# ---------------------------------------------------------------------------
# OpenPose body, COCO 18 parts
# ---------------------------------------------------------------------------

OP_BLOCK0 = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256),
    ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512),
    ("conv4_3_CPM", 512, 256), ("conv4_4_CPM", 256, 128),
)
OP_STAGE1 = ((128, 128, 3), (128, 128, 3), (128, 128, 3), (128, 512, 1))
OP_REFINE = ((185, 128, 7),) + ((128, 128, 7),) * 4 + ((128, 128, 1),)


def openpose_forward(sd, x, ops=FLOAT):
    """(N, 3, H, W) float32 RGB as ``x / 255 - 0.5`` -> (pafs (N, 38, h,
    w), heatmaps (N, 19, h, w)) at an eighth of the input. Keeps the
    published model's stage-6 L2 ReLU (its no-ReLU list names
    Mconv7_stage6_L1 twice)."""

    def conv(x, name, pad, relu=True):
        x = _conv(ops, x, sd, name, pad=pad, bias=True)
        return F.relu(x) if relu else x

    h = x
    for name, _i, _o in OP_BLOCK0:
        h = conv(h, f"model0.{name}", pad=1)
        if name in ("conv1_2", "conv2_2", "conv3_4"):
            h = F.max_pool2d(h, 2, 2)
    trunk = h

    def stage1(branch):
        h = trunk
        for i in (1, 2, 3):
            h = conv(h, f"model1_{branch}.conv5_{i}_CPM_L{branch}", pad=1)
        h = conv(h, f"model1_{branch}.conv5_4_CPM_L{branch}", pad=0)
        return conv(h, f"model1_{branch}.conv5_5_CPM_L{branch}", pad=0,
                    relu=False)

    paf, heat = stage1(1), stage1(2)
    for stage in range(2, 7):
        inp = torch.cat([paf, heat, trunk], dim=1)

        def refine(branch, stage=stage, inp=inp):
            h = inp
            for i in range(1, 6):
                h = conv(h, f"model{stage}_{branch}.Mconv{i}_stage{stage}"
                            f"_L{branch}", pad=3)
            h = conv(h, f"model{stage}_{branch}.Mconv6_stage{stage}"
                        f"_L{branch}", pad=0)
            return conv(h, f"model{stage}_{branch}.Mconv7_stage{stage}"
                           f"_L{branch}", pad=0,
                        relu=stage == 6 and branch == 2)

        paf, heat = refine(1), refine(2)
    return paf, heat


# ---------------------------------------------------------------------------
# Weight specifications: (key, shape, init) in the published key format
# ---------------------------------------------------------------------------
# init: ("normal", std) N(0, std); ("one_plus", std) 1 + N(0, std);
# ("abs_plus", std, c) |N(0, std)| + c; ("zero_int",) an int64 0. These are
# the oracle's draws: N(0, 0.1) for biases and BN statistics, conv weights
# scaled by fan-in where depth would otherwise overflow.

def _bn_specs(name, ch):
    return [(f"{name}.weight", (ch,), ("one_plus", 0.01)),
            (f"{name}.bias", (ch,), ("normal", 0.1)),
            (f"{name}.running_mean", (ch,), ("normal", 0.1)),
            (f"{name}.running_var", (ch,), ("abs_plus", 0.1, 0.5)),
            (f"{name}.num_batches_tracked", (), ("zero_int",))]


def retinaface_specs():
    s = [("base.first_conv_block.0.weight", (8, 3, 3, 3), ("normal", 0.1))]
    s += _bn_specs("base.first_conv_block.1", 8)
    s += [("base.first_conv_block.3.weight", (8, 1, 3, 3), ("normal", 0.1))]
    s += _bn_specs("base.first_conv_block.4", 8)
    for prefix, (in_c, out_c, _stride) in RF_SEP_BLOCKS.items():
        s += [(f"{prefix}.conv_block.0.weight", (out_c, in_c, 1, 1),
               ("normal", 0.1))]
        s += _bn_specs(f"{prefix}.conv_block.1", out_c)
        s += [(f"{prefix}.sep_block.0.weight", (out_c, 1, 3, 3),
               ("normal", 0.1))]
        s += _bn_specs(f"{prefix}.sep_block.1", out_c)
    s += [("base.final_conv.1.weight", (256, 256, 1, 1), ("normal", 0.1))]
    s += _bn_specs("base.final_conv.2", 256)

    def conv_bias_bn(prefix, out_c, in_c, k):
        return ([(f"{prefix}.0.weight", (out_c, in_c, k, k), ("normal", 0.1)),
                 (f"{prefix}.0.bias", (out_c,), ("normal", 0.1))]
                + _bn_specs(f"{prefix}.1", out_c))

    for name, in_c in (("stride8", 64), ("stride16", 128), ("stride32", 256)):
        s += conv_bias_bn(f"refiner.conv_{name}", 64, in_c, 1)
    for name in ("stride8", "stride16"):
        s += conv_bias_bn(f"refiner.aggr_{name}", 64, 64, 3)
    for stride in (8, 16, 32):
        p = f"refiner.context_stride{stride}"
        s += conv_bias_bn(f"{p}.context_3x3", 32, 64, 3)
        s += conv_bias_bn(f"{p}.dimension_reducer", 16, 64, 3)
        s += conv_bias_bn(f"{p}.context_5x5", 16, 16, 3)
        s += conv_bias_bn(f"{p}.context_7x7", 16, 16, 3)
        s += [(f"{p}.context_7x7.3.weight", (16, 16, 3, 3), ("normal", 0.1)),
              (f"{p}.context_7x7.3.bias", (16,), ("normal", 0.1))]
        s += _bn_specs(f"{p}.context_7x7.4", 16)
    # The box and landmark heads are drawn a tenth as wide as the rest, so
    # that boxes keep their anchors' sizes (within about a factor of two)
    # as a trained detector's do: at 0.1, exp() of the size offsets gave
    # boxes from under a pixel to 40 frame heights.
    for stride in (8, 16, 32):
        for head, ch, std in (("cls", 4, 0.1), ("bbox", 8, 0.01),
                              ("landmark", 20, 0.01)):
            s += [(f"outputs.{head}_stride{stride}.weight", (ch, 64, 1, 1),
                   ("normal", std)),
                  (f"outputs.{head}_stride{stride}.bias", (ch,),
                   ("normal", std))]
    return s


def arcface_specs():
    def conv_w(name, o, i, k):
        return (f"{name}.weight", (o, i, k, k),
                ("normal", 0.5 / (i * k * k) ** 0.5))

    s = [conv_w("initial_layer.0", 64, 3, 3)]
    s += _bn_specs("initial_layer.1", 64)
    s += [("initial_layer.2.weight", (64,), ("abs_plus", 0.1, 0.0))]
    for stage, num_units in enumerate(ARC_UNITS):
        in_c, out_c = ARC_CHANNELS[stage], ARC_CHANNELS[stage + 1]
        for unit in range(num_units):
            p = f"stages.{stage}.{unit}"
            cur_in = in_c if unit == 0 else out_c
            s += _bn_specs(f"{p}.body.0", cur_in)
            s += [conv_w(f"{p}.body.1", out_c, cur_in, 3)]
            s += _bn_specs(f"{p}.body.2", out_c)
            s += [(f"{p}.body.3.weight", (out_c,), ("abs_plus", 0.1, 0.0)),
                  conv_w(f"{p}.body.4", out_c, out_c, 3)]
            s += _bn_specs(f"{p}.body.5", out_c)
            if unit == 0:
                s += [conv_w(f"{p}.shortcut.0", out_c, cur_in, 1)]
                s += _bn_specs(f"{p}.shortcut.1", out_c)
    s += _bn_specs("final_layer.0", 512)
    s += [("final_layer.3.weight", (512, 7 * 7 * 512),
           ("normal", 1.0 / (7 * 7 * 512) ** 0.5)),
          ("final_layer.3.bias", (512,), ("normal", 0.1))]
    s += _bn_specs("final_layer.4", 512)
    return s


def openpose_specs():
    def conv(name, o, i, k):
        return [(f"{name}.weight", (o, i, k, k),
                 ("normal", 1.0 / (i * k * k) ** 0.5)),
                (f"{name}.bias", (o,), ("normal", 0.1))]

    s = []
    for name, in_c, out_c in OP_BLOCK0:
        s += conv(f"model0.{name}", out_c, in_c, 3)
    for branch, out_final in ((1, 38), (2, 19)):
        chans = OP_STAGE1 + ((512, out_final, 1),)
        for i, (in_c, out_c, k) in enumerate(chans, start=1):
            s += conv(f"model1_{branch}.conv5_{i}_CPM_L{branch}", out_c,
                      in_c, k)
    for stage in range(2, 7):
        for branch, out_final in ((1, 38), (2, 19)):
            chans = OP_REFINE + ((128, out_final, 1),)
            for i, (in_c, out_c, k) in enumerate(chans, start=1):
                s += conv(f"model{stage}_{branch}.Mconv{i}_stage{stage}"
                          f"_L{branch}", out_c, in_c, k)
    return s

