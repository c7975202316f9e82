"""The toy recognizer of the benchmark's tests (``reference/toyrec.py``),
which the program does not run."""

from reference import pipeline as ref
from reference import toyrec

ROLE = "recognizer"
EMBED_DIM = toyrec.EMBED_DIM
specs = toyrec.specs
forward = toyrec.forward
embed = toyrec.embed


def input_size(height, width, cfg):
    return ref.CROP, ref.CROP


def pipeline_kwargs(sd):
    raise NotImplementedError("the program has no toy recognizer")
