"""The CUDA NMS kernels' algorithm, emulated in numpy on the CPU.

``csrc/nms.cu`` cannot run here, so its two kernels are written out in
numpy as they work: the mask kernel's 64-bit words (column-major as the
kernel keeps them, words left of a row's own chunk left unset), and the
sweep kernel's chunked walk (the valid flags packed, each chunk with an
alive candidate decided in order over its diagonal words, then the kept
rows' later words ORed into ``removed``). The emulation must give the
keep mask of ``suppress_plain`` and of the JAX package's ``nms_fixed``
bit for bit, and its words must equal ``iou_mask_plain``'s. On the card,
``chip_smoke.py`` holds the kernels themselves to the same functions.
"""

import numpy as np
import pytest
import torch

from terran_tpu.ops import nms as jax_nms
from terran_tpu_torch.ops import nms
from torch_port_fixtures import single_torch_thread  # noqa: F401

WORD = nms.WORD
IOU = 0.4


def np_overlaps(a, b, threshold):
    """The kernel's ``overlaps`` in float32 numpy, broadcast over a and b
    (..., 4): iou_matrix's operation order, NaN-propagating max/min and
    clamp, a division only where inter and union are both positive."""
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
        area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
        w = np.maximum(np.minimum(a[..., 2], b[..., 2])
                       - np.maximum(a[..., 0], b[..., 0]), np.float32(0))
        h = np.maximum(np.minimum(a[..., 3], b[..., 3])
                       - np.maximum(a[..., 1], b[..., 1]), np.float32(0))
        inter = w * h
        union = (area_a + area_b) - inter
        ok = (inter > 0) & (union > 0)
        iou = np.where(ok, inter / np.where(ok, union, 1), np.float32(0))
    return iou > np.float32(threshold)


def pack(bits):
    """(..., K) bool -> (..., ceil(K / 64)) uint64, bit b of word w =
    bits[..., 64 w + b]."""
    k = bits.shape[-1]
    words = -(-k // WORD)
    padded = np.zeros(bits.shape[:-1] + (words * WORD,), np.uint64)
    padded[..., :k] = bits
    weights = np.uint64(1) << np.arange(WORD, dtype=np.uint64)
    return (padded.reshape(bits.shape[:-1] + (words, WORD))
            * weights).sum(-1, dtype=np.uint64)


def emulate_mask(boxes, threshold, rng):
    """mask_kernel: (N, W, 64 W) words, column-major. Words the kernel
    never writes hold random bits, so that a sweep which read them would
    go wrong."""
    n, k = boxes.shape[:2]
    words = -(-k // WORD)
    over = np_overlaps(boxes[:, :, None], boxes[:, None, :], threshold)
    idx = np.arange(k)
    rows = pack(over & (idx[None, :] > idx[:, None]))  # (N, K, W)
    mask = rng.integers(0, 2 ** 63, (n, words, words * WORD), dtype=np.int64)
    mask = mask.astype(np.uint64)
    for i in range(k):
        mask[:, i // WORD:, i] = rows[:, i, i // WORD:]
    return mask


def decide(alive, diagonal):
    """sweep_kernel's decision of one chunk, in order: starting from
    removed = ~alive, each candidate whose bit is still clear is kept and
    ORs in its diagonal word (bits of later candidates in the chunk)."""
    removed = ~alive & (2 ** WORD - 1)
    for b in range(WORD):
        if not removed >> b & 1:
            removed |= diagonal[b]
    return ~removed & (2 ** WORD - 1)


def emulate_sweep(mask, valid, k):
    """sweep_kernel: (keep mask (N, K), chunks decided per image (N,))
    from the mask kernel's words and the valid flags."""
    n, words = valid.shape[0], mask.shape[1]
    valid_words = pack(valid)
    keep = np.zeros((n, k), bool)
    decided = np.zeros(n, int)
    for img in range(n):
        removed = [0] * words
        for c in range(words):
            alive = int(valid_words[img, c]) & ~removed[c]
            if not alive:
                continue
            decided[img] += 1
            # Rows past k are never read: they are not alive.
            diagonal = [int(x) for x in mask[img, c, c * WORD:(c + 1) * WORD]]
            kept = decide(alive, diagonal)
            for b in range(WORD):
                if kept >> b & 1:
                    keep[img, c * WORD + b] = True
                    for w in range(c + 1, words):
                        removed[w] |= int(mask[img, w, c * WORD + b])
    return keep, decided


def random_boxes(rng, n, a, size=200.0):
    xy = rng.uniform(0, size, (n, a, 2))
    wh = rng.uniform(5, 60, (n, a, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nonfinite_boxes(rng, n, a):
    boxes = random_boxes(rng, n, a, size=100.0)
    boxes[:, ::5, 2] = np.inf
    boxes[:, 1::5, 0] = -np.inf
    boxes[:, 1::5, 2] = np.inf
    boxes[:, 2::5, 1] = np.nan
    boxes[:, 3::5] = (-np.inf, -np.inf, np.inf, np.inf)
    return boxes


def uniform_scores(rng, n, a):
    return rng.uniform(0, 1, (n, a)).astype(np.float32)


# name: (boxes and scores from an rng, score threshold, top_k)
CASES = {
    "K=1": (lambda r: (random_boxes(r, 2, 50), uniform_scores(r, 2, 50)),
            0.3, 1),
    "K=63": (lambda r: (random_boxes(r, 2, 150), uniform_scores(r, 2, 150)),
             0.3, 63),
    "K=64": (lambda r: (random_boxes(r, 2, 150), uniform_scores(r, 2, 150)),
             0.3, 64),
    "K=65": (lambda r: (random_boxes(r, 2, 150), uniform_scores(r, 2, 150)),
             0.3, 65),
    "K=256": (lambda r: (random_boxes(r, 2, 400),
                         uniform_scores(r, 2, 400)), 0.2, 256),
    "K=1024": (lambda r: (random_boxes(r, 2, 1400, size=300.0),
                          uniform_scores(r, 2, 1400)), 0.2, 1024),
    # One box repeated with one score: the first survives and removes the
    # rest, across the chunk boundary through the mask words.
    "tie plateau": (lambda r: (np.tile(np.float32([[[10, 10, 50, 60]]]),
                                       (2, 150, 1)),
                               np.full((2, 150), 0.75, np.float32)),
                    0.5, 128),
    "inf and NaN boxes": (lambda r: (nonfinite_boxes(r, 2, 200),
                                     uniform_scores(r, 2, 200)), 0.1, 128),
    "all invalid": (lambda r: (random_boxes(r, 2, 200),
                               uniform_scores(r, 2, 200) * 0.4), 0.5, 128),
    # 90 anchors for 128 slots: a -inf padded suffix, plus some below the
    # threshold.
    "invalid suffix": (lambda r: (random_boxes(r, 2, 90),
                                  uniform_scores(r, 2, 90)), 0.2, 128),
}


def run_case(name):
    """(boxes, scores, score threshold, top_k, the port's nms_fixed outputs
    as numpy, the emulated mask words, the emulated keep mask, the chunks
    the emulated sweep decided per image)."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    build, score_threshold, top_k = CASES[name]
    boxes, scores = build(rng)
    out = [t.numpy() for t in nms.nms_fixed(
        torch.from_numpy(boxes), torch.from_numpy(scores), IOU,
        score_threshold=score_threshold, top_k=top_k)]
    top_boxes, top_scores = out[0], out[1]
    mask = emulate_mask(top_boxes, IOU, rng)
    keep, decided = emulate_sweep(mask, np.isfinite(top_scores), top_k)
    return boxes, scores, score_threshold, top_k, out, mask, keep, decided


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernels_match_plain_suppression(name):
    _, _, _, _, out, _, keep, _ = run_case(name)
    np.testing.assert_array_equal(keep, out[2])
    top_boxes, top_scores = (torch.from_numpy(t) for t in out[:2])
    plain = nms.suppress_plain(top_boxes, torch.isfinite(top_scores), IOU)
    np.testing.assert_array_equal(keep, plain.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_kernels_match_jax(name):
    boxes, scores, score_threshold, top_k, out, _, keep, _ = run_case(name)
    for img in range(len(boxes)):
        _, _, jax_keep, jax_order, _ = jax_nms.nms_fixed(
            boxes[img], scores[img], IOU, score_threshold=score_threshold,
            top_k=top_k)
        np.testing.assert_array_equal(keep[img], np.asarray(jax_keep))
        np.testing.assert_array_equal(out[3][img], np.asarray(jax_order))


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_words_match_iou_mask_plain(name):
    """Every word the sweep reads (at or right of a row's own chunk)
    equals the plain packing of ``iou_matrix > threshold`` over j > i, and
    bits past K are zero."""
    _, _, _, top_k, out, mask, _, _ = run_case(name)
    plain = nms.iou_mask_plain(torch.from_numpy(out[0]), IOU)
    plain = plain.numpy().view(np.uint64)
    assert plain.shape == (2, top_k, mask.shape[1])
    for i in range(top_k):
        np.testing.assert_array_equal(mask[:, i // WORD:, i],
                                      plain[:, i, i // WORD:])
    tail = top_k - (mask.shape[1] - 1) * WORD
    if tail < WORD:
        assert not (plain[..., -1] >> np.uint64(tail)).any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_decided_chunks_are_those_with_a_survivor(name):
    """The sweep decides a chunk iff one of its candidates survives (the
    first alive candidate of a chunk always does), so the chunks that hold
    a survivor count its chain of decisions, as ``chip_smoke.py`` reads it
    from the keep mask."""
    _, _, _, top_k, _, mask, keep, decided = run_case(name)
    padded = np.zeros((len(keep), mask.shape[1] * WORD), bool)
    padded[:, :top_k] = keep
    np.testing.assert_array_equal(
        padded.reshape(len(keep), -1, WORD).any(axis=2).sum(axis=1), decided)


def test_cases_exercise_their_branch():
    counts = {name: run_case(name)[-2].sum(axis=1) for name in
              ("tie plateau", "all invalid", "K=1024", "inf and NaN boxes")}
    assert counts["tie plateau"].tolist() == [1, 1]
    assert not counts["all invalid"].any()
    assert (counts["K=1024"] > 2 * WORD).all()  # survivors in many chunks
    assert counts["inf and NaN boxes"].all()


def test_decision_follows_the_greedy_order():
    """64 disjoint boxes are all kept; in a chain in which each box
    overlaps only the next, every other one is kept; a candidate that is
    not alive removes nothing."""
    full = 2 ** WORD - 1
    assert decide(full, [0] * WORD) == full
    chain = [1 << (b + 1) for b in range(WORD - 1)] + [0]
    assert decide(full, chain) == sum(1 << b for b in range(0, WORD, 2))
    assert decide(full & ~1, chain) == sum(1 << b for b in range(1, WORD, 2))
    assert decide(0, chain) == 0
