"""BODY_25's skeleton (``ops.pose_decode.BODY_25``) through the limb table
and the assembly: the tables' consistency, limb scores on synthetic PAF
fields drawn along the limbs of known people, and the C++ assembly against
the Python version on those people and on random decode outputs at 25
parts and 26 limbs.

Peak ids and keypoint counts compare exactly; score sums within 1e-9 (the
C++ merge adds a human's two sums and the limb score in another
association than the Python version), as ``test_torch_native`` holds
them for the COCO model.
"""

import numpy as np
import pytest
import torch

from terran_tpu_torch import native
from terran_tpu_torch.ops.pose_decode import (
    BODY_25, COCO_18, limb_scores, limb_table,
)
from terran_tpu_torch.pose import assembly

PARTS, LIMBS = 25, 26


def assert_same_humans(got, expected):
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got[:, :PARTS], expected[:, :PARTS])
    np.testing.assert_array_equal(got[:, PARTS + 1], expected[:, PARTS + 1])
    np.testing.assert_allclose(got[:, PARTS], expected[:, PARTS], rtol=0,
                               atol=1e-9)


def test_the_tables_are_openposes_body_25():
    assert (BODY_25.parts, BODY_25.limbs) == (25, 26)
    assert BODY_25.limbseq.shape == BODY_25.map_idx.shape == (LIMBS, 2)
    # Every PAF channel of the 52 is read by exactly one limb.
    assert sorted(BODY_25.map_idx.ravel().tolist()) == list(range(52))
    # Every part lies on some limb; the skeleton joins all 25.
    assert set(BODY_25.limbseq.ravel().tolist()) == set(range(PARTS))
    # Only the two ear-shoulder limbs may not start a human.
    assert np.flatnonzero(~BODY_25.starts).tolist() == [18, 19]
    assert BODY_25.limbseq[18].tolist() == [2, 17]
    assert BODY_25.limbseq[19].tolist() == [5, 18]
    # COCO-18 keeps its tables and its rule: all but the last two limbs.
    assert (COCO_18.parts, COCO_18.limbs) == (18, 19)
    assert np.flatnonzero(~COCO_18.starts).tolist() == [17, 18]


# Three people of 25 parts (y, x) on a 96 x 160 field, apart from one
# another, each part's score its own.
def _people():
    rng = np.random.default_rng(5)
    people = []
    for cx in (28, 80, 132):
        offsets = rng.uniform(-10, 10, size=(PARTS, 2))
        offsets[:, 0] *= 3.5
        points = np.array([48.0, cx]) + offsets
        people.append(np.round(points).astype(np.int64))
    return people


def _field(people, h=96, w=160):
    """(h, w, 52) PAFs: each limb of each person writes its unit vector
    (x, y) into its channels on the pixels within 1.5 of its segment."""
    field = np.zeros((h, w, 52), np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    for points in people:
        for (src, dst), (cx, cy) in zip(BODY_25.limbseq, BODY_25.map_idx):
            a, b = points[src].astype(np.float64), points[dst].astype(
                np.float64)
            d = b - a
            length = np.hypot(*d)
            u = d / length
            t = ((yy - a[0]) * u[0] + (xx - a[1]) * u[1]) / length
            dist = np.abs((yy - a[0]) * u[1] - (xx - a[1]) * u[0])
            near = (t >= -0.05) & (t <= 1.05) & (dist <= 1.5)
            field[near, cx] = u[1]
            field[near, cy] = u[0]
    return field


def _peak_tables(people, k=4):
    coords = np.zeros((PARTS, k, 2), np.int32)
    scores = np.zeros((PARTS, k), np.float32)
    valid = np.zeros((PARTS, k), bool)
    for slot, points in enumerate(people):
        coords[:, slot] = points
        scores[:, slot] = 0.5 + 0.01 * np.arange(PARTS) + 0.1 * slot
        valid[:, slot] = True
    return coords, scores, valid


def _limb_tables(people, k=4):
    coords, scores, valid = _peak_tables(people, k)
    reg, accept = limb_scores(torch.from_numpy(_field(people)),
                              torch.from_numpy(coords),
                              torch.from_numpy(valid), 0.05, BODY_25)
    return coords, scores, valid, reg.numpy(), accept.numpy()


def test_limb_scores_accept_each_persons_limbs_and_no_other():
    people = _people()
    coords, scores, valid, reg, accept = _limb_tables(people)
    assert reg.shape == accept.shape == (LIMBS, 4, 4)
    # The diagonal pairs (a person's own two parts) are accepted on every
    # limb; no pair across people is, and the empty slot never.
    for limb in range(LIMBS):
        np.testing.assert_array_equal(np.diag(accept[limb])[:3], True)
    across = accept.copy()
    for slot in range(3):
        across[:, slot, slot] = False
    assert not across.any()


def test_the_limb_table_packs_the_scores_of_the_upsampled_field():
    """``limb_table`` on a small field equals ``limb_scores`` on its x8
    upsample, at BODY_25's 26 limbs and 52 PAF channels."""
    from terran_tpu_torch.ops.upsample import upsample_bicubic

    rng = np.random.default_rng(6)
    small = torch.from_numpy(rng.normal(size=(2, 12, 20, 52)).astype(
        np.float32))
    coords = torch.from_numpy(rng.integers(0, 96, size=(2, PARTS, 3, 2)))
    coords[..., 1] = coords[..., 1] * 160 // 96
    valid = torch.from_numpy(rng.uniform(size=(2, PARTS, 3)) < 0.8)
    table = limb_table(small, coords.to(torch.int32), valid, 0.05,
                       skeleton=BODY_25)
    reg, accept = limb_scores(upsample_bicubic(small, 8),
                              coords.to(torch.int32), valid, 0.05, BODY_25)
    assert table.shape == (2, LIMBS, 3, 3, 2)
    torch.testing.assert_close(table[..., 0], reg, rtol=0, atol=0)
    torch.testing.assert_close(table[..., 1] > 0.5, accept)


@pytest.mark.parametrize("use_native", [True, False])
def test_the_assembly_finds_each_person_whole(use_native):
    if use_native:
        assert native.native_available(), native.build_error()
    people = _people()
    tables = _limb_tables(people)
    peaks, humans = assembly.assemble_humans(
        *tables, use_native=use_native, skeleton=BODY_25)
    assert peaks.shape == (3 * PARTS, 3)
    assert humans.shape == (3, PARTS + 2)
    for human in humans:
        ids = human[:PARTS].astype(int)
        assert (ids >= 0).all() and human[PARTS + 1] == PARTS
        slots = {int(peaks[i, 1]) for i in ids}
        # One person's 25 parts, each its own.
        person = [p for p in people if int(p[0, 1]) in slots]
        assert len(person) == 1
        np.testing.assert_array_equal(peaks[ids, :2], person[0])
    kp = assembly.get_keypoints(peaks, humans, scale=0.5)
    assert [d["keypoints"].shape for d in kp] == [(PARTS, 3)] * 3


def test_native_and_python_assemble_the_people_alike():
    tables = _limb_tables(_people())
    peaks_n, humans_n = assembly.assemble_humans(*tables, use_native=True,
                                                 skeleton=BODY_25)
    peaks_p, humans_p = assembly.assemble_humans(*tables, use_native=False,
                                                 skeleton=BODY_25)
    np.testing.assert_array_equal(peaks_n, peaks_p)
    assert_same_humans(humans_n, humans_p)


def random_decode_outputs(rng, k, peak_prob, accept_prob):
    """Random BODY_25 decode outputs: valid slots a prefix of each part,
    accepted pairs only between valid slots."""
    coords = rng.integers(0, 100, size=(PARTS, k, 2)).astype(np.int32)
    scores = rng.uniform(0.1, 1.0, size=(PARTS, k)).astype(np.float32)
    counts = rng.binomial(k, peak_prob, size=PARTS)
    valid = np.arange(k)[None, :] < counts[:, None]
    reg = rng.uniform(-0.5, 1.0, size=(LIMBS, k, k)).astype(np.float32)
    accept = rng.uniform(size=(LIMBS, k, k)) < accept_prob
    for limb, (sp, dp) in enumerate(BODY_25.limbseq):
        accept[limb] &= valid[sp][:, None] & valid[dp][None, :]
    return coords, scores, valid, reg, accept


@pytest.mark.parametrize("k,peak_prob,accept_prob", [
    (8, 0.5, 0.2),
    (10, 0.9, 0.7),   # dense: merges, overlap tiebreaks, 3+ matches
    (16, 0.9, 0.3),   # the pipeline's K
])
def test_native_assembly_matches_python_at_25_parts(k, peak_prob,
                                                    accept_prob):
    rng = np.random.default_rng(100 + k)
    humans_seen = 0
    for _ in range(8):
        outputs = random_decode_outputs(rng, k, peak_prob, accept_prob)
        peaks_n, humans_n = assembly.assemble_humans(
            *outputs, use_native=True, skeleton=BODY_25)
        peaks_p, humans_p = assembly.assemble_humans(
            *outputs, use_native=False, skeleton=BODY_25)
        np.testing.assert_array_equal(peaks_n, peaks_p)
        assert_same_humans(humans_n, humans_p)
        humans_seen += len(humans_p)
    assert humans_seen > 0


def test_the_native_default_is_cocos_rule():
    """``assemble_humans``' default skeleton is COCO-18's, limbs and
    starting rule, on the C++ path too; the C++ entry takes both from its
    caller and refuses another skeleton's rule."""
    assert native.native_available(), native.build_error()
    rng = np.random.default_rng(4)
    coords = rng.integers(0, 200, size=(18, 3, 2)).astype(np.int32)
    scores = rng.uniform(0.1, 1.0, size=(18, 3)).astype(np.float32)
    valid = np.ones((18, 3), bool)
    reg = rng.uniform(-0.5, 1.0, size=(19, 3, 3)).astype(np.float32)
    accept = rng.uniform(size=(19, 3, 3)) < 0.6
    _, humans = assembly.assemble_humans(coords, scores, valid, reg, accept)
    counts = np.full(18, 3)
    offsets = np.arange(18) * 3
    args = (scores, counts, offsets, reg, accept, COCO_18.limbseq)
    np.testing.assert_array_equal(
        humans, native.assemble_humans_native(*args, COCO_18.starts))
    assert len(humans) > 0
    with pytest.raises(TypeError):
        native.assemble_humans_native(*args)
    with pytest.raises(ValueError, match="inconsistent"):
        native.assemble_humans_native(*args, BODY_25.starts)
