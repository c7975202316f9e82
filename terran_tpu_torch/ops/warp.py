"""Similarity-transform estimation and the affine warp of face alignment.

The port of the per-pixel path of ``terran_tpu/ops/warp.py``, which
replaces the reference's skimage ``SimilarityTransform.estimate`` + PIL
``Image.transform(AFFINE, BILINEAR)`` (arcface/wrapper.py:52-69):

- :func:`umeyama`, :func:`alignment_matrix`, :func:`alignment_matrices`:
  the closed-form least-squares similarity (Umeyama 1991), host numpy,
  copied from the JAX package;
- :func:`umeyama_torch`, :func:`inverse_similarity`,
  :func:`alignment_matrices_torch`: the same alignment in float32 on the
  landmarks' device, for the pipeline's fused embed mode;
- :func:`warp_affine`, :func:`warp_affine_batch`,
  :func:`warp_affine_frames`: bilinear inverse-warp sampling on the
  image's device in PIL's convention (transform evaluated at output pixel
  centres, inside test on the raw source coordinates, taps clamped to the
  image, fill 0), for one image or a batch of frames in one gather;
- :func:`warp_affine_u8_batch_numpy` and :func:`warp_affine_u8_batch_cv2`:
  the pipeline's 'host' transfer plan warps on the host, uint8 out, by
  copies of the JAX package's numpy twin of the warp and its OpenCV form.

The JAX package's windowed and grouped-slab warps gather the same crops
from per-face windows to cut a TPU gather's operand-proportional cost;
they are bit-identical to the full-frame warp, which this port keeps.
"""

import numpy as np
import torch

from terran_tpu_torch.runtime import device_constant

# Canonical 5-landmark destination template for 112x112 alignment
# (arcface/wrapper.py:39-48, including the +8px x-shift for width 112).
ARCFACE_TEMPLATE = np.array(
    [
        [38.2946, 51.6963],
        [73.5318, 51.5014],
        [56.0252, 71.7366],
        [41.5493, 92.3655],
        [70.7299, 92.2041],
    ],
    dtype=np.float32,
)


def umeyama(src, dst):
    """Least-squares similarity transform mapping ``src`` points to
    ``dst``: a (3, 3) matrix ``T`` with ``T @ [x, y, 1] ~= [x', y', 1]``,
    as skimage ``SimilarityTransform.estimate(src, dst)``."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    n, d = src.shape

    mu_src = src.mean(axis=0)
    mu_dst = dst.mean(axis=0)
    src_c = src - mu_src
    dst_c = dst - mu_dst

    cov = dst_c.T @ src_c / n
    u, s, vt = np.linalg.svd(cov)

    sign = np.ones(d)
    if np.linalg.det(cov) < 0:
        sign[-1] = -1
    rank = np.linalg.matrix_rank(cov)
    if rank == d - 1:
        if np.linalg.det(u) * np.linalg.det(vt) < 0:
            sign[-1] = -1
    rotation = u @ np.diag(sign) @ vt

    var_src = (src_c ** 2).sum() / n
    scale = (s * sign).sum() / var_src if var_src > 0 else 1.0

    t = np.eye(3)
    t[:d, :d] = scale * rotation
    t[:d, d] = mu_dst - scale * rotation @ mu_src
    return t.astype(np.float32)


def alignment_matrix(landmarks, template=ARCFACE_TEMPLATE):
    """Inverse (output->input) 2x3 matrix aligning a face to the template:
    the reference estimates landmarks->template and hands PIL the inverse
    (wrapper.py:52-61)."""
    forward = umeyama(np.asarray(landmarks, dtype=np.float32), template)
    return np.linalg.inv(forward)[:2].astype(np.float32)


def alignment_matrices(landmarks, template=ARCFACE_TEMPLATE):
    """Batched :func:`alignment_matrix`: (M, 5, 2) -> (M, 2, 3), one
    vectorised solve with the scalar path's float64 arithmetic, 2x2 SVDs
    and reflection/rank guards."""
    src = np.asarray(landmarks, dtype=np.float64)
    if src.ndim != 3:
        raise ValueError("expected (M, points, 2) landmarks")
    m, n, d = src.shape
    dst = np.asarray(template, dtype=np.float64)

    mu_src = src.mean(axis=1)
    mu_dst = dst.mean(axis=0)
    src_c = src - mu_src[:, None]
    dst_c = dst - mu_dst

    cov = np.einsum("ki,mkj->mij", dst_c, src_c) / n
    u, s, vt = np.linalg.svd(cov)

    sign = np.ones((m, d))
    neg_det = np.linalg.det(cov) < 0
    sign[neg_det, -1] = -1
    # Rank-deficient (collinear) guard: rank d-1 flips the sign when
    # det(u) * det(vt) < 0.
    tol = s[:, 0] * max(cov.shape[1:]) * np.finfo(np.float64).eps
    rank = (s > tol[:, None]).sum(axis=1)
    flip = (rank == d - 1) & (np.linalg.det(u) * np.linalg.det(vt) < 0)
    sign[flip & ~neg_det, -1] = -1

    rotation = u * sign[:, None, :] @ vt
    var_src = (src_c ** 2).sum(axis=(1, 2)) / n
    scale = np.where(
        var_src > 0, (s * sign).sum(axis=1) / np.where(var_src > 0,
                                                       var_src, 1.0), 1.0
    )

    forward = np.zeros((m, 3, 3))
    forward[:, :d, :d] = scale[:, None, None] * rotation
    forward[:, :d, d] = mu_dst - np.einsum(
        "mij,mj->mi", scale[:, None, None] * rotation, mu_src
    )
    forward[:, d, d] = 1.0
    # The scalar path inverts the float32 matrix; so does this one.
    inverse = np.linalg.inv(forward.astype(np.float32))
    return inverse[:, :2].astype(np.float32)


def _blend_taps(p00, p01, p10, p11, x0i, y0i, fx, fy, inside, h, w):
    """PIL's edge replication and the bilinear lerp. ``p_ab`` are the taps
    at the clamped patch origin (+a rows, +b cols): at y0 == -1 both tap
    rows are source row 0, at y0 == h-1 both are row h-1; the same for
    columns."""
    ly = (y0i == -1)[..., None]
    hy = (y0i == h - 1)[..., None]
    lx = (x0i == -1)[..., None]
    hx = (x0i == w - 1)[..., None]
    r0c0 = torch.where(hy, p10, p00)
    r0c1 = torch.where(hy, p11, p01)
    r1c0 = torch.where(ly, p00, p10)
    r1c1 = torch.where(ly, p01, p11)
    v00 = torch.where(hx, r0c1, r0c0)
    v01 = torch.where(lx, r0c0, r0c1)
    v10 = torch.where(hx, r1c1, r1c0)
    v11 = torch.where(lx, r1c0, r1c1)

    fx = fx[..., None]
    fy = fy[..., None]
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    out = top * (1 - fy) + bot * fy
    return torch.where(inside[..., None], out, 0.0)


def _edge_padded(images, h, w):
    """(..., h, w, C) edge-padded to at least 2x2 along (h, w)."""
    if h >= 2 and w >= 2:
        return images
    dev = images.device
    rows = torch.arange(max(h, 2), device=dev).clamp(max=h - 1)
    cols = torch.arange(max(w, 2), device=dev).clamp(max=w - 1)
    return images.index_select(-3, rows).index_select(-2, cols)


def _warp(flat, base, phys_h, phys_w, h, w, matrices, out_h, out_w):
    """The per-pixel warp of (M, 2, 3) float32 ``matrices`` on the card of
    ``flat``, the (frames x phys_h x phys_w, C) pixels of one or more
    sources; ``base`` (M, 1, 1) or 0 is each crop's first pixel in
    ``flat``. Returns (M, out_h, out_w, C) float32."""
    dev = flat.device
    m = matrices[:, :, :, None, None]  # (M, 2, 3, 1, 1)

    ys = torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")  # (out_h, out_w)

    raw_x = m[:, 0, 0] * xg + m[:, 0, 1] * yg + m[:, 0, 2]
    raw_y = m[:, 1, 0] * xg + m[:, 1, 1] * yg + m[:, 1, 2]
    inside = (raw_x >= 0) & (raw_x < w) & (raw_y >= 0) & (raw_y < h)

    src_x = raw_x - 0.5
    src_y = raw_y - 0.5
    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    fx = src_x - x0
    fy = src_y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)

    oy = torch.clamp(y0i, 0, phys_h - 2).to(torch.int64)
    ox = torch.clamp(x0i, 0, phys_w - 2).to(torch.int64)
    origin = base + oy * phys_w + ox

    def tap(dy, dx):
        return flat[origin + (dy * phys_w + dx)].to(torch.float32)

    return _blend_taps(tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1),
                       x0i, y0i, fx, fy, inside, h, w)


def warp_affine_batch(image, matrices, out_h=112, out_w=112):
    """Warp crops out of one (H, W, C) image (any dtype, on any device) by
    (K, 2, 3) output->input matrices -> (K, out_h, out_w, C) float32 on the
    image's device.

    PIL convention: the transform is evaluated at output pixel centres
    and the inside test is on those raw coordinates in [0, size); the
    sample point is shifted by -0.5 and its 2x2 taps are clamped to the
    image (edge replication); outside pixels are 0. The taps are gathered
    from the unpadded image at a patch origin clamped to [0, size-2],
    then :func:`_blend_taps` restores the edge replication, as
    ``terran_tpu/ops/warp.py::_warp_affine_core`` does. A source smaller
    than 2x2 is edge-padded to 2x2 first; ``h``/``w`` stay the logical
    size.
    """
    h, w, c = image.shape
    image = _edge_padded(image, h, w)
    phys_h, phys_w = image.shape[:2]
    m = torch.as_tensor(matrices, dtype=torch.float32, device=image.device)
    return _warp(image.reshape(phys_h * phys_w, c), 0, phys_h, phys_w, h, w,
                 m.reshape(-1, 2, 3), out_h, out_w)


def warp_affine_frames(frames, matrices, out_h=112, out_w=112):
    """:func:`warp_affine_batch` over a batch in one gather: (B, H, W, C)
    ``frames`` and (B, K, 2, 3) ``matrices`` (a tensor on the frames'
    device) -> (B, K, out_h, out_w, C) float32, bit for bit
    ``warp_affine_batch(frames[b], matrices[b])`` for each frame ``b``."""
    b, h, w, c = frames.shape
    frames = _edge_padded(frames, h, w)
    phys_h, phys_w = frames.shape[1:3]
    k = matrices.shape[1]
    base = (torch.arange(b, device=frames.device) * (phys_h * phys_w))
    base = base.repeat_interleave(k)[:, None, None]
    crops = _warp(frames.reshape(b * phys_h * phys_w, c), base, phys_h,
                  phys_w, h, w, matrices.to(torch.float32).reshape(-1, 2, 3),
                  out_h, out_w)
    return crops.reshape(b, k, out_h, out_w, c)


def warp_affine(image, matrix, out_h=112, out_w=112):
    """:func:`warp_affine_batch` for one (2, 3) matrix -> (out_h, out_w,
    C) float32."""
    return warp_affine_batch(image, matrix, out_h, out_w)[0]


def warp_affine_u8_batch_numpy(image, matrices, out_h=112, out_w=112):
    """Host (numpy) twin of :func:`warp_affine_batch`, rounded to uint8:
    one (H, W, C) uint8 image and (M, 2, 3) matrices -> (M, out_h, out_w,
    C) uint8.

    A copy of ``terran_tpu/ops/warp.py::warp_affine_u8_batch_numpy``:
    the per-pixel warp and its edge selects operation for operation in the
    same float32 order, rounded half-to-even. A source smaller than 2x2 is
    edge-padded first; non-finite matrices fall out through the inside
    test as fill. About 4.7 ms a 112x112 crop on one core (the JAX
    package's measurement).
    """
    image = np.asarray(image)
    h, w = image.shape[0], image.shape[1]
    if h < 2 or w < 2:
        image = np.pad(
            image, ((0, max(0, 2 - h)), (0, max(0, 2 - w)), (0, 0)),
            mode="edge",
        )
    c = image.shape[2]
    mats = np.asarray(matrices, dtype=np.float32)  # (M, 2, 3)

    ys = np.arange(out_h, dtype=np.float32) + 0.5
    xs = np.arange(out_w, dtype=np.float32) + 0.5
    xg, yg = np.meshgrid(xs, ys)  # (out_h, out_w)

    with np.errstate(invalid="ignore", over="ignore"):
        raw_x = (mats[:, 0, 0, None, None] * xg
                 + mats[:, 0, 1, None, None] * yg
                 + mats[:, 0, 2, None, None])
        raw_y = (mats[:, 1, 0, None, None] * xg
                 + mats[:, 1, 1, None, None] * yg
                 + mats[:, 1, 2, None, None])
        inside = (raw_x >= 0) & (raw_x < w) & (raw_y >= 0) & (raw_y < h)

        src_x = raw_x - np.float32(0.5)
        src_y = raw_y - np.float32(0.5)
        x0 = np.floor(src_x)
        y0 = np.floor(src_y)
        fx = (src_x - x0)[..., None]
        fy = (src_y - y0)[..., None]
        x0i = x0.astype(np.int32)
        y0i = y0.astype(np.int32)

    oy = np.clip(y0i, 0, image.shape[0] - 2)
    ox = np.clip(x0i, 0, image.shape[1] - 2)
    flat = image.reshape(-1, c)
    base = oy.astype(np.int64) * image.shape[1] + ox
    p00 = flat[base].astype(np.float32)  # (M, out_h, out_w, C)
    p01 = flat[base + 1].astype(np.float32)
    p10 = flat[base + image.shape[1]].astype(np.float32)
    p11 = flat[base + image.shape[1] + 1].astype(np.float32)

    # Edge-replication selects, as in _blend_taps.
    ly = (y0i == -1)[..., None]
    hy = (y0i == h - 1)[..., None]
    lx = (x0i == -1)[..., None]
    hx = (x0i == w - 1)[..., None]
    r0c0 = np.where(hy, p10, p00)
    r0c1 = np.where(hy, p11, p01)
    r1c0 = np.where(ly, p00, p10)
    r1c1 = np.where(ly, p01, p11)
    v00 = np.where(hx, r0c1, r0c0)
    v01 = np.where(lx, r0c0, r0c1)
    v10 = np.where(hx, r1c1, r1c0)
    v11 = np.where(lx, r1c0, r1c1)

    with np.errstate(invalid="ignore"):
        top = v00 * (1 - fx) + v01 * fx
        bot = v10 * (1 - fx) + v11 * fx
        out = top * (1 - fy) + bot * fy
        out = np.where(inside[..., None], out, np.float32(0.0))
        return np.rint(out).astype(np.uint8)


def warp_affine_u8_batch_cv2(image, matrices, out_h=112, out_w=112):
    """:func:`warp_affine_u8_batch_numpy` by ``cv2.warpAffine``
    (INTER_LINEAR, 5-bit fixed-point weights), within one count of it; a
    copy of ``terran_tpu/ops/warp.py::warp_affine_u8_batch_cv2``. Raises
    ``ImportError`` where OpenCV is not installed.

    The matrices map output pixel centres (half-integer convention) to raw
    source coordinates; ``WARP_INVERSE_MAP`` expects integer-centre maps,
    so the translation column shifts by ``M @ (0.5, 0.5, 0) - 0.5``.
    ``BORDER_REPLICATE`` gives the edge-tap replication, and samples whose
    centre falls outside the frame are zeroed afterwards (the inside test),
    only for faces whose crop-corner preimages leave the frame (the map is
    affine, so the corners bound every sample). Non-finite matrices give
    zero crops.
    """
    import cv2

    image = np.asarray(image)
    h, w = image.shape[0], image.shape[1]
    mats = np.asarray(matrices, dtype=np.float32)  # (M, 2, 3)
    m = mats.shape[0]
    out = np.zeros((m, out_h, out_w) + image.shape[2:], np.uint8)

    corners = np.array(
        [[0.5, 0.5], [out_w - 0.5, 0.5],
         [0.5, out_h - 0.5], [out_w - 0.5, out_h - 0.5]], np.float32
    )
    # (M, 4, 2) raw-coordinate preimages of the output corners.
    pre = (np.einsum("pk,mjk->mpj", corners, mats[:, :, :2])
           + mats[:, None, :, 2])

    flags = cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP
    for i in range(m):
        mat = mats[i]
        if not np.isfinite(mat).all():
            continue
        m_cv = mat.copy()
        m_cv[:, 2] = 0.5 * (mat[:, 0] + mat[:, 1]) + mat[:, 2] - 0.5
        out[i] = cv2.warpAffine(
            image, m_cv, (out_w, out_h), flags=flags,
            borderMode=cv2.BORDER_REPLICATE,
        )
        pi = pre[i]
        if not ((pi[:, 0] >= 0).all() and (pi[:, 0] < w).all()
                and (pi[:, 1] >= 0).all() and (pi[:, 1] < h).all()):
            ys = np.arange(out_h, dtype=np.float32) + 0.5
            xs = np.arange(out_w, dtype=np.float32) + 0.5
            xg, yg = np.meshgrid(xs, ys)
            raw_x = mat[0, 0] * xg + mat[0, 1] * yg + mat[0, 2]
            raw_y = mat[1, 0] * xg + mat[1, 1] * yg + mat[1, 2]
            inside = ((raw_x >= 0) & (raw_x < w)
                      & (raw_y >= 0) & (raw_y < h))
            # A channel-less (H, W) source takes the 2-D mask as it is.
            if out[i].ndim == 3:
                inside = inside[..., None]
            out[i] = np.where(inside, out[i], 0)
    return out


def umeyama_torch(src, dst):
    """The similarity of :func:`umeyama` on ``src``'s device, float32: (...,
    n, 2) ``src`` and (n, 2) ``dst`` points -> (..., 3, 3) forward matrices,
    the counterpart of ``terran_tpu/ops/warp.py::umeyama_jax``.

    It keeps that function's full-rank reflection guard (the rotation is
    proper) and its 1e-12 floor on the source variance. In two dimensions
    the guarded solution needs no SVD: with cov = [[a, b], [c, d]], the
    rotation is the angle atan2(c - b, a + d) and the guarded singular
    value sum is |(a + d, c - b)|. ``torch.linalg``'s SVD and determinant
    check their status on the host, which would wait for the card.
    """
    if src.shape[-1] != 2:
        raise ValueError(f"expected 2-D points, got {tuple(src.shape)}")
    src = src.to(torch.float32)
    dst = dst.to(torch.float32)
    n = src.shape[-2]
    src_c = src - src.mean(dim=-2, keepdim=True)
    mu_src = src.mean(dim=-2)
    mu_dst = dst.mean(dim=-2)
    dst_c = dst - mu_dst

    cov = torch.einsum("ki,...kj->...ij", dst_c, src_c) / n
    x = cov[..., 0, 0] + cov[..., 1, 1]
    y = cov[..., 1, 0] - cov[..., 0, 1]
    norm = torch.sqrt(x * x + y * y)
    degenerate = norm == 0
    safe = torch.where(degenerate, 1.0, norm)
    cos = torch.where(degenerate, 1.0, x / safe)
    sin = torch.where(degenerate, 0.0, y / safe)
    rotation = torch.stack([torch.stack([cos, -sin], -1),
                            torch.stack([sin, cos], -1)], -2)

    var_src = torch.clamp_min((src_c * src_c).sum(dim=(-2, -1)) / n, 1e-12)
    scaled = (norm / var_src)[..., None, None] * rotation
    shift = mu_dst - (scaled @ mu_src[..., None])[..., 0]
    top = torch.cat([scaled, shift[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 3), dtype=top.dtype,
                         device=top.device)
    bottom[..., 0, 2] = 1.0
    return torch.cat([top, bottom], dim=-2)


def inverse_similarity(matrix3):
    """(..., 3, 3) similarity transforms -> the (..., 2, 3) block of their
    inverses that the warp consumes (``terran_tpu/ops/warp.py::
    inverse_similarity``), by the 2x2 adjugate: no host status check."""
    a, b = matrix3[..., 0, 0], matrix3[..., 0, 1]
    c, d = matrix3[..., 1, 0], matrix3[..., 1, 1]
    det = a * d - b * c
    inv_a = torch.stack([torch.stack([d, -b], -1),
                         torch.stack([-c, a], -1)], -2) / det[..., None, None]
    t = matrix3[..., :2, 2:]
    return torch.cat([inv_a, -(inv_a @ t)], dim=-1)


def alignment_matrices_torch(landmarks, template=ARCFACE_TEMPLATE):
    """(..., 5, 2) landmarks -> (..., 2, 3) float32 output->input alignment
    matrices on the landmarks' device (``terran_tpu/ops/warp.py::
    alignment_matrices_jax``), for the fused embed mode of the pipeline."""
    dst = device_constant(tuple(map(tuple, np.asarray(template).tolist())),
                          torch.float32, landmarks.device)
    return inverse_similarity(umeyama_torch(landmarks, dst))
