"""Fused full-perception pipeline: detect + align + embed + pose, on the card.

The port of ``terran_tpu/pipeline.py`` on one CUDA card. Under the device
plan (``transfer_plan='device'``, the default) a batch of raw uint8 frames
crosses to the card once and stays there for detection, alignment and
pose; only fixed-shape result tables come back. Per batch:

1. the perception step: resize on the card, RetinaFace forward, anchor
   decode and fixed-K NMS (the ``csrc/nms.cu`` kernels), coordinates
   scaled back and rounded, all packed into one (B, K, 17) table. With
   ``embed_dispatch='fused'`` the on-card alignment and warp of every slot
   and a fixed-capacity FaceResNet100 forward follow with no host round
   trip;
2. ``embed_dispatch='adaptive'`` (the default): once the detections reach
   the host, one FaceResNet100 forward for the whole batch over the
   detected faces, sized by bucket, warped from the resident frames with
   the host's float64 Umeyama matrices;
3. pose: the OpenPose forward and the fused x8 upsample + peak scan (the
   ``csrc/fused_peaks.cu`` kernels); with ``limb_dispatch='adaptive'``
   the PAF x8 upsample and the limb scores run in a second step sized to
   the peaks found.

The 'host' plan (``transfer_plan='host'``) uploads derived inputs
instead: the frames are resized on the host to the detection and pose
sizes (``host_resize``: OpenCV's fixed point, or the 'exact' chain, this
package's bilinear on the CPU), and once the detections are back, an
embed worker thread warps each face on the host and uploads only the
(B, k, 112, 112, 3) uint8 crops and their mask. The device programs are
the same perception step, pose front, limbs and crops+mask embed.

Device work is enqueued on one CUDA stream and never waited on while it
is enqueued: the host decisions (overflow, face and peak counts) run in
``advance_batch`` on tables fetched through pinned memory. Uploads run on
a second stream, from pinned staging. ``process_stream`` dispatches batch
*i+1* before batch *i*'s host stages run, as the JAX class does.

``recognizer='vit_l'`` embeds with the ViT-L of insightface's
``arcface_torch`` (``models/vit.py``) in FaceResNet100's place, through the
same programs. ``pose='body25'`` runs OpenPose's BODY_25
(``models/body25.py``: 25 parts, 26 limbs) in the COCO model's place,
through the same pose programs, peak kernels, limb table and assembly,
each taking the family's ``ops.pose_decode.Skeleton``.
``embed_precision='int8'`` and ``pose_precision='int8'``
(opt-in, off by default) run FaceResNet100 and OpenPose with int8 convs
(``models/quant.py``), quantised from the float32 weights before the
other leaves are cast to the compute dtype.

With ``mesh`` (``parallel.mesh.create_mesh``: one process per card under
``torch.distributed``), every rank calls the pipeline with the same global
batch and gets the global result. A batch is padded to a multiple of the
mesh size (``pad_batch_to_multiple``'s rule); each rank uploads and runs
only its own rows, and each fixed-shape device output is all-gathered in
rank order on the compute stream before its one host fetch. Every bucket
and escalation choice reads those gathered global tables, the same bytes
on every rank, so the ranks choose alike and gather alike shapes. The
int8 trunks all-reduce each conv's activation scale over the mesh, so
that a split batch quantises as the whole batch; every collective is
issued from the calling thread, in one order on every rank.

On a CUDA card without a mesh, under the 'device' plan and with no int8
trunk (:func:`graphs_eligible`), ``warmup`` captures each device program
it runs as a CUDA graph, at each shape and bucket, and a later call at
that shape replays the graph in place of the program's eager launches
(``graph_calls`` counts both kinds of call).

``limb_backend='matmul'`` (a TPU cost reformulation of the gather form)
raises ``NotImplementedError``.
The JAX class's windowed and grouped-slab embed warps, also TPU cost
reformulations, give the full-frame warp's crops bit for bit; this port
warps from the full frames, and ``pipeline_embed_windows`` has no effect
here.
"""

import contextlib
import functools
import itertools
import threading
import time
import weakref
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from terran_tpu_torch.models import (
    FAMILIES, POSE_FAMILIES, RECOGNIZERS, load_model,
)
from terran_tpu_torch.models.arcface import (
    EMBEDDING_DIM, normalize_embeddings,
)
from terran_tpu_torch.models.quant import reduce_activation_scales
from terran_tpu_torch.models.retinaface import (
    make_detect_fn, unpack_detections,
)
from terran_tpu_torch.ops.fused_peaks import fused_peaks_enabled
from terran_tpu_torch.ops.pose_decode import (
    forward_and_find_peaks, limb_table, pack_peaks, unpack_pose_outputs,
)
from terran_tpu_torch.ops.resize import (
    resize_bilinear_u8, resize_bilinear_u8_cv2, resize_bilinear_u8_host,
    resized_shape,
)
from terran_tpu_torch.ops.warp import (
    alignment_matrices, alignment_matrices_torch, warp_affine_frames,
    warp_affine_u8_batch_cv2, warp_affine_u8_batch_numpy,
)
from terran_tpu_torch.parallel.mesh import (
    all_gather_rows, own_rows, shard_params,
)
from terran_tpu_torch.pose.assembly import assemble_humans, get_keypoints
from terran_tpu_torch.runtime import (
    check_precision, default_policy, resolve_device,
)
from terran_tpu_torch.utils.profiling import (
    NO_RANGE, profiler_range, profiling,
)

CROP_SIDE = 112  # the FaceResNet100 input


def _resolve_dispatch(name, mode):
    """'auto' -> 'adaptive'."""
    if mode == "auto":
        return "adaptive"
    if mode not in ("adaptive", "fused"):
        raise ValueError(f"unknown {name} {mode!r}")
    return mode


def _buckets(setting):
    return sorted(int(x) for x in str(setting).split(",") if str(x).strip())


def graphs_eligible(device, mesh, transfer_plan, embed_precision,
                    pose_precision):
    """Whether a pipeline with these settings captures its device programs
    as CUDA graphs: on a CUDA card, without a mesh (whose programs run
    NCCL collectives) and under the 'device' plan (the 'host' plan's embed
    runs on a worker thread). A pipeline with an int8 trunk stays eager
    for now: its conv ranges and ``_int_mm`` host ops are only recorded
    on eager launches, until the trace pairs replayed kernels by
    correlation id (ROADMAP Queue 4 item 7)."""
    return (torch.device(device).type == "cuda" and mesh is None
            and transfer_plan == "device"
            and "int8" not in (embed_precision, pose_precision))


def _signature(args):
    """What a captured graph's inputs must match: each tensor's shape,
    dtype and device."""
    return tuple((tuple(a.shape), a.dtype, a.device) for a in args)


def _map_outputs(fn, out):
    """``fn`` over a program's outputs: a tensor, a tuple or a dict."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {key: fn(value) for key, value in out.items()}
    return tuple(fn(value) for value in out)


class _Graph:
    """A device program captured once as a CUDA graph over static copies
    of its inputs. A call copies its inputs into those buffers, replays
    the graph and returns copies of its outputs, all on the current
    stream, so that nothing the caller keeps aliases a buffer that a later
    replay overwrites (``process_stream`` reads a batch's PAF after two
    later batches' pose graphs have run)."""

    def __init__(self, fn, args):
        self.inputs = tuple(a.clone() for a in args)
        # One eager run on the capture stream first, as torch.cuda.graph's
        # documentation asks, then the capture; the caller's stream waits
        # for both.
        stream = torch.cuda.Stream(self.inputs[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(stream)

    def __call__(self, *args):
        for buffer, arg in zip(self.inputs, args):
            buffer.copy_(arg)
        self.graph.replay()
        return _map_outputs(torch.Tensor.clone, self.outputs)


class _DeviceSpan:
    """The device time of the work enqueued on the current stream between
    this object's making and :meth:`stop`: a CUDA event pair on a card,
    recorded around a program's call and so outside any graph that the
    call replays; the host clock elsewhere, where each op runs as it is
    called."""

    def __init__(self, device):
        if device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start, self._end = time.perf_counter(), None

    def stop(self):
        if self._end is None:
            self._end = time.perf_counter()
        else:
            self._end.record()

    def seconds(self):
        """The elapsed seconds; on a card, waits for the end event."""
        if isinstance(self._end, float):
            return self._end - self._start
        self._end.synchronize()
        return self._start.elapsed_time(self._end) / 1e3


class _Fetch:
    """A device tensor's copy to the host, started when made: for a CUDA
    tensor a non-blocking copy into pinned memory on the current stream,
    and an event that :meth:`numpy` waits on before it reads (reading
    before the event gives stale data with no error). ``span``: the
    :class:`_DeviceSpan` of the program that made the tensor, or None."""

    def __init__(self, tensor, span=None):
        self.span = span
        self.nbytes = tensor.nbytes
        if tensor.device.type == "cuda":
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                     pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record()
        else:
            self._host, self._done = tensor, None

    def numpy(self):
        if self._done is not None:
            self._done.synchronize()
        return self._host.numpy()


def _device_work(method):
    """Run ``method`` in inference mode with the pipeline's compute stream
    current, so that every launch and copy it makes is ordered on it."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with torch.inference_mode(), torch.cuda.stream(self._stream):
            return method(self, *args, **kwargs)

    return run


class PerceptionPipeline:
    """End-to-end detect+embed+pose over frame batches.

    Parameters default to the checkpoint store; pass explicit params for
    testing, as this package's state dicts or as the ``terran_tpu``
    pytrees the JAX class takes. ``device``: where the models run, the
    CUDA card unless the caller names another (``"cpu"``). ``mesh``
    (``parallel.mesh.Mesh``) turns on data-parallel execution over the
    frame axis, on the mesh's device; every rank then makes the same
    calls with the same global batches, since each call runs collectives.
    ``recognizer``: the family that embeds the faces, ``'arcface'``
    (FaceResNet100, the default) or ``'vit_l'`` (the ViT of insightface's
    ``arcface_torch``, :class:`~terran_tpu_torch.models.vit.ViTRecognizer`,
    whose ``rec_params`` come from ``utils.convert.convert_vit_l``; it has
    no int8 trunk and no checkpoint in the store). ``pose``: the pose
    family, ``'openpose'`` (the COCO body model, 18 parts, the default) or
    ``'body25'`` (OpenPose's BODY_25,
    :class:`~terran_tpu_torch.models.body25.Body25Model`, whose
    ``pose_params`` come from ``utils.convert.convert_body25``; it has no
    int8 trunk and no checkpoint in the store).
    """

    def __init__(self, det_params=None, rec_params=None, pose_params=None,
                 det_short_side=None, pose_short_side=None, threshold=None,
                 nms_threshold=None, top_k=None, max_faces=None,
                 max_peaks=None, compute_dtype=None, mesh=None,
                 with_pose=True, with_embeddings=True, timer=None,
                 embed_dispatch=None, limb_dispatch=None,
                 max_escalations=None, transfer_plan=None,
                 embed_precision=None, pose_precision=None,
                 host_resize=None, device=None, recognizer="arcface",
                 pose="openpose"):
        from terran_tpu_torch.checkpoint import load_checkpoint_params
        from terran_tpu_torch.config import get_config

        cfg = get_config()
        self.mesh = mesh
        self.embed_precision = check_precision(
            "embed_precision",
            cfg.embed_precision if embed_precision is None
            else embed_precision,
        )
        self.pose_precision = check_precision(
            "pose_precision",
            cfg.pose_precision if pose_precision is None else pose_precision,
        )
        if recognizer not in RECOGNIZERS:
            raise ValueError(f"recognizer must be one of {RECOGNIZERS}, got "
                             f"{recognizer!r}")
        if (self.embed_precision == "int8"
                and FAMILIES[recognizer].int8 is None):
            raise ValueError(f"embed_precision='int8': the {recognizer!r} "
                             "recognizer has no int8 trunk")
        self.recognizer = recognizer
        if pose not in POSE_FAMILIES:
            raise ValueError(f"pose must be one of {POSE_FAMILIES}, got "
                             f"{pose!r}")
        if self.pose_precision == "int8" and FAMILIES[pose].int8 is None:
            raise ValueError(f"pose_precision='int8': the {pose!r} pose "
                             "family has no int8 trunk")
        self.pose = pose
        self.skeleton = FAMILIES[pose].skeleton
        self.with_pose = with_pose
        self.with_embeddings = with_embeddings
        self.embed_dispatch = _resolve_dispatch(
            "embed_dispatch",
            cfg.embed_dispatch if embed_dispatch is None else embed_dispatch,
        )
        self.limb_dispatch = _resolve_dispatch(
            "limb_dispatch",
            cfg.limb_dispatch if limb_dispatch is None else limb_dispatch,
        )

        # Transfer plan: what crosses the host->device link per batch.
        # 'device': the raw uint8 frames, once. 'host': the detection and
        # pose resizes, then each face's 112x112 crop, ~4.4x fewer bytes
        # at 1080p with 8 faces a frame, for host CPU work in exchange.
        self.transfer_plan = (
            cfg.transfer_plan if transfer_plan is None else transfer_plan
        )
        if self.transfer_plan not in ("device", "host"):
            raise ValueError(
                f"transfer_plan must be 'device' or 'host', got "
                f"{self.transfer_plan!r}"
            )
        # Host resize and warp backend: 'auto' takes OpenCV where it
        # imports (the reference's own host arithmetic, within one count
        # of the device's), else the 'exact' chain; 'cv2' requires it.
        self.host_resize = (
            cfg.host_resize if host_resize is None else host_resize
        )
        if self.host_resize not in ("auto", "exact", "cv2"):
            raise ValueError(
                f"host_resize must be 'auto', 'exact', or 'cv2', got "
                f"{self.host_resize!r}"
            )
        self._host_cv2 = None
        if self.host_resize == "cv2" or self.transfer_plan == "host":
            # A missing OpenCV surfaces here, not in the embed worker.
            self._uses_cv2()
        if self.transfer_plan == "host":
            if with_embeddings and self.embed_dispatch != "adaptive":
                raise ValueError(
                    "transfer_plan='host' requires embed_dispatch="
                    "'adaptive' (the fused program warps crops from the "
                    "full frames, which never reach the device)"
                )
            if with_pose and self.limb_dispatch != "adaptive":
                raise ValueError(
                    "transfer_plan='host' requires limb_dispatch="
                    "'adaptive'"
                )
        # PAF sampler backend: 'auto' is the gather form off the TPU.
        self.limb_backend = cfg.limb_backend
        if self.limb_backend == "auto":
            self.limb_backend = "gather"
        if self.limb_backend not in ("matmul", "gather"):
            raise ValueError(
                f"limb_backend must be 'auto', 'matmul', or 'gather', "
                f"got {self.limb_backend!r}"
            )
        if self.limb_backend == "matmul":
            raise NotImplementedError(
                "limb_backend='matmul' is a TPU cost reformulation of the "
                "gather form, which this package runs (ROADMAP.md, Queue 1)"
            )

        self.det_short_side = (
            cfg.detection_short_side if det_short_side is None
            else det_short_side
        )
        self.pose_short_side = (
            cfg.pose_short_side if pose_short_side is None
            else pose_short_side
        )
        self.threshold = (
            cfg.detection_threshold if threshold is None else threshold
        )
        self.nms_threshold = (
            cfg.nms_iou_threshold if nms_threshold is None else nms_threshold
        )
        self.top_k = cfg.pipeline_top_k if top_k is None else top_k
        self.max_faces = (
            cfg.pipeline_max_faces if max_faces is None else max_faces
        )
        self.max_peaks = (
            cfg.max_peaks_per_part if max_peaks is None else max_peaks
        )
        # Overflow escalation: saturated batches re-dispatch at doubled
        # capacity. Counters are cumulative over the pipeline's lifetime.
        self.max_escalations = (
            cfg.max_escalations if max_escalations is None
            else max_escalations
        )
        self.escalations = {"detect": 0, "pose": 0, "embed": 0}
        # Device-program calls that replayed a captured CUDA graph, and
        # those that ran the program's eager launches.
        self.graph_calls = {"replayed": 0, "eager": 0}
        # Host->device upload bytes of every put_frames / _put_batch call.
        # The stream's uploader thread and the main loop both add to it,
        # and the 'host' plan's embed worker counts its program calls.
        self.upload_bytes = 0
        self._counts_lock = threading.Lock()

        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # Tensors report their card's index: 'cuda' != 'cuda:0'.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if det_params is None:
            det_params = load_checkpoint_params(
                FAMILIES["retinaface"].checkpoint)
        if rec_params is None and with_embeddings:
            if FAMILIES[recognizer].checkpoint is None:
                raise ValueError(f"recognizer={recognizer!r} needs "
                                 "rec_params: the store has no checkpoint")
            rec_params = load_checkpoint_params(
                FAMILIES[recognizer].checkpoint)
        if pose_params is None and with_pose:
            if FAMILIES[pose].checkpoint is None:
                raise ValueError(f"pose={pose!r} needs pose_params: the "
                                 "store has no checkpoint")
            pose_params = load_checkpoint_params(FAMILIES[pose].checkpoint)

        cuda = self.device.type == "cuda"
        # All device work is ordered on one compute stream; uploads run
        # on their own stream.
        self._stream = torch.cuda.current_stream(self.device) if cuda else None
        self._upload_stream = torch.cuda.Stream(self.device) if cuda else None

        dtype = compute_dtype or default_policy().compute_dtype
        self.det_model = load_model("retinaface", det_params, dtype,
                                    self.device)
        self.rec_model = (
            None if rec_params is None else
            load_model(recognizer, rec_params, dtype, self.device,
                       self.embed_precision)
        )
        self.pose_model = (
            None if pose_params is None else
            load_model(pose, pose_params, dtype, self.device,
                       self.pose_precision)
        )
        if mesh is not None:
            # Replicas hold the mesh's first rank's weights, and the int8
            # trunks quantise over the whole batch.
            for model in (self.det_model, self.rec_model, self.pose_model):
                if model is not None:
                    model.load_state_dict(
                        shard_params(model.state_dict(), mesh))
                    reduce_activation_scales(model, mesh.group)
        # The loaded weights, by reference (None where a model is absent);
        # under 'int8' the quantised ones.
        self.det_params = self.det_model.state_dict()
        self.rec_params = (None if self.rec_model is None
                           else self.rec_model.state_dict())
        self.pose_params = (None if self.pose_model is None
                            else self.pose_model.state_dict())

        self.embed_buckets = _buckets(cfg.pipeline_embed_buckets)
        self.peak_buckets = _buckets(cfg.pose_peak_buckets)

        # The device programs by (kind, key), made by _cached.
        self._programs = {}
        # Captured graphs of those programs by (program, input signature,
        # thresholds), made by warmup where graphs_eligible says so.
        self._graphs = {}
        # The 'host' plan's embed worker, started at first use.
        self._embed_pool_obj = None
        self._embed_pool_finalizer = None

        # Optional observability hooks: a StageTimer (aggregate per-stage
        # wall time) and/or a Timeline (per-batch spans with bytes —
        # utils/profiling.py). dispatch_batch assigns each batch a
        # monotonically increasing id that every stage span carries.
        self.timer = timer
        self.timeline = None
        self._batch_seq = 0

        # Pose thresholds (reference openpose/wrapper.py:177-180).
        self.keypoint_threshold = cfg.keypoint_threshold
        self.thresh_midpoint = cfg.paf_midpoint_threshold
        self.human_threshold = cfg.human_score_threshold
        self.use_fused_peaks = fused_peaks_enabled(cfg.fused_peaks)

    # ------------------------------------------------------------------
    # Device programs: closures cached per kind, shape and capacity
    # ------------------------------------------------------------------

    def _cached(self, kind, key, build):
        """The device program of ``kind`` at ``key``: ``build()``'s closure
        on first use, then that same closure on every call, which the key
        of its captured graph holds (:meth:`_graph_key`). Only the
        perception step's ``build`` does work (it uploads its anchors);
        the others return the closure their builder made."""
        program = self._programs.get((kind, key))
        if program is None:
            program = self._programs[kind, key] = build()
        return program

    def _perception_fn(self, full_h, full_w, top_k=None, pre_resized=False):
        """The perception step for (full_h, full_w) frames at NMS capacity
        ``top_k``: resident uint8 frames -> {'det_packed': (B, K, 17)} and,
        in fused embed mode, the aligned crops and their slot mask. With
        ``pre_resized`` (the 'host' plan) the input is the frames already
        resized to the detection size; (full_h, full_w) still set the
        coordinates' scale back."""
        top_k = self.top_k if top_k is None else top_k

        def build():
            det_h, det_w, det_scale = resized_shape(
                full_h, full_w, self.det_short_side
            )
            # Every anchor cell is valid at the unpadded det shape.
            detect = make_detect_fn(self.det_model, det_h, det_w,
                                    nms_threshold=self.nms_threshold,
                                    top_k=top_k)
            max_faces = self.max_faces
            inv_scale = 1.0 / det_scale
            with_embeddings = (
                self.with_embeddings and self.rec_model is not None
                and self.embed_dispatch == "fused" and not pre_resized
            )

            def step(frames_full):
                frames_det = (frames_full if pre_resized else
                              resize_bilinear_u8(frames_full, det_h, det_w))
                packed = detect(frames_det, self.threshold)
                # Boxes and landmarks back to full resolution with the
                # task API's rounding (around().astype(int32)); one packed
                # table -> one copy back: 4 box + 10 landmark + score +
                # mask + per-image NMS overflow (broadcast along K).
                coords = torch.round(packed[..., :14] * inv_scale).to(
                    torch.int32)
                result = {"det_packed": torch.cat(
                    [coords.to(torch.float32), packed[..., 14:]], dim=-1)}
                if with_embeddings:
                    b = coords.shape[0]
                    lmk_top = coords[:, :max_faces, 4:14].reshape(
                        b, -1, 5, 2).to(torch.float32)
                    mats = alignment_matrices_torch(lmk_top)
                    # The reference warps to uint8.
                    result["crops"] = torch.round(
                        warp_affine_frames(frames_full, mats))
                    result["emb_mask_dev"] = packed[:, :max_faces, 15] > 0.5
                return result

            return step

        return self._cached(
            "perception",
            (full_h, full_w, self.embed_dispatch, top_k, pre_resized), build)

    def _embed(self, crops, emb_mask):
        """The embed program: (B, F, 112, 112, 3) crops and (B, F) mask ->
        the packed (B, F, dim + 1) grid: normalised embeddings, zero where
        masked, + the mask."""
        b, f = crops.shape[:2]
        feats = self.rec_model(crops.reshape((-1,) + crops.shape[2:]))
        feats = normalize_embeddings(feats.to(torch.float32))
        feats = torch.where(emb_mask[..., None], feats.reshape(b, f, -1),
                            0.0)
        return torch.cat([feats, emb_mask[..., None].to(torch.float32)],
                         dim=-1)

    def _warp_embed_fn(self, k_slots, frames_shape):
        """Warp+embed for ``k_slots`` face slots per frame of a resident
        batch (adaptive embed). Takes the plan as one packed (B, k, 7)
        float32 tensor: 6 alignment-matrix entries (host float64 Umeyama)
        + validity."""

        def warp_embed(frames, packed):
            b = frames.shape[0]
            mats = packed[..., :6].reshape(b, k_slots, 2, 3)
            valid = packed[..., 6] > 0.5
            crops = torch.round(warp_affine_frames(frames, mats))
            return self._embed(crops, valid)

        return self._cached("warp_embed", (k_slots,) + tuple(frames_shape),
                            lambda: warp_embed)

    def _select_embed_bucket(self, count, capacity):
        """Smallest configured per-frame slot bucket >= count, else the
        full ``max_faces`` capacity."""
        for b in self.embed_buckets:
            if count <= b < capacity:
                return b
        return capacity

    def _pose_fn(self, full_h, full_w, max_peaks=None):
        """The pose step with the limbs fused in: frames -> (peaks (B, P,
        K, 5), limbs (B, L, K, K, 2))."""
        max_peaks = self.max_peaks if max_peaks is None else max_peaks
        pose_h, pose_w, _ = resized_shape(
            full_h, full_w, self.pose_short_side
        )

        def decode(frames_full):
            paf, peaks, coords, valid = self._pose_front(
                frames_full, pose_h, pose_w, max_peaks
            )
            return peaks, limb_table(paf, coords, valid,
                                     self.thresh_midpoint,
                                     skeleton=self.skeleton)

        return self._cached("pose", (full_h, full_w, max_peaks),
                            lambda: decode)

    def _pose_front(self, frames_full, pose_h, pose_w, max_peaks,
                    pre_resized=False):
        """Resize on the card + CPM forward + fixed-K peak finding (the
        fused upsample + peak-scan kernels on the card). Returns (paf x1
        float32, peaks packed (B, P, K, 5) = y, x, score, valid, part
        overflow, coords, valid). With ``pre_resized`` the input is
        already at (pose_h, pose_w)."""
        frames_pose = (frames_full if pre_resized else
                       resize_bilinear_u8(frames_full, pose_h, pose_w))
        paf, coords, scores, valid, overflow = forward_and_find_peaks(
            self.pose_model, frames_pose, self.keypoint_threshold,
            max_peaks, self.use_fused_peaks, mesh=self.mesh,
            skeleton=self.skeleton,
        )
        return paf, pack_peaks(coords, scores, valid, overflow), coords, \
            valid

    def _pose_detect_fn(self, full_h, full_w, max_peaks=None,
                        pre_resized=False):
        """First half of the adaptive pose path: frames -> (peaks packed,
        paf at x1, left on the card for :meth:`_limb_fn`). With
        ``pre_resized`` (the 'host' plan) the input is the frames already
        resized to the pose size."""
        max_peaks = self.max_peaks if max_peaks is None else max_peaks
        pose_h, pose_w, _ = resized_shape(
            full_h, full_w, self.pose_short_side
        )

        def detect_pose(frames_full):
            paf, peaks, _, _ = self._pose_front(
                frames_full, pose_h, pose_w, max_peaks, pre_resized
            )
            return peaks, paf

        return self._cached("pose_detect",
                            (full_h, full_w, max_peaks, pre_resized),
                            lambda: detect_pose)

    def _limb_fn(self, kb, paf_shape):
        """Bucketed limb-pair scoring: PAF x8 upsample + line integrals
        over (kb, kb) candidate pairs per limb, the gather form. Takes
        the peak plan as one (B, P, kb, 3) tensor: y, x, valid."""

        def limbs_fn(paf, cv_packed):
            coords = cv_packed[..., :2].to(torch.int32)
            valid = cv_packed[..., 2] > 0.5
            return limb_table(paf, coords, valid, self.thresh_midpoint,
                              skeleton=self.skeleton)

        return self._cached("limbs", (kb, self.limb_backend)
                            + tuple(paf_shape), lambda: limbs_fn)

    def _select_peak_bucket(self, count, cap=None):
        cap = self.max_peaks if cap is None else cap
        for b in self.peak_buckets:
            if count <= b < cap:
                return b
        return cap

    def _graph_key(self, fn, args):
        """A captured graph's key: the program, its inputs' signature and
        what the eager programs read from the pipeline on every call, which
        a graph holds at its value when captured."""
        return (fn, _signature(args), self.threshold,
                self.keypoint_threshold, self.thresh_midpoint,
                self.use_fused_peaks)

    def _program(self, fn, *args):
        """Call the cached device program ``fn`` on ``args``: a replay of
        its captured graph where warmup captured one at these inputs'
        signature and the pipeline's current thresholds, else its eager
        launches. Counted in ``graph_calls``,
        and as a ``graph_replay`` or ``graph_eager`` record with a timer
        attached."""
        graph = (self._graphs.get(self._graph_key(fn, args)) if self._graphs
                 else None)
        replay = graph is not None
        with self._counts_lock:
            self.graph_calls["replayed" if replay else "eager"] += 1
        if self.timer is not None:
            self.timer.record("graph_replay" if replay else "graph_eager",
                              0.0, 1)
        return graph(*args) if replay else fn(*args)

    # ------------------------------------------------------------------
    # Mesh: this rank's rows, gathered results
    # ------------------------------------------------------------------

    def _rows(self, batch):
        """This rank's rows of a global batch, padded as
        ``pad_batch_to_multiple`` pads it; the batch itself without a
        mesh."""
        return batch if self.mesh is None else own_rows(batch, self.mesh)

    def _global_rows(self, local_rows):
        """The padded global batch size for ``local_rows`` rows a rank."""
        return local_rows * (1 if self.mesh is None else self.mesh.size)

    def _gathered(self, tensor):
        """A device output over this rank's rows as the global batch's:
        all-gathered in rank order on the current stream under a mesh."""
        if self.mesh is None:
            return tensor
        return all_gather_rows(tensor, self.mesh)

    def _fetch(self, tensor, span=None):
        """The host copy of a device output's global rows, started now,
        carrying ``span``."""
        return _Fetch(self._gathered(tensor), span)

    def _run_timed(self, fn, *args):
        """Call the device program ``fn`` (an embed or a pose program)
        through :meth:`_program`. Returns its output and, with a timer
        attached, the :class:`_DeviceSpan` of the call (None without one),
        which :meth:`_record_embed` or :meth:`_record_pose` reads where
        the output is fetched."""
        if self.timer is None:
            return self._program(fn, *args), None
        span = _DeviceSpan(self.device)
        out = self._program(fn, *args)
        span.stop()
        return out, span

    def _record_embed(self, fetch):
        """With a timer attached, the record of the embed program whose
        packed output ``fetch`` has reached the host: ``embed_device``, its
        device seconds with items the faces embedded (the valid slots; the
        global batch's under a mesh)."""
        if self.timer is None or fetch.span is None:
            return
        faces = int((fetch.numpy()[..., -1] > 0.5).sum())
        self.timer.record("embed_device", fetch.span.seconds(), faces)

    def _record_pose(self, fetch, n):
        """With a timer attached, the record of the pose program whose
        output ``fetch`` has reached the host: ``pose_device``, its device
        seconds with items the batch's ``n`` frames."""
        if self.timer is None or fetch.span is None:
            return
        self.timer.record("pose_device", fetch.span.seconds(), n)

    # ------------------------------------------------------------------
    # Host orchestration
    # ------------------------------------------------------------------

    @_device_work
    def warmup(self, batch, height, width):
        """Build the CUDA kernels and run every program this pipeline can
        dispatch for (batch, height, width) frames once, on zeros:
        detection, the embed program at every bucket up to ``max_faces``
        (or the fused embed), and the pose programs (every limb bucket up
        to ``max_peaks`` in adaptive mode), so that a stream meets no
        first-use cost. The 'host' plan also runs its two host resizes,
        and its embed program is the crops+mask embed at every bucket.
        Under a mesh every rank calls it: it runs this rank's rows of the
        batch padded to the mesh size, and one gather brings up the
        group's communicator. Where :func:`graphs_eligible` allows, each
        program run is then captured as a CUDA graph at its inputs'
        signature and the settings it reads on every call (the thresholds,
        the peak kernel's switch); a signature captured before is kept. A
        call after one of those settings has changed runs eager until the
        next ``warmup`` captures at the new value. Returns the number of
        device programs run."""
        if self.device.type == "cuda":
            from terran_tpu_torch.models import quant
            from terran_tpu_torch.ops import conv_epilogue, fused_peaks, nms
            from terran_tpu_torch.utils.cuda_build import load_libraries

            int8 = "int8" in (self.embed_precision, self.pose_precision)
            # nvcc in parallel
            load_libraries("fused_peaks.cu", "nms.cu", "conv_epilogue.cu",
                           *(("quant_conv.cu",) if int8 else ()))
            fused_peaks._library()
            nms._library()
            conv_epilogue._library()
            if int8:
                quant._library()

        if self.mesh is not None:
            batch = -(-batch // self.mesh.size)
        frames_shape = (batch, height, width, 3)
        hostprep = self.transfer_plan == "host"
        with_pose = self.with_pose and self.pose_model is not None
        runs = []

        def run(program, *args):
            runs.append((program, args))
            return program(*args)

        if hostprep:
            zeros = np.zeros(frames_shape, np.uint8)
            det_h, det_w, _ = resized_shape(height, width,
                                            self.det_short_side)
            self._host_resize(zeros, det_h, det_w)
            pose_h, pose_w, _ = resized_shape(height, width,
                                              self.pose_short_side)
            if with_pose:
                self._host_resize(zeros, pose_h, pose_w)
            frames = self.put_frames(np.zeros((batch, det_h, det_w, 3),
                                              np.uint8))
            det = run(self._perception_fn(height, width, pre_resized=True),
                      frames)
        else:
            frames = self.put_frames(np.zeros(frames_shape, np.uint8))
            det = run(self._perception_fn(height, width), frames)
        self._gathered(det["det_packed"])
        embeds = self.with_embeddings and self.rec_model is not None
        if embeds and self.embed_dispatch == "fused":
            run(self._embed,
                torch.zeros((batch, self.max_faces, CROP_SIDE, CROP_SIDE, 3),
                            device=self.device),
                torch.zeros((batch, self.max_faces), dtype=torch.bool,
                            device=self.device))
        elif embeds:
            for k in sorted(set(self.embed_buckets) | {self.max_faces}):
                if k > self.max_faces:
                    continue
                if hostprep:
                    run(self._embed,
                        self._put_batch(np.zeros(
                            (batch, k, CROP_SIDE, CROP_SIDE, 3), np.uint8)),
                        self._put_batch(np.zeros((batch, k), bool)))
                else:
                    run(self._warp_embed_fn(k, frames_shape), frames,
                        self._put_batch(np.zeros((batch, k, 7),
                                                 np.float32)))
        if with_pose:
            if self.limb_dispatch == "adaptive":
                pose_in = (self.put_frames(np.zeros(
                    (batch, pose_h, pose_w, 3), np.uint8))
                    if hostprep else frames)
                _, paf = run(self._pose_detect_fn(
                    height, width, pre_resized=hostprep), pose_in)
                for kb in sorted(set(self.peak_buckets) | {self.max_peaks}):
                    if kb <= self.max_peaks:
                        run(self._limb_fn(kb, paf.shape), paf,
                            self._put_batch(np.zeros(
                                (batch, self.skeleton.parts, kb, 3),
                                np.float32)))
            else:
                run(self._pose_fn(height, width), frames)
        if graphs_eligible(self.device, self.mesh, self.transfer_plan,
                           self.embed_precision, self.pose_precision):
            for program, args in runs:
                key = self._graph_key(program, args)
                if key not in self._graphs:
                    self._graphs[key] = _Graph(program, args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return len(runs)

    def put_frames(self, frames):
        """Single host->device upload of a frame batch. Tensors already on
        the pipeline's device pass unchanged. On the card the frames are
        staged in pinned memory and copied on the upload stream; this
        returns once the copy is done, with the tensor marked for use on
        the compute stream."""
        if isinstance(frames, torch.Tensor) and frames.device == self.device:
            return frames
        src = torch.as_tensor(np.asarray(frames))
        with self._counts_lock:
            self.upload_bytes += src.nbytes
        if self._upload_stream is None:
            return src.to(self.device, copy=True)
        with torch.cuda.stream(self._upload_stream):
            staging = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True)
            staging.copy_(src)
            frames_dev = staging.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        # Allocated on the upload stream: keep its memory from reuse until
        # the compute stream's work on it has run.
        frames_dev.record_stream(self._stream)
        done.synchronize()
        return frames_dev

    def _put_batch(self, array):
        """Upload a small host-built plan array on the current stream,
        through pinned memory so the copy does not wait for the card."""
        array = np.asarray(array)
        with self._counts_lock:
            self.upload_bytes += array.nbytes
        src = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return src.pin_memory().to(self.device, non_blocking=True)
        return src.to(self.device, copy=True)

    def _stage(self, name, items=0, nbytes=0, batch=None):
        """Context for one pipeline stage: a ``terran::<name>`` range while
        a profiler records this thread, a record into the aggregate
        StageTimer and, when a Timeline is attached and the span carries a
        batch id, into the per-batch timeline. With none of the three it
        is the shared no-op context."""
        timeline = self.timeline if batch is not None else None
        if self.timer is None and timeline is None and not profiling():
            return NO_RANGE
        return self._stage_spans(name, items, nbytes, batch, timeline)

    @contextlib.contextmanager
    def _stage_spans(self, name, items, nbytes, batch, timeline):
        with contextlib.ExitStack() as st:
            st.enter_context(profiler_range("terran::{}", name))
            if self.timer is not None:
                st.enter_context(self.timer.stage(name, items))
            if timeline is not None:
                st.enter_context(timeline.span(batch, name, nbytes))
            yield

    def _uses_cv2(self):
        """Whether the host resize and warp run OpenCV: never under
        'exact', where OpenCV imports under 'auto', always under 'cv2'
        (``ImportError`` without it). Decided once, by calling the cv2
        resize on an empty batch."""
        if self._host_cv2 is None:
            use = self.host_resize != "exact"
            if use:
                try:
                    resize_bilinear_u8_cv2(np.zeros((0, 1, 1, 3), np.uint8),
                                           1, 1)
                except ImportError:
                    if self.host_resize == "cv2":
                        raise
                    use = False
            self._host_cv2 = use
        return self._host_cv2

    def _host_resize(self, frames, out_h, out_w):
        """Resize a uint8 batch on the host ('host' plan) -> uint8 numpy:
        OpenCV's fixed point (:meth:`_uses_cv2`), else the 'exact' chain,
        the device plan's own resize run on the CPU."""
        resize = (resize_bilinear_u8_cv2 if self._uses_cv2()
                  else resize_bilinear_u8_host)
        return resize(np.asarray(frames), out_h, out_w)

    def _host_prep_resize(self, frames):
        """Host half of the 'host' plan's prep for one batch: the
        detection and pose resizes, of this rank's rows under a mesh
        (``n`` is the global batch's true count). No device work:
        ``process_stream`` runs it on its own thread, so batch i+1's
        resizes overlap batch i's uploads."""
        if isinstance(frames, torch.Tensor):
            frames = frames.cpu()
        frames = np.asarray(frames)
        n = frames.shape[0]
        frames = self._rows(frames)
        full_h, full_w = frames.shape[1:3]
        det_h, det_w, _ = resized_shape(full_h, full_w, self.det_short_side)
        det_host = self._host_resize(frames, det_h, det_w)
        pose_host = None
        if self.with_pose and self.pose_model is not None:
            pose_h, pose_w, _ = resized_shape(full_h, full_w,
                                              self.pose_short_side)
            pose_host = self._host_resize(frames, pose_h, pose_w)
        return {"frames": frames, "n": n, "det_host": det_host,
                "pose_host": pose_host}

    def _host_prep_upload(self, prep):
        """Upload half of the 'host' plan's prep: the resized inputs go to
        the card (pinned, on the upload stream); the full frames stay on
        the host for the face warps."""
        pose_host = prep.pop("pose_host")
        prep["det_dev"] = self.put_frames(prep.pop("det_host"))
        prep["pose_dev"] = (None if pose_host is None
                            else self.put_frames(pose_host))
        return prep

    def _host_prep(self, frames):
        """The 'host' plan's whole prep (resizes, then uploads) for one
        batch; ``process_stream`` runs the two halves on two threads."""
        return self._host_prep_upload(self._host_prep_resize(frames))

    def _dispatch_perception(self, frames_dev, top_k=None, pre_shape=None):
        """Enqueue the perception step (and, in fused embed mode, the
        embed program) on resident frames and start the result copies.
        Returns the dict of in-flight fetches. ``pre_shape`` = (full_h,
        full_w) marks ``frames_dev`` as the 'host' plan's upload, already
        resized to the detection size."""
        if pre_shape is not None:
            full_h, full_w = pre_shape
        else:
            full_h, full_w = frames_dev.shape[1:3]
        step = self._perception_fn(full_h, full_w, top_k,
                                   pre_resized=pre_shape is not None)
        out = dict(self._program(step, frames_dev))
        span = None
        if "crops" in out:
            out["emb_packed"], span = self._run_timed(
                self._embed, out.pop("crops"), out.pop("emb_mask_dev"))
        return {key: self._fetch(value, span if key == "emb_packed" else None)
                for key, value in out.items()}

    def process_batch(self, frames):
        """Run the full pipeline on an (N, H, W, 3) uint8 RGB batch.

        Returns a dict of host arrays (faces, embeddings) and, when pose is
        enabled, the per-image assembled pose dicts.
        """
        return self.finalize_batch(*self.dispatch_batch(frames))

    @_device_work
    def dispatch_batch(self, frames, stage=None):
        """Enqueue all device work for one batch without waiting for the
        card.

        Returns (out dict of in-flight fetches, pose tuple or None, n,
        pose_scale).

        ``n`` is the batch's true frame count; under a mesh the device
        work covers this rank's rows of the padded batch, and the fetches
        the gathered global rows.

        Under ``transfer_plan='host'`` the caller's host ``frames`` are
        read again, by the embed worker thread after this returns, to warp
        the faces: they must not be overwritten until the batch is
        collected. ``frames`` may also be the prep dict of
        :meth:`_host_prep` (``process_stream`` makes it on its threads).
        """
        bid = self._batch_seq
        self._batch_seq += 1
        if stage is None:
            stage = functools.partial(self._stage, batch=bid)

        hostprep = self.transfer_plan == "host"
        prep = None
        if isinstance(frames, dict) and "det_dev" in frames:
            prep = frames
        elif hostprep:
            with stage("host_prep"):
                prep = self._host_prep(frames)
        if prep is not None:
            frames, n = prep["frames"], prep["n"]
        else:
            if not hasattr(frames, "shape"):
                frames = np.asarray(frames)
            n = frames.shape[0]
            frames = self._rows(frames)
        full_h, full_w = frames.shape[1:3]

        if hostprep:
            # The detection-size resize crossed the link instead of the
            # frames; the frames stay on the host for the face warps.
            frames_dev = prep["det_dev"]
            pre_shape = (full_h, full_w)
            with stage("perception_step", items=n):
                out = self._dispatch_perception(frames_dev,
                                                pre_shape=pre_shape)
            out["_frames_host"] = frames
            pose_in = prep["pose_dev"]
        else:
            pre_shape = None
            with stage("h2d", items=n, nbytes=getattr(frames, "nbytes", 0)):
                frames_dev = self.put_frames(frames)
            with stage("perception_step", items=n):
                out = self._dispatch_perception(frames_dev)
            if (self.max_escalations > 0
                    or (self.embed_dispatch == "adaptive"
                        and self.with_embeddings
                        and self.rec_model is not None)):
                # The adaptive embed program is dispatched in
                # advance_batch, once the detections are on the host, and
                # escalation re-dispatches saturated batches: the frames
                # stay resident.
                out["_frames_dev"] = frames_dev
            pose_in = frames_dev
        if self.max_escalations > 0:
            out["_redetect"] = lambda tk: self._dispatch_perception(
                frames_dev, top_k=tk, pre_shape=pre_shape
            )

        pose_out = None
        pose_scale = None
        if self.with_pose and self.pose_model is not None:
            _, _, pose_scale = resized_shape(
                full_h, full_w, self.pose_short_side
            )
            if self.limb_dispatch == "adaptive":
                def repose(max_peaks):
                    (peaks, paf), span = self._run_timed(
                        self._pose_detect_fn(full_h, full_w, max_peaks,
                                             pre_resized=hostprep),
                        pose_in)
                    return self._fetch(peaks, span), paf

                with stage("pose_dispatch", items=n):
                    peaks_dev, paf_dev = repose(self.max_peaks)
                pose_out = ("adaptive", peaks_dev, paf_dev, repose)
            else:
                with stage("pose_dispatch", items=n):
                    outs, span = self._run_timed(
                        self._pose_fn(full_h, full_w), frames_dev)
                    pose_out = tuple(self._fetch(v, span) for v in outs)

        out["_batch_id"] = bid
        return out, pose_out, n, pose_scale

    def finalize_batch(self, out, pose_out, n, pose_scale, stage=None):
        """Fetch results and run the host stages for a dispatched batch."""
        return self.collect_batch(
            self.advance_batch(out, pose_out, n, pose_scale, stage=stage)
        )

    @_device_work
    def advance_batch(self, out, pose_out, n, pose_scale, stage=None):
        """Finalization phase A: fetch the small decision tables (packed
        detections, peaks), run overflow escalations, and dispatch the
        occupancy-adaptive second-stage programs (bucketed warp+embed,
        limb scoring) with their result copies started. Returns the
        state dict ``collect_batch`` consumes."""
        bid = out.pop("_batch_id", None)
        if stage is None:
            stage = functools.partial(self._stage, batch=bid)

        frames_dev = out.pop("_frames_dev", None)
        frames_host = out.pop("_frames_host", None)
        redetect = out.pop("_redetect", None)

        det_dev = out.pop("det_packed")
        with stage("det_fetch", items=n, nbytes=det_dev.nbytes):
            det = det_dev.numpy()[:n]
        boxes, landmarks, scores, mask, overflow = unpack_detections(det)
        # Overflow escalation: a saturated NMS pre-selection may have
        # dropped real faces; re-dispatch the perception step at doubled
        # top_k on the still-resident frames.
        top_k_used = self.top_k
        attempts = 0
        while (bool(overflow.any()) and redetect is not None
               and attempts < self.max_escalations):
            attempts += 1
            top_k_used *= 2
            self.escalations["detect"] += 1
            with stage("detect_escalation", items=n):
                out_esc = redetect(top_k_used)
                if "emb_packed" in out_esc:
                    out["emb_packed"] = out_esc["emb_packed"]
                det = out_esc.pop("det_packed").numpy()[:n]
                boxes, landmarks, scores, mask, overflow = (
                    unpack_detections(det)
                )
        out["boxes"] = boxes.astype(np.int32)
        out["landmarks"] = landmarks.astype(np.int32)
        out["scores"] = scores.astype(np.float32)
        out["mask"] = mask
        out["det_overflow"] = overflow

        adaptive_embed = (
            self.embed_dispatch == "adaptive" and self.with_embeddings
            and self.rec_model is not None
        )
        emb_plan = None
        if adaptive_embed and frames_host is not None:
            # 'host' plan: the embed worker warps the faces on the host and
            # uploads only the crops, overlapping this thread's pose
            # fetches and the next batch's prep; collect_batch resolves
            # the future. The worker reads out's mask and landmarks, set
            # above; this thread only adds keys from here on.
            emb_plan = self._embed_pool().submit(
                self._dispatch_adaptive_embed_host, out, frames_host, n,
                stage,
            )
        elif adaptive_embed and frames_dev is not None:
            # Dispatch the bucketed warp+embed now; it computes while the
            # pose fetch and host assembly run.
            with stage("embed_dispatch", items=n):
                emb_plan = self._dispatch_adaptive_embed(out, frames_dev)

        pose_state = None
        if pose_out is not None and pose_out[0] == "adaptive":
            peaks_dev, paf_dev, repose = pose_out[1:]
            with stage("pose_fetch", items=n, nbytes=peaks_dev.nbytes):
                peaks_np = peaks_dev.numpy()
            self._record_pose(peaks_dev, n)
            # Escalation: a saturated part heatmap dropped its weakest
            # peaks; re-run forward+peaks at doubled max_peaks.
            mp_used = self.max_peaks
            attempts = 0
            while ((peaks_np[:n, :, 0, 4] > 0.5).any()
                   and attempts < self.max_escalations):
                attempts += 1
                mp_used *= 2
                self.escalations["pose"] += 1
                with stage("pose_escalation", items=n):
                    peaks_dev, paf_dev = repose(mp_used)
                    peaks_np = peaks_dev.numpy()
                self._record_pose(peaks_dev, n)
            coords = peaks_np[..., :2].astype(np.int32)
            scores = peaks_np[..., 2].astype(np.float32)
            valid = peaks_np[..., 3] > 0.5
            out["pose_overflow"] = (peaks_np[:n, :, 0, 4] > 0.5).any(axis=-1)
            with stage("limb_dispatch", items=n):
                kb, limbs_dev = self._dispatch_adaptive_limbs(
                    paf_dev, coords, valid, cap=mp_used
                )
            pose_state = (
                "adaptive", coords[:n, :, :kb], scores[:n, :, :kb],
                valid[:n, :, :kb], kb, limbs_dev,
            )
        elif pose_out is not None:
            # Fused limbs: one packed result, fetched in phase B, where
            # its overflow escalation also lives.
            pose_state = ("fused", pose_out, frames_dev)

        return {
            "out": out, "n": n, "pose_scale": pose_scale, "bid": bid,
            "stage": stage, "emb_plan": emb_plan,
            "adaptive_embed": adaptive_embed, "pose": pose_state,
        }

    @_device_work
    def collect_batch(self, state):
        """Finalization phase B: the heavy fetches (limb tables,
        embeddings, or the fused pose tables) and the host-side human
        assembly. Runs one pipeline slot after ``advance_batch`` under
        ``process_stream`` so the programs it waits on computed while the
        next batch was advancing."""
        out = state["out"]
        n = state["n"]
        pose_scale = state["pose_scale"]
        stage = state["stage"]

        if state["pose"] is not None and state["pose"][0] == "adaptive":
            _, coords, scores, valid, kb, limbs_dev = state["pose"]
            with stage("limb_fetch", items=n,
                       nbytes=getattr(limbs_dev, "nbytes", 0)):
                if limbs_dev is None:  # no peaks anywhere
                    shape = (n, self.skeleton.limbs, kb, kb)
                    reg = np.zeros(shape, np.float32)
                    accept = np.zeros(shape, bool)
                else:
                    limbs = limbs_dev.numpy()[:n]
                    reg = limbs[..., 0]
                    accept = limbs[..., 1] > 0.5
        elif state["pose"] is not None:
            _, pose_out, frames_dev = state["pose"]
            with stage("pose_fetch", items=n,
                       nbytes=sum(v.nbytes for v in pose_out)):
                (coords, scores, valid, reg, accept,
                 pose_overflow) = unpack_pose_outputs(
                    *(v.numpy() for v in pose_out))
            self._record_pose(pose_out[0], n)
            mp_used = self.max_peaks
            attempts = 0
            while (pose_overflow[:n].any() and frames_dev is not None
                   and attempts < self.max_escalations):
                attempts += 1
                mp_used *= 2
                self.escalations["pose"] += 1
                with stage("pose_escalation", items=n):
                    decode = self._pose_fn(frames_dev.shape[1],
                                           frames_dev.shape[2], mp_used)
                    outs, span = self._run_timed(decode, frames_dev)
                    pose_out = tuple(self._fetch(v, span) for v in outs)
                    (coords, scores, valid, reg, accept,
                     pose_overflow) = unpack_pose_outputs(
                        *(v.numpy() for v in pose_out))
                self._record_pose(pose_out[0], n)
            out["pose_overflow"] = pose_overflow[:n].any(axis=-1)

        if state["pose"] is not None:
            with stage("pose_assembly", items=n):
                poses = []
                for i in range(n):
                    peaks_by_id, humans = assemble_humans(
                        coords[i], scores[i], valid[i], reg[i], accept[i],
                        human_threshold=self.human_threshold,
                        skeleton=self.skeleton,
                    )
                    poses.append(
                        get_keypoints(peaks_by_id, humans, pose_scale)
                    )
                out["poses"] = poses

        if "emb_packed" in out:
            # Fused embed: unpack the single-copy embedding grid.
            emb_dev = out.pop("emb_packed")
            with stage("embed_fetch", items=n, nbytes=emb_dev.nbytes):
                emb = emb_dev.numpy()[:n]
            self._record_embed(emb_dev)
            out["embeddings"] = emb[..., :-1]
            out["embeddings_mask"] = emb[..., -1] > 0.5
        elif state["adaptive_embed"]:
            with stage("embed_fetch", items=n):
                out["embeddings"], out["embeddings_mask"] = (
                    self._collect_adaptive_embed(state["emb_plan"], n)
                )
        return out

    def _dispatch_adaptive_limbs(self, paf_dev, coords, valid, cap=None):
        """Enqueue the bucketed limb-pair program.

        ``kb`` covers the busiest (image, part)'s valid-peak count (valid
        peaks occupy prefix slots); ``cap`` is the peak capacity of the
        program that produced ``coords``; under a mesh ``coords`` and
        ``valid`` are the global padded batch's, and this rank's rows of
        the plan are uploaded. Returns (kb, in-flight fetch), or (1, None)
        when the whole batch produced no peaks.
        """
        counts = valid.sum(axis=-1)
        busiest = int(counts.max()) if counts.size else 0
        if busiest == 0:
            return 1, None
        kb = self._select_peak_bucket(busiest, cap)
        cv = np.concatenate(
            [
                coords[:, :, :kb].astype(np.float32),
                (valid[:, :, :kb])[..., None].astype(np.float32),
            ],
            axis=-1,
        )
        limbs = self._program(self._limb_fn(kb, paf_dev.shape), paf_dev,
                              self._put_batch(self._rows(cv)))
        return kb, self._fetch(limbs)

    def _plan_adaptive_embed(self, out, b):
        """Bucket selection, capacity escalation and host Umeyama for the
        bucketed warp+embed program. Returns None when no faces were
        found, else (packed (b, k, 7): 6 matrix entries + validity, k)."""
        # Slots are positional (NMS suppression leaves holes in the mask),
        # so the bucket must cover the highest OCCUPIED slot, not the count.
        mask_full = out["mask"]
        slot_no = np.arange(1, mask_full.shape[1] + 1)
        busiest = int((mask_full * slot_no).max()) if mask_full.size else 0
        if busiest == 0:
            return None
        # Capacity escalation: when faces occupy slots beyond max_faces,
        # double the face capacity (up to max_escalations times, bounded
        # by top_k) so those faces get embedded instead of skipped.
        capacity = self.max_faces
        attempts = 0
        while busiest > capacity and attempts < self.max_escalations:
            attempts += 1
            capacity = min(capacity * 2, mask_full.shape[1])
            self.escalations["embed"] += 1
        mask = mask_full[:, :capacity]
        lmks = out["landmarks"][:, :capacity]
        k = self._select_embed_bucket(min(busiest, capacity), capacity)
        packed = np.zeros((b, k, 7), np.float32)
        idx = np.argwhere(mask[:, :k])
        mats = alignment_matrices(
            lmks[idx[:, 0], idx[:, 1]].astype(np.float32)
        )  # one batched solve
        packed[idx[:, 0], idx[:, 1], :6] = mats.reshape(len(idx), 6)
        packed[idx[:, 0], idx[:, 1], 6] = 1.0
        return packed, k

    @_device_work
    def _dispatch_adaptive_embed(self, out, frames_dev):
        """Plan and enqueue the bucketed warp+embed program over the
        resident full frames. Returns the in-flight fetch, or None when no
        faces were found (no program runs at all)."""
        plan = self._plan_adaptive_embed(
            out, self._global_rows(frames_dev.shape[0]))
        if plan is None:
            return None
        packed, k = plan
        return self._fetch(*self._run_timed(
            self._warp_embed_fn(k, frames_dev.shape), frames_dev,
            self._put_batch(self._rows(packed))))

    @_device_work
    def _dispatch_adaptive_embed_host(self, out, frames, n, stage):
        """The 'host' plan's :meth:`_dispatch_adaptive_embed`: the faces
        are warped on the host (:meth:`_host_warp_fn`) and only the
        (b, k, 112, 112, 3) uint8 crops and their (b, k) mask cross the
        link, into the crops+mask embed (:meth:`_embed`). Runs on the
        embed worker thread, so it makes the compute stream current and
        enters inference mode itself (both are per thread). Returns the
        in-flight fetch, or None when no faces were found. Under a mesh
        ``frames`` are this rank's rows, and it stops after the uploads
        and returns the (crops, mask) on the card: the embed program
        (whose int8 trunk all-reduces) and the gather run in
        :meth:`_collect_adaptive_embed` on the main thread, so that every
        rank issues its collectives in one order."""
        b = frames.shape[0]
        plan = self._plan_adaptive_embed(out, self._global_rows(b))
        if plan is None:
            return None
        packed, k = plan
        packed = self._rows(packed)
        mask = packed[..., 6] > 0.5
        warp = self._host_warp_fn()
        with stage("embed_host_warp", items=int(mask.sum())):
            crops = np.zeros((b, k, CROP_SIDE, CROP_SIDE, frames.shape[3]),
                             np.uint8)
            for i in range(b):
                js = np.flatnonzero(mask[i])
                if js.size:
                    crops[i, js] = warp(
                        frames[i], packed[i, js, :6].reshape(-1, 2, 3))
        with stage("embed_dispatch", items=n,
                   nbytes=crops.nbytes + mask.nbytes):
            inputs = (self._put_batch(crops), self._put_batch(mask))
            if self.mesh is not None:
                return inputs
            return _Fetch(*self._run_timed(self._embed, *inputs))

    def _collect_adaptive_embed(self, plan, n):
        """Fetch the adaptive embed result and place it in the
        (n, >=max_faces, dim) grid the fused path produces (wider than
        max_faces only when capacity escalation fired for this batch).
        Under the 'host' plan ``plan`` is the embed worker's future."""
        if isinstance(plan, Future):
            plan = plan.result()
        if isinstance(plan, tuple):  # a mesh's uploaded (crops, mask)
            plan = self._fetch(*self._run_timed(self._embed, *plan))
        if plan is None:
            return (
                np.zeros((n, self.max_faces, EMBEDDING_DIM), np.float32),
                np.zeros((n, self.max_faces), bool),
            )
        emb = plan.numpy()[:n]
        self._record_embed(plan)
        k = emb.shape[1]
        dim = emb.shape[-1] - 1  # packed as features + validity flag
        rows = max(self.max_faces, k)
        grid = np.zeros((n, rows, dim), np.float32)
        grid_mask = np.zeros((n, rows), bool)
        grid[:, :k] = emb[..., :dim]
        grid_mask[:, :k] = emb[..., dim] > 0.5
        return grid, grid_mask

    def _host_warp_fn(self):
        """The 'host' plan's face warp, on the resize's backend: OpenCV's
        fixed point (within one count), else the numpy twin of the card's
        warp."""
        return (warp_affine_u8_batch_cv2 if self._uses_cv2()
                else warp_affine_u8_batch_numpy)

    def _embed_pool(self):
        """The 'host' plan's embed worker: one thread, so that its jobs
        enqueue in batch order. Shut down by :meth:`close`, or when the
        pipeline is collected."""
        if self._embed_pool_obj is None:
            self._embed_pool_obj = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="terran-tpu-torch-embed")
            self._embed_pool_finalizer = weakref.finalize(
                self, self._embed_pool_obj.shutdown, wait=False)
        return self._embed_pool_obj

    def close(self):
        """Shut down the 'host' plan's embed worker, after its queued jobs.
        Idempotent; the pipeline stays usable (a later batch starts a new
        worker)."""
        pool = self._embed_pool_obj
        if pool is not None:
            self._embed_pool_obj = None
            self._embed_pool_finalizer.detach()
            pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _worker_stage(self, fn, name):
        """``fn``, recorded as the stage ``name`` of each batch it takes on
        a worker thread of :meth:`process_stream`. Every thread takes the
        batches in order, so the k-th is dispatch id _batch_seq + k as
        long as this stream is the only dispatcher meanwhile."""
        ids = itertools.count(self._batch_seq)

        def run(item):
            if isinstance(item, dict):  # the 'host' plan's prep
                frames = item["frames"]
                nbytes = sum(value.nbytes for key, value in item.items()
                             if key.endswith("_host") and value is not None)
            else:
                frames = item
                nbytes = getattr(item, "nbytes", 0)
            with self._stage(name, items=len(frames), nbytes=nbytes,
                             batch=next(ids)):
                return fn(item)

        return run

    def process_stream(self, batches, depth=None, prefetch=True):
        """Software-pipelined batch processing.

        At most ``depth`` batches are kept dispatched ahead of the oldest
        unfinished batch (default: config ``pipeline_depth``), so while
        batch *i*'s results download and its host stages run, batch *i+1*
        is computing and batch *i+2* is crossing the host->device link.

        With ``prefetch`` (off under a mesh, as in the JAX class), uploads
        move to a background thread
        (``io.video.prefetch.threaded_device_put`` with :meth:`put_frames`,
        the ``h2d_thread`` stage). Under the 'host' plan two threads
        precede the dispatch loop: the host resizes
        (``host_resize_thread``), then their uploads (``h2d_thread``).
        ``depth`` is then an upper bound: while the uploads have no next
        batch ready (a live source whose next frames are not filmed yet),
        the loop advances the oldest dispatched batch, else collects and
        yields the oldest advanced one, asking again after each step, and
        blocks on the feed only once nothing is outstanding. A closed loop,
        whose next batch is always waiting, keeps the depth schedule.
        Without ``prefetch`` the depth schedule is the rule.

        Yields one result dict per input batch, in order. With a
        ``timer`` attached, each batch also records a ``release_wait``:
        host seconds from the end of its ``dispatch_batch`` to the start
        of its ``collect_batch``, less its own ``advance_batch``, the time
        it waited for later batches to be dispatched; and, with no clock
        read, a ``release_early`` where the wait for the feed yielded it
        or a ``release_depth`` where the depth schedule or the stream's
        end did.
        """
        from collections import deque

        if depth is None:
            from terran_tpu_torch.config import get_config

            depth = get_config().pipeline_depth
        depth = max(1, depth)

        if prefetch and self.mesh is None:
            from terran_tpu_torch.io.video.prefetch import (
                threaded_device_put,
            )

            if self.transfer_plan == "host":
                stages = ((self._host_prep_resize, "host_resize_thread"),
                          (self._host_prep_upload, "h2d_thread"))
            else:
                stages = ((self.put_frames, "h2d_thread"),)
            for fn, name in stages:
                batches = threaded_device_put(
                    batches, depth=depth, put=self._worker_stage(fn, name))
            ready = batches.ready
        else:
            ready = None

        # Two-phase finalization: once a batch leaves the dispatch window,
        # phase A (advance_batch: decision fetches + adaptive dispatches)
        # runs immediately, but phase B (collect_batch: the heavy fetches +
        # assembly) waits one further slot, so the limb/embed programs
        # dispatched in phase A compute while the NEXT batch advances.
        # pending holds (dispatched batch, its dispatch's end), advanced
        # (advanced state, that end, the advance's seconds); with no timer
        # no clock is read.
        timer = self.timer
        clock = time.perf_counter if timer is not None else lambda: 0.0

        def advance(entry):
            args, dispatched = entry
            start = clock()
            state = self.advance_batch(*args)
            return state, dispatched, clock() - start

        def collect(entry, release):
            state, dispatched, advance_s = entry
            if timer is not None:
                timer.record("release_wait",
                             clock() - dispatched - advance_s)
                timer.record(release, 0.0, 1)
            return self.collect_batch(state)

        pending = deque()
        advanced = deque()
        for frames in batches:
            pending.append((self.dispatch_batch(frames), clock()))
            if len(pending) > depth:
                advanced.append(advance(pending.popleft()))
            # An early release that the feed cut short may have left more
            # batches advanced than the schedule keeps.
            while len(advanced) > 1:
                yield collect(advanced.popleft(), "release_depth")
            while ready is not None and (pending or advanced) and not ready():
                if pending:
                    advanced.append(advance(pending.popleft()))
                else:
                    yield collect(advanced.popleft(), "release_early")
        while pending:
            advanced.append(advance(pending.popleft()))
            if len(advanced) > 1:
                yield collect(advanced.popleft(), "release_depth")
        while advanced:
            yield collect(advanced.popleft(), "release_depth")

    def faces_from(self, out):
        """Convert step outputs to the task-API list-of-dicts contract."""
        faces = []
        mask = out["mask"]
        for i in range(mask.shape[0]):
            keep = mask[i]
            faces.append([
                {"bbox": b, "landmarks": l, "score": s}
                for b, l, s in zip(
                    out["boxes"][i][keep], out["landmarks"][i][keep],
                    out["scores"][i][keep],
                )
            ])
        return faces
