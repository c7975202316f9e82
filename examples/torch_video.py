"""Face detection over a video on the PyTorch port, written back out with
boxes drawn.

``examples/video.py`` on ``terran_tpu_torch``, with the same options:

- ``--threshold`` sets the detector's score threshold;
- ``--workers N`` (N > 1) decodes the source with the multi-process
  segmented reader (``ParallelVideo``);
- ``--engine pipeline`` runs ``PerceptionPipeline.process_stream``
  (detection only: on-card resize, decode and NMS, batches dispatched
  ahead of the host stages), with ``--transfer-plan device|host``;
- rendering happens in the writer thread (deferred render), so drawing
  overlaps the next batch's inference.

The detector comes from the checkpoint store and runs on the CUDA card
unless ``--device`` names another. Reading and writing need ffmpeg;
drawing needs Pillow or pycairo.

    python examples/torch_video.py in.mp4 out.mp4 --engine pipeline
"""

import argparse
import sys
from collections import deque

from terran_tpu_torch.face.detection import Detection
from terran_tpu_torch.io import open_video, open_video_parallel, write_video
from terran_tpu_torch.vis import vis_faces


def build_parser():
    parser = argparse.ArgumentParser(prog="find-video")
    parser.add_argument("video_path", metavar="video-path")
    parser.add_argument("output_path", metavar="output-path")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Detection score threshold.")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--duration", "-d", type=int, default=None)
    parser.add_argument("--framerate", "-f", type=int, default=None)
    parser.add_argument("--start-time", "-ss", default=None)
    parser.add_argument("--workers", "-w", type=int, default=1,
                        help="Decoder processes (>1 uses the segmented "
                             "reader).")
    parser.add_argument("--engine", choices=("task", "pipeline"),
                        default="task",
                        help="'task' = Detection API (reference "
                             "semantics); 'pipeline' = fused on-card path "
                             "with software-pipelined batches.")
    parser.add_argument("--transfer-plan", choices=("device", "host"),
                        default="device",
                        help="Pipeline engine only: 'host' uploads the "
                             "resizes and per-face windows instead of the "
                             "raw frames (identical results).")
    parser.add_argument("--device", default=None,
                        help="Where the models run (default: the CUDA "
                             "card; 'cpu' for the CPU).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    reader_options = dict(
        batch_size=args.batch_size,
        read_for=args.duration,
        start_time=args.start_time,
        framerate=args.framerate,
    )
    if args.workers > 1:
        video = open_video_parallel(args.video_path, workers=args.workers,
                                    **reader_options)
    else:
        video = open_video(args.video_path, **reader_options)

    writer = write_video(args.output_path, copy_format_from=video)

    if args.engine == "pipeline":
        from terran_tpu_torch.pipeline import PerceptionPipeline

        pipeline = PerceptionPipeline(
            threshold=args.threshold, with_pose=False, with_embeddings=False,
            transfer_plan=args.transfer_plan, device=args.device,
        )
        for frames, out in _pipeline_stream(pipeline, video):
            for frame, faces in zip(frames, pipeline.faces_from(out)):
                writer.write_frame(vis_faces, frame, faces)
    else:
        detect = Detection(threshold=args.threshold, device=args.device)
        for frames in video:
            faces_per_frame = detect(frames)
            for frame, faces in zip(frames, faces_per_frame):
                # Deferred render: executed in the writer thread so
                # drawing overlaps the next batch's inference.
                writer.write_frame(vis_faces, frame, faces)

    writer.close()
    return 0


def _pipeline_stream(pipeline, video):
    """Yield (frames, results) with the card pipelined ahead: frames are
    teed so each decoded batch is kept until its results arrive."""
    held = deque()

    def feed():
        for frames in video:
            held.append(frames)
            yield frames

    for out in pipeline.process_stream(feed()):
        yield held.popleft(), out


if __name__ == "__main__":
    sys.exit(main())
