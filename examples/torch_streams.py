"""Concurrent-stream perception on the PyTorch port: N videos through the
pipeline.

``examples/streams.py`` on ``terran_tpu_torch``: batches frames from
several sources (files or synthetic 1080p streams), runs detect + embed +
pose on the CUDA card, tracks faces per stream, and prints the throughput
and each stream's frame count. The models come from the checkpoint store.
``--multichip`` runs the pipeline under ``create_mesh()``: a world of one
without a process group, or every rank of one started by ``torchrun``.

    python examples/torch_streams.py --synthetic 2 --frames 16
"""

import argparse
import sys
import time


def build_parser():
    parser = argparse.ArgumentParser(prog="streams")
    parser.add_argument("video_paths", metavar="video-paths", nargs="*")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="Use N synthetic 1080p streams instead of "
                             "files.")
    parser.add_argument("--frames", type=int, default=64,
                        help="Frames per synthetic stream.")
    chips = parser.add_mutually_exclusive_group()
    chips.add_argument("--multichip", dest="multichip", action="store_true",
                       default=False)
    chips.add_argument("--single-chip", dest="multichip",
                       action="store_false")
    parser.add_argument("--device", default=None,
                        help="Where the models run (default: the CUDA "
                             "card; 'cpu' for the CPU).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from terran_tpu_torch.io.streams import MultiStreamPerception
    from terran_tpu_torch.pipeline import PerceptionPipeline

    if args.synthetic:
        from terran_tpu_torch.io.video.synthetic import SyntheticVideo

        streams = [
            SyntheticVideo(width=1920, height=1080, num_frames=args.frames,
                           batch_size=4, seed=i)
            for i in range(args.synthetic)
        ]
    else:
        from terran_tpu_torch.io import open_video

        streams = [
            open_video(path, batch_size=4) for path in args.video_paths
        ]
    if not streams:
        print("Give video paths or --synthetic N.")
        return 0

    mesh = None
    device = args.device
    if args.multichip:
        from terran_tpu_torch.parallel.mesh import create_mesh

        mesh = create_mesh(devices=device)
        device = None

    pipeline = PerceptionPipeline(mesh=mesh, max_faces=8, top_k=64,
                                  max_peaks=16, device=device)
    msp = MultiStreamPerception(pipeline, streams,
                                batch_size=args.batch_size)

    counts = {}
    start = time.time()
    for results in msp:
        for r in results:
            counts[r["stream"]] = counts.get(r["stream"], 0) + 1
    elapsed = time.time() - start
    total = sum(counts.values())
    print(
        f"{total} frames over {len(counts)} streams in {elapsed:.1f}s "
        f"= {total / elapsed:.1f} fps total"
    )
    for stream, n in sorted(counts.items()):
        print(f"  stream {stream}: {n} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
