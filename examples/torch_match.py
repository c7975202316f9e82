"""Face search on the PyTorch port: find which images in a directory
contain a reference face.

``examples/match.py`` on ``terran_tpu_torch``: one reference embedding,
cosine-distance comparison against every detected face in a directory,
the gallery scanned in batches, a summary at the end. The models come from
the checkpoint store (``python -m terran_tpu_torch.cli checkpoint
convert``, or a download on first use) and run on the CUDA card unless
``--device`` names another. Reading images needs Pillow.

    python examples/torch_match.py reference.jpg gallery/ --batch-size 8
"""

import argparse
import sys

from terran_tpu_torch.face import Detection, Recognition
from terran_tpu_torch.io import open_image, resolve_images
from terran_tpu_torch.vis import display_image, vis_faces


def embed_reference(path, detect, embed):
    """Detect and embed the single face in the reference image, or None
    when the image doesn't contain exactly one face."""
    image = open_image(path)
    faces = detect(image)
    if len(faces) != 1:
        print(f"Reference image must have exactly one face, found "
              f"{len(faces)}.")
        return None
    return embed(image, faces)[0]


def scan_gallery(ref_embedding, image_dir, batch_size, threshold, detect,
                 embed):
    """Yield (path, image, face, distance) for every match under the
    threshold."""
    for batch_paths in resolve_images(image_dir, batch_size=batch_size):
        images = [open_image(p) for p in batch_paths]
        faces_per_image = detect(images)
        embeddings_per_image = embed(images, faces_per_image)

        for path, image, faces, embeddings in zip(
            batch_paths, images, faces_per_image, embeddings_per_image
        ):
            if not len(embeddings):
                continue
            # Cosine distance = 1 - dot for unit-norm embeddings.
            distances = 1.0 - embeddings @ ref_embedding
            for face, distance in zip(faces, distances):
                if distance < threshold:
                    yield path, image, face, float(distance)


def build_parser():
    parser = argparse.ArgumentParser(prog="match-dir")
    parser.add_argument("reference")
    parser.add_argument("image_dir", metavar="image-dir")
    parser.add_argument("--batch-size", type=int, default=1)
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Cosine-distance threshold for a match.")
    parser.add_argument("--display", action="store_true", default=False)
    parser.add_argument("--device", default=None,
                        help="Where the models run (default: the CUDA "
                             "card; 'cpu' for the CPU).")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    detect = Detection(device=args.device)
    embed = Recognition(device=args.device)
    ref_embedding = embed_reference(args.reference, detect, embed)
    if ref_embedding is None:
        return 0

    matches = 0
    for path, image, face, distance in scan_gallery(
        ref_embedding, args.image_dir, args.batch_size, args.threshold,
        detect, embed,
    ):
        matches += 1
        print(f"{path}, confidence = {distance:.2f}")
        if args.display:
            display_image(vis_faces(image, face))

    print(f"{matches} matching face(s) found.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
