"""Resize and pad-merge batching shared by the task APIs.

``resize_factory`` follows ``terran_tpu/utils/batching.py`` but resizes
with :func:`terran_tpu_torch.ops.resize.resize_bilinear_u8` on the given
device instead of cv2; ``merge_factory`` is the same centre-padding merge,
done on the device for a list of device tensors.
"""

import math

import numpy as np
import torch

from terran_tpu_torch.ops.resize import resize_bilinear_u8, resized_shape


def _to_device(image, device):
    if isinstance(image, torch.Tensor):
        return image.to(device)
    return torch.from_numpy(np.ascontiguousarray(image)).to(device)


def resize_factory(short_side=416, device="cpu"):
    """Build (resize_in, resize_out) closures.

    Reference resize semantics: ``scale = short_side / min(H, W)``, output
    size ``(int(W * scale), int(H * scale))``, coordinates divided by the
    scale and rounded to int32 on the way out
    (face/detection/__init__.py:13-86). ``resize_in`` returns uint8
    tensors on ``device``.
    """

    def resize_in(images):
        if isinstance(images, (np.ndarray, torch.Tensor)):
            h, w = images.shape[1:3]
            out_h, out_w, scale = resized_shape(h, w, short_side)
            resized = resize_bilinear_u8(
                _to_device(images, device), out_h, out_w
            )
            return resized, scale
        resized, scales = [], []
        for image in images:
            h, w = image.shape[0:2]
            out_h, out_w, scale = resized_shape(h, w, short_side)
            resized.append(resize_bilinear_u8(
                _to_device(image, device)[None], out_h, out_w
            )[0])
            scales.append(scale)
        return resized, scales

    def resize_out(faces_per_image, scales):
        if not isinstance(scales, list):
            scales = [scales] * len(faces_per_image)

        new_faces_per_image = []
        for faces, scale in zip(faces_per_image, scales):
            new_faces = []
            for face in faces:
                new_faces.append({
                    "bbox": np.around(face["bbox"] / scale).astype(np.int32),
                    "landmarks": np.around(
                        face["landmarks"] / scale
                    ).astype(np.int32),
                    "score": face["score"],
                })
            new_faces_per_image.append(new_faces)
        return new_faces_per_image

    return resize_in, resize_out


def merge_factory(method="padding", coord_keys=("bbox", "landmarks")):
    """Build (merge_in, merge_out) closures padding a list of images into one
    array with centre padding, adjusting output coordinates back.

    ``coord_keys`` selects which result fields get pad-adjusted:
    - face detections carry 'bbox' (x1,y1,x2,y2) and 'landmarks' (5,2);
    - pose results carry 'keypoints' (18,3) where absent keypoints (flag 0)
      are reset to zero after adjustment (pose/__init__.py:110-113).
    """

    def merge_in(images):
        if isinstance(images, (np.ndarray, torch.Tensor)):
            return images, {"merged": False}

        params = {"merged": True}
        if method == "crop":
            raise NotImplementedError
        if method != "padding":
            raise ValueError(
                "Invalid `method` set, options are `padding` or `crop`."
            )

        max_height = max(arr.shape[0] for arr in images)
        max_width = max(arr.shape[1] for arr in images)
        shape = (len(images), max_height, max_width, 3)
        # Device tensors (frames resized on the card) are padded there.
        on_device = isinstance(images[0], torch.Tensor)
        padded = (
            torch.zeros(shape, dtype=torch.uint8, device=images[0].device)
            if on_device else np.zeros(shape, dtype=np.uint8)
        )

        pads_per_image = []
        for idx, image in enumerate(images):
            diff_height = max(0, (max_height - image.shape[0]) / 2)
            diff_width = max(0, (max_width - image.shape[1]) / 2)
            pad_values = [
                (int(math.ceil(diff_height)), int(math.floor(diff_height))),
                (int(math.ceil(diff_width)), int(math.floor(diff_width))),
                (0, 0),
            ]
            top, left = pad_values[0][0], pad_values[1][0]
            padded[idx, top:top + image.shape[0],
                   left:left + image.shape[1]] = image
            pads_per_image.append(pad_values)

        params["pads_per_image"] = pads_per_image
        return padded, params

    def merge_out(objects_per_image, params):
        if not params["merged"]:
            return objects_per_image

        new_objects_per_image = []
        for objects, pads in zip(objects_per_image, params["pads_per_image"]):
            new_objects = []
            for obj in objects:
                new_obj = dict(obj)
                if "bbox" in coord_keys and "bbox" in obj:
                    new_obj["bbox"] = np.array([
                        obj["bbox"][0] - pads[1][0],
                        obj["bbox"][1] - pads[0][0],
                        obj["bbox"][2] - pads[1][0],
                        obj["bbox"][3] - pads[0][0],
                    ])
                if "landmarks" in coord_keys and "landmarks" in obj:
                    pads_per_axis = np.array(
                        [pads[1][0], pads[0][0]]
                    ).reshape(1, -1)
                    new_obj["landmarks"] = obj["landmarks"] - pads_per_axis
                if "keypoints" in coord_keys and "keypoints" in obj:
                    pads_per_axis = np.array(
                        [pads[1][0], pads[0][0], 0]
                    ).reshape(1, -1)
                    keypoints = obj["keypoints"] - pads_per_axis
                    keypoints[keypoints[..., 2] == 0] = 0
                    new_obj["keypoints"] = keypoints
                new_objects.append(new_obj)
            new_objects_per_image.append(new_objects)
        return new_objects_per_image

    return merge_in, merge_out
