"""Image input: ``open_image`` and ``resolve_images``, copied from
``terran_tpu/io/image.py``.

``open_image`` accepts filesystem paths and URLs (fetched with a Chrome
user agent, over ``urllib``). ``resolve_images`` recursively collects the
valid images under a directory, in batches when asked; the trailing
partial batch is yielded. Both need Pillow, which they import when called:
importing this module needs none.
"""

import urllib.request
from io import BytesIO
from pathlib import Path
from urllib.parse import urlparse

import numpy as np

USER_AGENT = (
    "Mozilla/5.0 (X11; Linux x86_64) AppleWebKit/537.36 (KHTML, like Gecko) "
    "Chrome/51.0.2704.103 Safari/537.36"
)

URL_TIMEOUT_S = 60


def open_image(uri):
    """Open the image at ``uri`` (path or URL) as an RGB HWC uint8 array."""
    from PIL import Image

    if isinstance(uri, Path):
        image = Image.open(uri)
    elif urlparse(str(uri)).scheme in ("http", "https"):
        request = urllib.request.Request(
            str(uri), headers={"User-Agent": USER_AGENT})
        with urllib.request.urlopen(request, timeout=URL_TIMEOUT_S) as resp:
            image = Image.open(BytesIO(resp.read()))
    else:
        image = Image.open(Path(uri).expanduser())

    image = np.asarray(image.convert("RGB"))
    if len(image.shape) == 2:
        image = np.stack([image] * 3, axis=-1)
    return image


def resolve_images(path, batch_size=None):
    """Yield paths (or batches of paths) of all valid images under ``path``,
    in sorted order. Validity is PIL's ``verify()``. With ``batch_size``
    set, the final partial batch is yielded too."""
    from PIL import Image

    if not isinstance(path, Path):
        path = Path(path).expanduser()

    batch = []
    for f in sorted(path.glob("**/*")):
        if not f.is_file():
            continue
        try:
            Image.open(f).verify()
        except Exception:
            continue

        if batch_size is None:
            yield f
            continue

        batch.append(f)
        if len(batch) >= batch_size:
            yield batch
            batch = []

    if batch_size is not None and batch:
        yield batch
