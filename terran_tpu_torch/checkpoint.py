"""Pretrained-checkpoint registry, resolution, download and commands.

The registry, home directory and ``<id>.npz`` store of
``terran_tpu/checkpoint.py``: both packages read and write the same
converted store under ``TERRAN_TPU_HOME`` (default ``~/.terran-tpu``).
This one turns the stored JAX pytrees into state dicts with
:func:`terran_tpu_torch.utils.convert.params_from_jax`, and writes them
with :func:`terran_tpu_torch.utils.convert.convert_torch_checkpoint`. An
entry's ``class`` names this package's wrapper: RetinaFace, ArcFace and
OpenPose.

A checkpoint missing from the store is downloaded on first use (asking
first on a terminal), from the reference's released ``.pth`` files, over
``urllib`` with retries, and converted into the store. The ``list``,
``info``, ``delete``, ``download`` and ``convert`` commands
(``terran_tpu_torch.cli``) print what the JAX package's commands print.
"""

import importlib
import os
import shutil
import sys
import tempfile
import time
import urllib.request
from pathlib import Path
from urllib.error import HTTPError

from terran_tpu_torch.utils.profiling import get_logger

DEFAULT_HOME = Path("~/.terran-tpu")
CHECKPOINT_DIR = "checkpoints"

# The JAX package's labels, so that both packages' commands print the same
# lines.
LABELS_BY_TASK = {
    "face-detection": "Face detection (`terran_tpu.face.Detection`)",
    "face-recognition": "Face recognition (`terran_tpu.face.Recognition`)",
    "pose-estimation": "Pose estimation (`terran_tpu.pose.Estimation`)",
}

DOWNLOAD_TIMEOUT_S = 60
DOWNLOAD_CHUNK = 16 * 1024

# Same ids, tasks and aliases as the reference registry (checkpoint.py:29-103).
CHECKPOINTS = [
    {
        "id": "b5d77fff",
        "name": "RetinaFace",
        "description": "RetinaFace with mnet backbone.",
        "task": "face-detection",
        "class": "terran_tpu_torch.face.detection.RetinaFaceDetector",
        "model_key": "retinaface",
        "alias": "gpu-realtime",
        "default": True,
        "performance": 1.0,
        "evaluation": {"value": 0.76, "metric": "mAP", "is_reported": False},
        "url": (
            "https://github.com/nagitsu/terran/releases/download/0.0.1/"
            "retinaface-mnet.pth"
        ),
    },
    {
        "id": "d206e4b0",
        "name": "ArcFace",
        "description": "ArcFace with Resnet 100 backbone.",
        "task": "face-recognition",
        "class": "terran_tpu_torch.face.recognition.ArcFaceRecognizer",
        "model_key": "arcface",
        "alias": "gpu-realtime",
        "default": True,
        "performance": 0.9,
        "evaluation": {"value": 0.80, "metric": "accuracy",
                       "is_reported": False},
        "url": (
            "https://github.com/nagitsu/terran/releases/download/0.0.1/"
            "arcface-resnet100.pth"
        ),
    },
    {
        "id": "11a769ad",
        "name": "OpenPose",
        "description": (
            "OpenPose with VGG backend, 2017 version. Has some modifications, "
            "improving computational efficiency by giving up mAP."
        ),
        "task": "pose-estimation",
        "class": "terran_tpu_torch.pose.openpose.OpenPoseEstimator",
        "model_key": "openpose",
        "alias": "gpu-realtime",
        "default": True,
        "performance": 1.8,
        "evaluation": {"value": 0.65, "metric": "mAP", "is_reported": True},
        "url": (
            "https://github.com/nagitsu/terran/releases/download/0.0.1/"
            "openpose-body.pth"
        ),
    },
]


def get_home(create_if_missing=True):
    """Framework home dir; override with TERRAN_TPU_HOME (ref: TERRAN_HOME,
    checkpoint.py:118-120)."""
    path = Path(os.environ.get("TERRAN_TPU_HOME", DEFAULT_HOME)).expanduser()
    if create_if_missing:
        path.mkdir(parents=True, exist_ok=True)
    return path


def get_checkpoints_directory():
    path = get_home() / CHECKPOINT_DIR
    path.mkdir(parents=True, exist_ok=True)
    return path


def read_checkpoint_db():
    """Database = registry x filesystem presence (checkpoint.py:145-169)."""
    directory = get_checkpoints_directory()
    local = {p.stem for p in directory.glob("*.npz")}
    checkpoints = [
        {
            "status": "DOWNLOADED" if c["id"] in local else "NOT_DOWNLOADED",
            "local_path": (
                directory / f"{c['id']}.npz" if c["id"] in local else None
            ),
            **c,
        }
        for c in CHECKPOINTS
    ]
    return {"checkpoints": checkpoints}


def get_checkpoint(db, id_or_alias):
    """Resolve by id, or by (task, alias-or-default) tuple (ref :172-210)."""
    if isinstance(id_or_alias, tuple):
        task_name, alias = id_or_alias
        selected = [
            c for c in db["checkpoints"]
            if c["task"] == task_name
            and (c["alias"] == alias if alias is not None else c["default"])
        ]
    else:
        selected = [c for c in db["checkpoints"] if c["id"] == id_or_alias]
    if not selected:
        return None
    if len(selected) > 1:
        get_logger().warning(
            "multiple checkpoints found for %r (%d); returning the first",
            id_or_alias, len(selected),
        )
    return selected[0]


def get_class_for_checkpoint(task_name, alias):
    """Import the wrapper class for a (task, alias) (ref :213-245)."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint(db, (task_name, alias))
    if not checkpoint:
        raise ValueError("Checkpoint not found.")
    module_path, class_name = checkpoint["class"].rsplit(".", maxsplit=1)
    return getattr(importlib.import_module(module_path), class_name)


def get_checkpoint_by_class(db, class_path):
    selected = [c for c in db["checkpoints"] if c["class"] == class_path]
    return selected[0] if selected else None


def get_checkpoint_path(model_class_path, prompt=True):
    """Local path of the converted weights for a wrapper class, downloading
    and converting them first when the store lacks them. On a terminal
    (``prompt`` and a tty on stdout) it asks first; a "no" raises
    ``SystemExit(1)``."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint_by_class(db, model_class_path)
    if not checkpoint:
        raise ValueError("Checkpoint not found.")
    if checkpoint["status"] == "NOT_DOWNLOADED":
        if prompt and sys.stdout.isatty():
            _confirm_download()
        download_remote_checkpoint(db, checkpoint)
    return checkpoint["local_path"]


def _confirm_download():
    try:
        answer = input(
            "Checkpoint not present locally. Want to download it? [y/N]: ")
    except EOFError:
        answer = ""
    if answer.strip().lower() not in ("y", "yes"):
        print("Aborted!", file=sys.stderr)
        raise SystemExit(1)


def load_checkpoint_params(model_class_path, prompt=True):
    """State dict (float32 tensors) for a wrapper class, from the store."""
    from terran_tpu_torch.utils.convert import load_params, params_from_jax

    return params_from_jax(load_params(
        get_checkpoint_path(model_class_path, prompt=prompt)))


def convert_local_checkpoint(checkpoint, pth_path):
    """Convert a local torch ``.pth`` into the store as ``<id>.npz``."""
    from terran_tpu_torch.utils.convert import convert_torch_checkpoint

    out_path = get_checkpoints_directory() / f"{checkpoint['id']}.npz"
    convert_torch_checkpoint(checkpoint["model_key"], pth_path, out_path)
    checkpoint["status"] = "DOWNLOADED"
    checkpoint["local_path"] = out_path
    return out_path


def _fetch(url, path):
    """Stream ``url`` into ``path`` in DOWNLOAD_CHUNK pieces; a status other
    than 200 raises ``ValueError``."""
    try:
        response = urllib.request.urlopen(url, timeout=DOWNLOAD_TIMEOUT_S)
    except HTTPError as exc:
        raise ValueError(f"Invalid checkpoint URL {url}") from exc
    with response:
        if response.status != 200:
            raise ValueError(f"Invalid checkpoint URL {url}")
        length = response.headers.get("Content-Length", "?")
        print("Downloading checkpoint...", flush=True)
        chunks = received = 0
        with open(path, "wb") as f:
            while chunk := response.read(DOWNLOAD_CHUNK):
                f.write(chunk)
                chunks += 1
                received += len(chunk)
        print(f"Downloaded {received} of {length} bytes in {chunks} chunks.",
              flush=True)


def download_remote_checkpoint(db, checkpoint, retries=3):
    """Download the upstream ``.pth``, convert it and store it, trying
    ``retries`` times with a backoff of ``2 ** attempt`` seconds; the last
    error is raised, with a note naming the URL."""
    if checkpoint["local_path"] and checkpoint["local_path"].exists():
        print(f"Checkpoint file already present at "
              f"{checkpoint['local_path']}.")
        return

    url = checkpoint["url"]
    tempdir = tempfile.mkdtemp()
    pth_path = Path(tempdir) / f"{checkpoint['id']}.pth"
    try:
        for attempt in range(retries):
            try:
                _fetch(url, pth_path)
                break
            except (OSError, ValueError) as exc:
                if attempt == retries - 1:
                    exc.add_note(f"downloading {url} failed {retries} times")
                    raise
                get_logger().warning("downloading %s failed (%s); retry %d "
                                     "of %d", url, exc, attempt + 1,
                                     retries - 1)
                time.sleep(2.0 ** attempt)

        out_path = convert_local_checkpoint(checkpoint, pth_path)
        print(f"Checkpoint downloaded and converted to {out_path}.")
    finally:
        shutil.rmtree(tempdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Commands (``terran_tpu_torch.cli checkpoint ...``), printing the lines of
# the JAX package's click commands.
# ---------------------------------------------------------------------------

def _columns(rows, min_widths):
    """Per-column widths sized to content (with floors)."""
    widths = list(min_widths)
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(str(cell)))
    return widths


def _grid_row(cells, widths):
    return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()


def list_cmd():
    """List available checkpoints."""
    db = read_checkpoint_db()
    if not db["checkpoints"]:
        print("No checkpoints available.")
        return

    by_task = {}
    for checkpoint in db["checkpoints"]:
        by_task.setdefault(checkpoint["task"], []).append(checkpoint)

    heading = ("NAME", "ALIAS", "EVAL", "PERF", "STATUS")
    all_rows = []
    sections = []
    for task, group in by_task.items():
        rows = [
            (
                f"{c['name']} ({c['id']})",
                c["alias"],
                "{:.2f} {}".format(
                    c["evaluation"]["value"], c["evaluation"]["metric"]
                ),
                f"{c['performance']:.1f}",
                c["status"],
            )
            for c in group
        ]
        sections.append((LABELS_BY_TASK.get(task, task), rows))
        all_rows.extend(rows)

    widths = _columns([heading] + all_rows, min_widths=(4, 4, 4, 4, 4))
    rule = "-" * (sum(widths) + 2 * (len(widths) - 1))
    for label, rows in sections:
        print(label)
        print(rule)
        print(_grid_row(heading, widths))
        for row in rows:
            print(_grid_row(row, widths))
        print()


def info_cmd(checkpoint_id):
    """Display detailed information on checkpoint."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint(db, checkpoint_id)
    if not checkpoint:
        print(f"Checkpoint '{checkpoint_id}' not found in index.")
        return

    evaluation = "{:.3f} {}".format(
        checkpoint["evaluation"]["value"], checkpoint["evaluation"]["metric"]
    )
    if checkpoint["evaluation"]["is_reported"]:
        evaluation += " (self-reported)"
    if checkpoint["local_path"]:
        status = f"DOWNLOADED (at `{checkpoint['local_path']}`)"
    else:
        status = "NOT_DOWNLOADED"

    print(f"{checkpoint['name']} ({checkpoint['id']}, {checkpoint['alias']})")
    if checkpoint["description"]:
        print(f" > {checkpoint['description']}")
    print()

    fields = [
        ("Task", LABELS_BY_TASK.get(checkpoint["task"], checkpoint["task"])),
        ("Class", f"`{checkpoint['class']}`"),
        ("Evaluation", evaluation),
        ("Performance", f"{checkpoint['performance']:.2f} units"),
        ("Upstream URL", checkpoint["url"]),
        ("Status", status),
    ]
    name_width = max(len(name) for name, _ in fields)
    for name, value in fields:
        print(f"{name.ljust(name_width)}  {value}")


def delete_cmd(checkpoint_id):
    """Delete local files for a checkpoint."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint(db, checkpoint_id)
    if not checkpoint:
        print(f"Checkpoint `{checkpoint_id}` not found in index.")
        return
    if checkpoint["status"] == "NOT_DOWNLOADED":
        print("Checkpoint isn't downloaded. Nothing to delete.")
        return
    checkpoint["local_path"].unlink()
    print(f"Checkpoint `{checkpoint['id']}` deleted successfully.")


def download_cmd(checkpoint_id):
    """Download a remote checkpoint."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint(db, checkpoint_id)
    if not checkpoint:
        print(f"Checkpoint `{checkpoint_id}` not found in index.")
        return
    if checkpoint["status"] != "NOT_DOWNLOADED":
        print("Checkpoint is already downloaded.")
        return
    download_remote_checkpoint(db, checkpoint)


def convert_cmd(checkpoint_id, pth_path):
    """Convert a local torch .pth file into the checkpoint store."""
    db = read_checkpoint_db()
    checkpoint = get_checkpoint(db, checkpoint_id)
    if not checkpoint:
        print(f"Checkpoint `{checkpoint_id}` not found in index.")
        return
    out_path = convert_local_checkpoint(checkpoint, pth_path)
    print(f"Converted to {out_path}.")
