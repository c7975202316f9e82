"""What every cell shares: its files, found by name, and the program
under test built from them.

The program (``terran_tpu_torch``) is imported only inside these
functions, so that the harness loads in a directory without it and
fails there before it prints anything."""

import json
from pathlib import Path

import torch

from harness import families

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One entry of ``workloads``, its configuration, mix and limits."""

    def __init__(self, workload, spec):
        cells = {c["name"]: c for c in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; known: "
                             f"{sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.chips = self.entry["chips"]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.mix = load_json(BENCH / "mixes" / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{workload}.json")
        self.families = families.of(self.config)
        self.end_to_end = [m for m in spec["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in spec["per_layer"]
                          if workload in m.get("workloads", [workload])]

    @property
    def pipe_cfg(self):
        return self.config["pipeline"]


def make_frames(seed, count, height, width, device, stream=0):
    """(count, height, width, 3) uint8 noise frames from the seed, drawn
    on the device in one call and copied to the host, as a camera or a
    decoder hands them to the program."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + 104729 * (stream + 1)) % (2 ** 63))
    frames = torch.randint(0, 256, (count, height, width, 3),
                           generator=gen, device=device, dtype=torch.uint8)
    return frames.cpu().numpy()


def pipeline_kwargs(cell, weights, device):
    """``PerceptionPipeline``'s keywords at the configuration's settings:
    no pose and no embeddings, then each family's converted weights with
    its role switched on, then the ``"pipeline"`` settings."""
    c = cell.pipe_cfg
    kwargs = dict.fromkeys(families.SWITCHES.values(), False)
    for role, fam in cell.families.items():
        kwargs.update(fam.binding.pipeline_kwargs(weights[fam.name]))
        if role in families.SWITCHES:
            kwargs[families.SWITCHES[role]] = True
    kwargs.update(
        det_short_side=c["det_short_side"],
        pose_short_side=c["pose_short_side"], threshold=c["threshold"],
        nms_threshold=c["nms_threshold"], top_k=c["top_k"],
        max_faces=c["max_faces"], max_peaks=c["max_peaks"],
        max_escalations=c["max_escalations"],
        compute_dtype=getattr(torch, c["compute_dtype"]),
        embed_dispatch=c["embed_dispatch"], limb_dispatch=c["limb_dispatch"],
        transfer_plan=c["transfer_plan"],
        embed_precision=c["embed_precision"],
        pose_precision=c["pose_precision"], device=device)
    return kwargs


def build_pipeline(cell, weights, device):
    """``PerceptionPipeline`` at the configuration's settings."""
    from terran_tpu_torch.pipeline import PerceptionPipeline

    return PerceptionPipeline(**pipeline_kwargs(cell, weights, device))


def warm_up(pipe, frames, depth):
    """Every shape the cell uses, before the window: each program at each
    bucket (``warmup``), one whole batch, then a short stream so that the
    uploader thread and the queues have run."""
    n, h, w, _ = frames.shape
    pipe.warmup(n, h, w)
    pipe.process_batch(frames)
    for _ in pipe.process_stream([frames, frames], depth=depth):
        pass
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)


class PeakRecorder:
    """Keeps the peak tables that the program's pose assembly receives, in
    the order it receives them: the pose output of the timed path, read
    where the pipeline hands it on (host arrays, kept by reference)."""

    def __init__(self):
        self.tables = []

    def install(self):
        import terran_tpu_torch.pipeline as program

        original = getattr(program.assemble_humans, "portbench_original",
                           program.assemble_humans)

        def recording(coords, scores, valid, *args, **kwargs):
            self.tables.append((coords, scores, valid))
            return original(coords, scores, valid, *args, **kwargs)

        recording.portbench_original = original
        program.assemble_humans = recording
        return self

    def take(self, n):
        """The tables of the last ``n`` frames assembled since the last
        take, or None where the pipeline handed fewer to its assembly (the
        frames' peaks are then not compared)."""
        taken, self.tables = self.tables[-n:], []
        return taken if len(taken) == n else None


def outputs_of(peaks, out):
    """The compared outputs of one batch: the frames' detections and
    embeddings (where the pipeline embeds) from ``process_stream``'s
    result, and their peak tables (None each where they were not
    recorded)."""
    n = len(out["mask"])
    keys = [key for key in ("boxes", "landmarks", "scores", "mask",
                            "embeddings", "embeddings_mask") if key in out]
    return [{key: out[key][i] for key in keys}
            | {"peaks": None if peaks is None else peaks[i]}
            for i in range(n)]
