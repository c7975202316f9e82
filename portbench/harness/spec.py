"""Checks of ``BENCHMARK.json`` against the files it names, made before a
run starts: every name and unit well formed, every cell's configuration,
mix, driver, limits and per-layer metric present as a file of its own
under the benchmark's folder, and every configuration's families bound
(``harness/families.py``) and given a control precision."""

import re
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")


def _name(value, what):
    if not isinstance(value, str) or not NAME.match(value):
        raise ValueError(f"bad {what} name {value!r}")


def _families(entry, root, bench):
    import json

    from harness import families

    with open(root / entry["file"]) as f:
        config = json.load(f)
    try:
        for name in config["models"]:
            _name(name, "family")
        families.of(config, bench)
    except ValueError as e:
        raise ValueError(f"configuration {entry['name']}: {e}") from None
    unset = [n for n in config["models"] if n not in config["control"]]
    if unset:
        raise ValueError(f"configuration {entry['name']}: no control "
                         f"precision for {unset}")


def validate(spec, bench, root):
    """Raise ``ValueError`` naming the first fault found."""
    import json

    bench, root = Path(bench), Path(root)
    configs = {}
    for c in spec["configs"]:
        _name(c["name"], "configuration")
        for key in c["reduced"]:
            _name(key, "reduced key")
        if not (root / c["file"]).is_file():
            raise ValueError(f"configuration file {c['file']} is missing")
        _families(c, root, bench)
        configs[c["name"]] = c
    metrics = spec["end_to_end"] + spec["per_layer"]
    for m in metrics:
        _name(m["name"], "metric")
        if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
            raise ValueError(f"bad unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            raise ValueError(f"bad 'better' of {m['name']}")
    if len({m["name"] for m in metrics}) != len(metrics):
        raise ValueError("two metrics share a name")
    cells = set()
    for w in spec["workloads"]:
        _name(w["name"], "workload")
        _name(w["traffic"], "traffic")
        if w["name"] in cells:
            raise ValueError(f"two cells named {w['name']}")
        cells.add(w["name"])
        if w["config"] not in configs:
            raise ValueError(f"cell {w['name']}: no configuration "
                             f"{w['config']!r}")
        mix = bench / "mixes" / f"{w['traffic']}.json"
        if not mix.is_file():
            raise ValueError(f"cell {w['name']}: no mix file {mix.name}")
        with open(mix) as f:
            driver = json.load(f)["driver"]
        _name(driver, "driver")
        if not (bench / "drivers" / f"{driver}.py").is_file():
            raise ValueError(f"mix {w['traffic']}: no driver {driver}.py")
        if not (bench / "limits" / f"{w['name']}.json").is_file():
            raise ValueError(f"cell {w['name']}: no limits file")
    for m in spec["per_layer"]:
        if not (bench / "metrics" / f"{m['name']}.py").is_file():
            raise ValueError(f"per-layer metric {m['name']}: no reader")
    for m in metrics:
        for cell in m.get("workloads", []):
            if cell not in cells:
                raise ValueError(f"metric {m['name']}: no cell {cell!r}")
