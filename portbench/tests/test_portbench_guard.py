"""What the benchmark may load: never the JAX stack or the JAX package
(whose name the program's begins with, so names are compared whole), and
in the reference nothing of the program."""

import ast

import pytest

from conftest import BENCH


@pytest.mark.parametrize("modules, found", [
    (["terran_tpu_torch", "terran_tpu_torch.pipeline", "torch"], []),
    (["terran_tpu", "terran_tpu_torch"], ["terran_tpu"]),
    (["terran_tpu.pipeline"], ["terran_tpu"]),
    (["jax._src.core", "jaxlib.xla_client", "flax"], ["flax", "jax",
                                                     "jaxlib"]),
    (["jaxtyping", "flaxen", "terran_tpu_other"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(modules, found):
    import run

    assert run.forbidden_modules(modules) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0], node


def test_the_reference_imports_nothing_of_the_program_or_jax():
    files = list((BENCH / "reference").glob("*.py"))
    assert files
    for path in files:
        for name, _ in _imports(path):
            assert name not in ("terran_tpu_torch", "terran_tpu", "jax",
                                "jaxlib", "flax"), (path.name, name)


def test_the_harness_imports_no_jax_and_the_program_only_in_functions():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    for path in files:
        tree = ast.parse(path.read_text())
        top = {id(n) for n in tree.body}
        for name, node in _imports(path):
            assert name not in ("terran_tpu", "jax", "jaxlib", "flax"), (
                path.name, name)
            if name == "terran_tpu_torch":
                assert id(node) not in top, path.name


def test_a_run_loads_no_jax(tiny):
    import sys

    from conftest import run_tiny

    run, spec = tiny
    run_tiny(run, spec, "bf16-offline-1080p", seconds=1.0)
    assert run.forbidden_modules(sys.modules) == []


@pytest.mark.parametrize("phase", ["judge", "power_limit"])
def test_a_forbidden_module_loaded_after_the_window_ends_the_run(
        tiny, monkeypatch, capsys, phase):
    """The check holds up to the result: a JAX module that the comparison,
    or the last step before the result, loads stops the run, and nothing
    is printed on standard output."""
    import sys
    import types

    run, spec = tiny
    original, parse = getattr(run, phase), run.parse

    def loading(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return original(*args, **kwargs)

    monkeypatch.setattr(run, phase, loading)
    monkeypatch.setattr(run, "parse", lambda argv=None: parse(
        ["--workload", "bf16-offline-1080p", "--seed", "3",
         "--seconds", "1"]))
    with pytest.raises(SystemExit) as ended:
        run.main()
    assert "jax" in str(ended.value)
    assert capsys.readouterr().out == ""
