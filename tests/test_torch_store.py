"""The port's checkpoint store writers, download and commands against the
JAX package's.

- ``params_to_jax`` and ``convert_torch_checkpoint`` write what the JAX
  converters write: the same keys in the same order, dtypes, shapes,
  bytes and ``.npy`` members (exact), for the three families at two seeds;
- a store written by either package loads in the other (exact);
- the port's ``cli.main`` prints what the JAX click commands print, line
  for line, apart from the ``Class`` line of ``info``;
- download over a server on 127.0.0.1 (nothing leaves the machine):
  success, retries, giving up, and the prompt on a terminal.
"""

import tempfile
import zipfile
from urllib.error import URLError

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from terran_tpu import checkpoint as jax_ckpt
from terran_tpu.utils import convert as jax_convert
from terran_tpu_torch import checkpoint as ckpt
from terran_tpu_torch import cli
from terran_tpu_torch.utils import convert
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)
from torch_port_fixtures import (  # noqa: F401
    LocalServer, offline_registries, refused_url, single_torch_thread,
    with_url,
)

FAMILIES = {
    "retinaface": ("b5d77fff", random_retinaface_state_dict),
    "arcface": ("d206e4b0", random_arcface_state_dict),
    "openpose": ("11a769ad", random_openpose_state_dict),
}


@pytest.fixture(autouse=True)
def offline(offline_registries):
    """No test here reaches the reference's release URLs."""


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("TERRAN_TPU_HOME", str(tmp_path / "home"))
    return tmp_path / "home"


def save_pth(state_dict, path):
    torch.save({k: torch.as_tensor(np.ascontiguousarray(v))
                for k, v in state_dict.items()}, path)
    return path


def npz_members(path):
    with zipfile.ZipFile(path) as archive:
        return [(info.filename, archive.read(info.filename))
                for info in archive.infolist()]


@pytest.fixture(scope="module")
def retinaface_pth(tmp_path_factory):
    return save_pth(random_retinaface_state_dict(np.random.default_rng(0)),
                    tmp_path_factory.mktemp("pth") / "retinaface.pth")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_store_writer_bit_exact(family, seed, tmp_path):
    state_dict = FAMILIES[family][1](np.random.default_rng(seed))
    expected = jax_convert.flatten_tree(
        jax_convert.CONVERTERS[family](state_dict))
    got = convert.flatten_tree(
        convert.params_to_jax(convert.CONVERTERS[family](state_dict),
                              family))
    assert list(got) == list(expected)
    for key, value in expected.items():
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key

    pth = save_pth(state_dict, tmp_path / "in.pth")
    jax_convert.convert_torch_checkpoint(family, pth, tmp_path / "jax.npz")
    direct = convert.convert_torch_checkpoint(family, pth,
                                              tmp_path / "port.npz")
    # Every .npy member, header included (so also C or Fortran order).
    assert npz_members(tmp_path / "port.npz") \
        == npz_members(tmp_path / "jax.npz")
    reference = convert.CONVERTERS[family](state_dict)
    assert direct.keys() == reference.keys()
    for key in reference:
        assert torch.equal(direct[key], reference[key]), key


def test_params_to_jax_rejects_unknown_family_and_shapes():
    with pytest.raises(ValueError, match="unknown model family"):
        convert.params_to_jax({}, "resnet")
    with pytest.raises(ValueError, match="unexpected weight shape"):
        convert.params_to_jax({"x.weight": torch.zeros(3)}, "retinaface")


@pytest.mark.parametrize("family", ["retinaface", "arcface"])
def test_store_shared_between_packages(family, home, tmp_path):
    """A store written by either package loads in the other."""
    checkpoint_id, make = FAMILIES[family]
    state_dict = make(np.random.default_rng(3))
    pth = save_pth(state_dict, tmp_path / "in.pth")
    port_class = ckpt.get_checkpoint(ckpt.read_checkpoint_db(),
                                     checkpoint_id)["class"]
    jax_class = jax_ckpt.get_checkpoint(jax_ckpt.read_checkpoint_db(),
                                        checkpoint_id)["class"]
    reference = convert.CONVERTERS[family](state_dict)
    jax_reference = jax_convert.flatten_tree(
        jax_convert.CONVERTERS[family](state_dict))

    jax_ckpt.convert_local_checkpoint(
        jax_ckpt.get_checkpoint(jax_ckpt.read_checkpoint_db(),
                                checkpoint_id), pth)
    loaded = ckpt.load_checkpoint_params(port_class)
    assert loaded.keys() == reference.keys()
    for key in reference:
        assert torch.equal(loaded[key], reference[key]), key

    (home / "checkpoints" / f"{checkpoint_id}.npz").unlink()
    ckpt.convert_local_checkpoint(
        ckpt.get_checkpoint(ckpt.read_checkpoint_db(), checkpoint_id), pth)
    loaded = jax_convert.flatten_tree(jax_ckpt.load_checkpoint_params(
        jax_class))
    assert list(loaded) == list(jax_reference)
    for key, value in jax_reference.items():
        assert np.array_equal(loaded[key], value), key


def port_run(capsys, *args):
    capsys.readouterr()
    code = cli.main(["checkpoint", *args])
    return code, capsys.readouterr().out


def jax_run(*args):
    result = CliRunner().invoke(jax_ckpt.checkpoint_cmd, list(args))
    return result.exit_code, result.output


def assert_same_output(port, jax):
    """Equal exit codes and lines, but for info's ``Class`` line, which
    names each package's wrapper."""
    assert port[0] == jax[0] == 0
    port_lines, jax_lines = port[1].splitlines(), jax[1].splitlines()
    assert len(port_lines) == len(jax_lines), (port[1], jax[1])
    for mine, theirs in zip(port_lines, jax_lines):
        if theirs.startswith("Class  "):
            assert mine == theirs.replace("`terran_tpu.", "`terran_tpu_torch.")
        else:
            assert mine == theirs
    assert port[1].endswith("\n") == jax[1].endswith("\n")


SCENARIOS = {
    "list": [("list",)],
    "info": [("info", "b5d77fff"), ("info", "d206e4b0"),
             ("info", "11a769ad")],
    "info-unknown": [("info", "deadbeef"), ("delete", "deadbeef"),
                     ("download", "deadbeef"),
                     ("convert", "deadbeef", "{pth}")],
    "convert": [("convert", "b5d77fff", "{pth}")],
    "delete": [("delete", "b5d77fff"), ("delete", "b5d77fff")],
    "download": [("download", "b5d77fff")],
}
# Commands run on an empty store as well as on a stocked one, except
# ``download``, which would fetch (the download tests below serve it).
STOCKED_ONLY = {"download"}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_cli_prints_what_the_jax_cli_prints(scenario, home, capsys,
                                            retinaface_pth):
    """Each command before and after RetinaFace is in the store; where a
    command changes the store, both packages start from the same one."""
    for stocked in (True,) if scenario in STOCKED_ONLY else (False, True):
        for args in SCENARIOS[scenario]:
            args = [a.format(pth=retinaface_pth) for a in args]
            outputs = []
            for run in (lambda: jax_run(*args),
                        lambda: port_run(capsys, *args)):
                store = home / "checkpoints" / "b5d77fff.npz"
                if stocked and not store.exists():
                    ckpt.convert_local_checkpoint(ckpt.get_checkpoint(
                        ckpt.read_checkpoint_db(), "b5d77fff"),
                        retinaface_pth)
                elif not stocked and store.exists():
                    store.unlink()
                outputs.append(run())
            assert_same_output(outputs[1], outputs[0])


def test_cli_convert_needs_an_existing_file(home, tmp_path, capsys):
    missing = str(tmp_path / "missing.pth")
    code = cli.main(["checkpoint", "convert", "b5d77fff", missing])
    assert code == 2
    assert "does not exist" in capsys.readouterr().err
    assert jax_run("convert", "b5d77fff", missing)[0] == 2
    # Other usage errors: exit codes only, click's and argparse's texts
    # differ.
    for args in (["checkpoint"], ["checkpoint", "info"],
                 ["checkpoint", "bogus"]):
        assert cli.main(args) == 2
        assert CliRunner().invoke(jax_ckpt.checkpoint_cmd,
                                  args[1:]).exit_code == 2


def test_cli_runs_as_a_module(home):
    import subprocess
    import sys

    result = subprocess.run(
        [sys.executable, "-m", "terran_tpu_torch.cli", "checkpoint", "info",
         "11a769ad"], capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith("OpenPose (11a769ad, gpu-realtime)")
    assert "NOT_DOWNLOADED" in result.stdout


@pytest.fixture
def sleeps(monkeypatch):
    calls = []
    monkeypatch.setattr("time.sleep", calls.append)
    return calls


@pytest.fixture
def tempdirs(monkeypatch):
    made = []
    mkdtemp = tempfile.mkdtemp

    def record(*args, **kwargs):
        made.append(mkdtemp(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", record)
    return made


def assert_downloaded(home, state_dict, out):
    assert "Downloading checkpoint..." in out
    assert f"Checkpoint downloaded and converted to " \
           f"{home / 'checkpoints' / 'b5d77fff.npz'}." in out
    loaded = ckpt.load_checkpoint_params(
        "terran_tpu_torch.face.detection.RetinaFaceDetector")
    reference = convert.convert_retinaface(state_dict)
    for key in reference:
        assert torch.equal(loaded[key], reference[key]), key


def test_download_over_localhost(home, monkeypatch, capsys, retinaface_pth,
                                 sleeps, tempdirs):
    import os

    body = retinaface_pth.read_bytes()
    state_dict = random_retinaface_state_dict(np.random.default_rng(0))
    with LocalServer({"/rf.pth": [(200, body)]}) as server:
        with_url(monkeypatch, ckpt, "b5d77fff", server.url("/rf.pth"))
        code, out = port_run(capsys, "download", "b5d77fff")
        assert code == 0
        assert_downloaded(home, state_dict, out)
        assert f"Downloaded {len(body)} of {len(body)} bytes in " \
               f"{-(-len(body) // (16 * 1024))} chunks." in out
        assert len(server.requests) == 1
        # A second download finds it, as the JAX command does.
        assert port_run(capsys, "download", "b5d77fff") \
            == (0, "Checkpoint is already downloaded.\n")
        db = ckpt.read_checkpoint_db()
        ckpt.download_remote_checkpoint(db, ckpt.get_checkpoint(
            db, "b5d77fff"))
        assert capsys.readouterr().out == (
            "Checkpoint file already present at "
            f"{home / 'checkpoints' / 'b5d77fff.npz'}.\n")
    assert sleeps == []
    assert tempdirs and not any(os.path.exists(d) for d in tempdirs)


def test_download_retries_then_succeeds(home, monkeypatch, capsys,
                                        retinaface_pth, sleeps, tempdirs):
    """Two answers of 500, then the file: backoff 1 s, 2 s
    (tests/test_checkpoint.py's retry test, over HTTP)."""
    import os

    replies = [(500, b""), (500, b""), (200, retinaface_pth.read_bytes())]
    with LocalServer({"/rf.pth": replies}) as server:
        with_url(monkeypatch, ckpt, "b5d77fff", server.url("/rf.pth"))
        db = ckpt.read_checkpoint_db()
        checkpoint = ckpt.get_checkpoint(db, "b5d77fff")
        ckpt.download_remote_checkpoint(db, checkpoint)
        assert len(server.requests) == 3
    assert sleeps == [1.0, 2.0]
    assert checkpoint["status"] == "DOWNLOADED"
    assert_downloaded(home, random_retinaface_state_dict(
        np.random.default_rng(0)), capsys.readouterr().out)
    assert not any(os.path.exists(d) for d in tempdirs)


@pytest.mark.parametrize("failure", ["refused", "status"])
def test_download_gives_up_after_retries(failure, home, monkeypatch, sleeps,
                                         tempdirs):
    import os

    if failure == "refused":
        url, error, server = refused_url(), URLError, None
    else:
        server = LocalServer({"/rf.pth": [(503, b"")]}).__enter__()
        url, error = server.url("/rf.pth"), ValueError
    try:
        with_url(monkeypatch, ckpt, "b5d77fff", url)
        db = ckpt.read_checkpoint_db()
        with pytest.raises(error) as info:
            ckpt.download_remote_checkpoint(db, ckpt.get_checkpoint(
                db, "b5d77fff"))
        assert any(url in note for note in info.value.__notes__)
        if server is not None:
            assert f"Invalid checkpoint URL {url}" in str(info.value)
            assert len(server.requests) == 3
    finally:
        if server is not None:
            server.__exit__(None, None, None)
    assert sleeps == [1.0, 2.0]
    assert not any(os.path.exists(d) for d in tempdirs)
    assert ckpt.get_checkpoint(ckpt.read_checkpoint_db(),
                               "b5d77fff")["status"] == "NOT_DOWNLOADED"


@pytest.mark.parametrize("answer", ["y", "n"])
def test_first_use_prompts_on_a_terminal(answer, home, monkeypatch, capsys,
                                         retinaface_pth):
    asked = []

    def fake_input(question):
        asked.append(question)
        return answer

    monkeypatch.setattr("builtins.input", fake_input)
    monkeypatch.setattr("sys.stdout.isatty", lambda: True)
    class_path = "terran_tpu_torch.face.detection.RetinaFaceDetector"
    with LocalServer({"/rf.pth": [(200, retinaface_pth.read_bytes())]}) \
            as server:
        with_url(monkeypatch, ckpt, "b5d77fff", server.url("/rf.pth"))
        if answer == "y":
            path = ckpt.get_checkpoint_path(class_path)
            assert path == home / "checkpoints" / "b5d77fff.npz"
            assert path.exists() and len(server.requests) == 1
        else:
            with pytest.raises(SystemExit) as info:
                ckpt.load_checkpoint_params(class_path)
            assert info.value.code == 1
            assert server.requests == []
            assert "Aborted!" in capsys.readouterr().err
        # prompt=False downloads without asking.
        (home / "checkpoints" / "b5d77fff.npz").unlink(missing_ok=True)
        asked_before = len(asked)
        ckpt.get_checkpoint_path(class_path, prompt=False)
        assert len(asked) == asked_before
    assert asked == ["Checkpoint not present locally. Want to download it? "
                     "[y/N]: "]
