"""``ops/_cuda.py``'s build of the port's native code, on the CPU: the host
helper (``csrc/weights_snapshot.cpp``) builds with the host's C++ compiler and
imports; builds of one source started at once run one compiler, the others
waiting on the build directory's lock; a failed build raises with the
compiler's output. The compiler is stood in for where only the build's
bookkeeping is under test.
"""

import sys
import threading

import pytest
import torch

from obs_rvc_tpu_torch.ops import _cuda


def test_the_host_helper_builds_imports_and_is_keyed_by_torch_and_python():
    snapshot = _cuda.extension("weights_snapshot").Snapshot()
    t = torch.zeros(3)
    assert snapshot.take([t]) == 1 and len(snapshot) == 1
    assert snapshot.advance() == 1
    t.add_(1.0)
    assert snapshot.advance() == 2
    with pytest.raises(TypeError, match="not a tensor"):
        snapshot.take([t, 3])
    assert "weights_snapshot" in _cuda.host_sources() and "weights_snapshot" not in _cuda.sources()
    name = _cuda._lib_path("weights_snapshot").name
    assert name.startswith("weights_snapshot-") and name.endswith(".so")


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    """A source directory with one host source, ``fake.cpp``, whose compiler
    is a Python process that notes each run in ``runs`` and writes its output
    after ``delay`` seconds (or fails with ``error``)."""
    src, build = tmp_path / "csrc", tmp_path / "_build"
    src.mkdir()
    (src / "fake.cpp").write_text("// stands in for a host helper\n")
    runs = tmp_path / "runs"
    runs.write_text("")
    monkeypatch.setattr(_cuda, "SRC_DIR", src)
    monkeypatch.setattr(_cuda, "BUILD_DIR", build)
    behaviour = {"delay": 0.3, "error": None}

    def command(name, out):
        body = (f"import sys, time; open({str(runs)!r}, 'a').write('x'); time.sleep({behaviour['delay']}); "
                + (f"print({behaviour['error']!r}); sys.exit(1)" if behaviour["error"]
                   else f"open({out!r}, 'w').write('built')"))
        return [sys.executable, "-c", body]

    monkeypatch.setattr(_cuda, "_cxx_command", command)
    return runs, behaviour


def test_builds_of_one_source_at_once_run_its_compiler_once(stand_in):
    runs, _ = stand_in
    errors = []

    def build():
        try:
            _cuda.build(["fake"])
        except Exception as e:  # noqa: BLE001 (the thread's failure is the test's)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    assert runs.read_text() == "x"
    assert _cuda._lib_path("fake").read_text() == "built"
    assert _cuda.build(["fake"]) == 0.0 and runs.read_text() == "x"


def test_a_failed_build_raises_with_the_compilers_output(stand_in):
    _, behaviour = stand_in
    behaviour.update(delay=0.0, error="fake.cpp:1: error: no such thing")
    with pytest.raises(RuntimeError, match="no such thing"):
        _cuda.build(["fake"])
    assert not _cuda._lib_path("fake").exists()
    assert not list(_cuda.BUILD_DIR.glob("*.tmp"))
