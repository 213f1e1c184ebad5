"""The serving path's spans and counters (``serve/metrics.py``) on the CPU:
a session and a pool fill the process's collector and their own, a capture
counts apart when a serving step makes it, the spans are CPU-side profiler
ranges, the weights checks and the changes they find are counted, the stage
clock's arithmetic (device events stood in for), and the benchmark's readers
of the collector. Reduced widths (``CV``/``RM``/``SY``) and the small
geometry of the session tests. That the card's events add no synchronize,
and a reload while serving, are held by ``tests/test_torch_port_cuda.py``.
"""

import importlib.util
import json
import pathlib
import urllib.request

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.serve import metrics
from obs_rvc_tpu_torch.serve.health import start_health_server
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamPool, StreamSession, graphs
from obs_rvc_tpu_torch.stream.graphs import GraphedFunction, StageClock

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import CV, RM, SY, voiced_signal

REPO = pathlib.Path(__file__).resolve().parents[1]
GEOMETRY = dict(sample_length=0.10, extra_inference_time=0.50)
STAGES = {"pre", "features", "mel", "salience", "pitch_post", "synth", "post"}
#: the parts of ``session.chunk``, one each a chunk, one after another
PARTS = ("session.pop", "session.enqueue", "session.wait", "session.download", "session.push")
PHASES = ("controls", "drain", "dispatch", "d2h", "merge")


def make_pipe(seed=0):
    pipe = RvcPipeline(ChunkConfig.build(**GEOMETRY), contentvec_cfg=ContentVecConfig(**CV),
                       rmvpe_cfg=RMVPEConfig(**RM), synth_cfg=SynthesizerConfig(**SY), device="cpu")
    pipe.init_params(seed)
    return pipe


@pytest.fixture(scope="module")
def pipe():
    return make_pipe()


@pytest.fixture(autouse=True)
def fresh_collector():
    metrics.reset()
    graphs._PENDING.clear()
    yield
    metrics.reset()
    graphs._FREE_EVENTS.clear()


def _chunks(pipe, n, seed=0):
    wav = voiced_signal(n, pipe.cfg, seed=seed)
    size = pipe.cfg.sample_frame_size
    return [wav[k * size : (k + 1) * size] for k in range(n)]


def _serve(session, chunks):
    with torch.no_grad():
        for c in chunks:
            session.push_audio(c)
            assert session.process_pending() == 1


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_a_session_fills_the_collectors(pipe, mode):
    sess = StreamSession(pipe, StepControls.default(pitch_shift=2.0), mode=mode)
    sess.prepare()
    n = 3
    _serve(sess, _chunks(pipe, n))
    assert sess.process_pending() == 0  # a pop with no chunk records nothing
    door = sess.metrics.snapshot().spans
    for snap in (metrics.process_snapshot()["spans"], door):
        for name in ("session.chunk", "session.host") + PARTS:
            assert snap[name]["count"] == n, name
    chunk, host = metrics.process_samples("session.chunk"), metrics.process_samples("session.host")
    parts = [metrics.process_samples(p) for p in PARTS]
    wait = metrics.process_samples("session.wait")
    for k in range(n):
        assert sum(p[k] for p in parts) <= chunk[k]
        assert host[k] == pytest.approx(chunk[k] - wait[k])
    # the fused graph checks its weights on every call; the staged graphs on a card only
    assert ("session.weights_check" in door) == (mode == "fused")
    counters = metrics.process_snapshot()["counters"]
    assert counters["graph.copies"] > 0 and "graph.replays" not in counters  # no graph on the CPU
    assert sess.metrics.snapshot().counters == counters


def test_a_pool_fills_the_collectors(pipe):
    pool = StreamPool(pipe, capacity=2, batch_min=1)
    slots = [pool.attach() for _ in range(2)]
    pool.prepare()
    ticks = 2
    chunks = _chunks(pipe, ticks)
    with torch.no_grad():
        for c in chunks:
            for s in slots:
                pool.push_audio(s, c)
            assert pool.process_pending() == 2
            assert set(pool.last_tick_phases) == {f"{p}_ms" for p in PHASES}
            for p in PHASES:  # the same clocks' readings
                assert metrics.process_samples(f"pool.{p}")[-1] == pool.last_tick_phases[f"{p}_ms"]
        assert pool.process_pending() == 0  # no tick: no phase recorded
    for snap in (metrics.process_snapshot()["spans"], pool.metrics.snapshot().spans):
        assert {p: snap[f"pool.{p}"]["count"] for p in PHASES} == {p: ticks for p in PHASES}


def test_captures_count_apart_when_a_serving_step_makes_them():
    door = metrics.ChunkMetrics(chunk_seconds=0.1)
    metrics.count_capture()  # outside any door: the process's alone
    with door.door("session", serving=False):
        metrics.count_capture()
    with door.door("session"):
        metrics.count_capture()
    assert (metrics.process_counter("captures"), metrics.process_counter("serving_captures")) == (3, 1)
    assert door.snapshot().counters == {"captures": 2, "serving_captures": 1}


def _capture_on_the_cpu(self):
    """``GraphedFunction.capture`` stood in for on the CPU: the same weights
    test a card makes, and a capture counted where a card would capture."""
    key = self._version.key() if self._version is not None else None
    if getattr(self, "_held_key", "nothing") == key:
        return False
    self._held_key = key
    metrics.count_capture()
    return True


def test_a_weights_reload_counts_a_serving_capture(monkeypatch):
    """The counter's logic through a session's doors: a graph's capture on
    the CPU stood in for by the same weights test a card makes, no graph."""
    monkeypatch.setattr(GraphedFunction, "capture", _capture_on_the_cpu)
    pipe = make_pipe()
    sess = StreamSession(pipe, StepControls.default(), mode="fused")
    sess.prepare()
    assert (metrics.process_counter("captures"), metrics.process_counter("serving_captures")) == (1, 0)
    chunks = _chunks(pipe, 3)
    _serve(sess, chunks[:2])
    assert (metrics.process_counter("captures"), metrics.process_counter("serving_captures")) == (1, 0)
    pipe.init_params(1)  # load_state_dict: the versions bumped
    _serve(sess, chunks[2:])
    assert (metrics.process_counter("captures"), metrics.process_counter("serving_captures")) == (2, 1)
    assert sess.metrics.snapshot().counters["captures"] == 2
    assert sess.metrics.snapshot().counters["serving_captures"] == 1


def test_weights_checks_count_and_only_a_reload_counts_a_change(monkeypatch):
    """``weights.checks`` counts every weights check of a session's graph,
    ``weights.changes`` only the one after a reload; both in the door's
    ``/metrics`` counters beside ``serving_captures``."""
    monkeypatch.setattr(GraphedFunction, "capture", _capture_on_the_cpu)
    pipe = make_pipe()
    sess = StreamSession(pipe, StepControls.default(), mode="fused")
    sess.prepare()
    checks = metrics.process_counter("weights.checks")
    assert checks >= 1 and metrics.process_counter("weights.changes") == 0
    chunks = _chunks(pipe, 4)
    _serve(sess, chunks[:2])
    assert (metrics.process_counter("weights.checks"), metrics.process_counter("weights.changes")) == (checks + 2, 0)
    pipe.init_params(1)  # load_state_dict: the versions bumped
    _serve(sess, chunks[2:])
    assert (metrics.process_counter("weights.checks"), metrics.process_counter("weights.changes")) == (checks + 4, 1)
    server, port = start_health_server(sess.metrics)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            counters = json.loads(r.read())["counters"]
    finally:
        server.shutdown()
        server.server_close()
    assert counters == metrics.process_snapshot()["counters"]
    assert (counters["weights.checks"], counters["weights.changes"], counters["serving_captures"]) == (checks + 4, 1, 1)


def test_spans_are_cpu_side_profiler_ranges(pipe):
    sess = StreamSession(pipe, StepControls.default(), mode="staged")
    pool = StreamPool(pipe, capacity=2, batch_min=1)
    slots = [pool.attach() for _ in range(2)]
    chunk = _chunks(pipe, 1)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        sess.push_audio(chunk)
        sess.process_pending()
        for s in slots:
            pool.push_audio(s, chunk)
        pool.process_pending()
    ranges = [e for e in prof.events() if e.name.startswith(("session.", "pool."))]
    assert {e.name for e in ranges} >= {"session.chunk", *PARTS, *(f"pool.{p}" for p in PHASES)}
    assert not any(e.is_user_annotation for e in ranges)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ranges)


def test_stage_timing_keeps_the_cpus_wall_times_with_the_door(pipe):
    timed = StreamSession(pipe, StepControls.default(), mode="staged", stage_timing=True)
    _serve(timed, _chunks(pipe, 2))
    assert set(timed.metrics.snapshot().stage_p50_ms) == STAGES
    assert timed.metrics.snapshot().spans["stage.synth"]["count"] == 2
    untimed = StreamSession(pipe, StepControls.default(), mode="staged")
    _serve(untimed, _chunks(pipe, 2))
    assert untimed.metrics.snapshot().stage_p50_ms == {}
    # the process's stage samples are the card's events alone
    assert not any(n.startswith("stage") for n in metrics.process_snapshot()["spans"])
    times = {}
    pipe.staged_step(pipe.new_state(), torch.from_numpy(_chunks(pipe, 1)[0]), StepControls.default(),
                     stage_times=times)
    assert set(times) == STAGES and all(v > 0 for v in times.values())


class _Event:
    """A CUDA timing event stood in for: a time in ms, completed or not."""

    def __init__(self, t):
        self.t, self.completed = t, False

    def elapsed_time(self, other):
        return other.t - self.t

    def query(self):
        return self.completed

    def synchronize(self):
        self.completed = True


def _card_clock(times, door=None):
    if door is not None:
        with door.door("pool"):
            clock = StageClock(torch.device("cpu"))
    else:
        clock = StageClock(torch.device("cpu"))
    clock.on_card = True
    marks = iter(times)
    clock._mark = lambda: _Event(next(marks))
    return clock


def test_the_stage_clock_times_each_stage_and_the_waits_between():
    door = metrics.ChunkMetrics(chunk_seconds=0.1)
    clock = _card_clock([0.0, 1.0, 3.0, 5.0, 9.0, 10.0], door)
    for name in ("pre", "features/embed", "mel", "synth"):
        clock.time(name, lambda: None)
    # a features segment is not timed, and no gap is counted across it
    assert clock.times() == ({"pre": 1.0, "mel": 2.0, "synth": 1.0}, 4.0)
    graphs.finish_stages(clock)
    graphs.resolve_stages()  # not completed: nothing delivered, nothing waited for
    assert "stage.synth" not in metrics.process_snapshot()["spans"] and len(graphs._PENDING) == 1
    for *_, end, _ in clock.marks:
        end.completed = True
    graphs.resolve_stages()
    assert metrics.process_samples("stage.mel") == [2.0] and metrics.process_samples("stage_gap") == [4.0]
    assert door.snapshot().stage_p50_ms == {"pre": 1.0, "mel": 2.0, "synth": 1.0}

    # a caller's dict: one wait for the last event; a capture meanwhile keeps the step from the metrics
    metrics.reset()
    clock = _card_clock([0.0, 2.0, 2.5, 3.0])
    clock.time("pre", lambda: None)
    clock.time("features", lambda: None)
    metrics.count_capture()
    times = {}
    graphs.finish_stages(clock, times)
    assert times == {"pre": 2.0, "features": 0.5} and clock.marks[-1][2].completed
    graphs.resolve_stages()
    assert not graphs._PENDING and "stage.pre" not in metrics.process_snapshot()["spans"]


def test_stage_clocks_sample_the_cards_steps_and_time_the_cpus_when_asked():
    assert graphs.stage_clock("cpu") is None
    assert graphs.stage_clock("cpu", every_step=True).on_card is False


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def test_the_benchmarks_readers_take_medians_of_the_process_collector():
    readers = {n: _reader(n) for n in ("session_host_ms", "stage_gap_ms", "synth_path_ms", "pitch_path_ms")}
    assert all(read(None) is None for read in readers.values())
    for host in (3.0, 1.0, 2.0):
        metrics.observe({"session.host": host})
    for k in range(3):
        stages = {"mel": 0.1 * (k + 1), "salience": 1.0 + k, "pitch_post": 0.5, "synth": 2.0 + k}
        metrics.record_step_stages(None, stages, 0.3 * k, on_card=True)
    assert readers["session_host_ms"](None) == 2.0
    assert readers["stage_gap_ms"](None) == pytest.approx(0.3)
    assert readers["synth_path_ms"](None) == 3.0
    assert readers["pitch_path_ms"](None) == pytest.approx(0.2 + 2.0 + 0.5)
    metrics.reset()
    metrics.record_step_stages(None, {"mel": 1.0, "synth": 1.0}, None, on_card=False)  # the CPU's: not the process's
    assert readers["synth_path_ms"](None) is None and readers["pitch_path_ms"](None) is None
