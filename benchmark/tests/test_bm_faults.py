"""A run with the timed path broken underneath must come out not correct,
and so must the control: the comparison has been shown to fail.

Each test drives the rest of a run (the harness's look for a card
skipped) at the CPU tests' reduced widths, with the program or the
control in the port's place, and reads ``correct`` and the checks. The
limits are the cells' own."""

import collections
import io
import json
import pathlib
import random

import numpy as np
import pytest
import torch

from benchmark import control, harness, judge
from benchmark.tests import tiny

REPO = pathlib.Path(__file__).resolve().parents[2]
LIMITS = {p: json.loads((REPO / f"benchmark/configs/rvc-v2-40k-{p}.json").read_text())["limits"]
          for p in ("rmvpe", "fcpe")}


class StateUnchanged:
    """A step that leaves the streams' state as it found it (zeros): every
    chunk is converted as if it were the stream's first."""

    def __init__(self, prog):
        self.prog = prog

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def serve(self, chunks):
        out = self.prog.serve(chunks)
        self.prog.reset()
        return out


class HalfTheBatch:
    """Half of the streams left out: the second half gets the first half's audio."""

    def __init__(self, prog):
        self.prog = prog

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def serve(self, chunks):
        out, ms, full = self.prog.serve(chunks)
        half = (out.shape[0] + 1) // 2
        out = out.copy()
        out[half:] = out[: out.shape[0] - half]
        return out, ms, full


class OneSlot:
    """One slot, among the checked ones, answered with the next slot's audio."""

    slot = 0

    def __init__(self, prog):
        self.prog = prog

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def serve(self, chunks):
        out, ms, full = self.prog.serve(chunks)
        out = out.copy()
        out[self.slot] = out[(self.slot + 1) % out.shape[0]]
        return out, ms, full


class EveryOtherChunk:
    """Every other chunk altered where it is produced: 6 dB quieter."""

    def __init__(self, prog):
        self.prog = prog
        self.n = 0

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def serve(self, chunks):
        out, ms, full = self.prog.serve(chunks)
        self.n += 1
        return (out * np.float32(0.5) if self.n % 2 else out), ms, full


class AnswerAltered:
    """Every emitted chunk altered where it is produced: 6 dB quieter."""

    def __init__(self, prog):
        self.prog = prog

    def __getattr__(self, name):
        return getattr(self.prog, name)

    def serve(self, chunks):
        out, ms, full = self.prog.serve(chunks)
        return out * np.float32(0.5), ms, full


def _run(root, seed=3, steps=10, **kw):
    out = io.StringIO()
    harness.run(tiny.args(seed=seed, seconds=600.0), 0.0, device="cpu", root=root, max_steps=steps, out=out,
                err=io.StringIO(), **kw)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("pitch,door,fault", [
    ("rmvpe", "session", None), ("rmvpe", "session", StateUnchanged), ("rmvpe", "session", AnswerAltered),
    ("fcpe", "pool", None), ("fcpe", "pool", StateUnchanged), ("fcpe", "pool", HalfTheBatch),
    ("fcpe", "pool", AnswerAltered), ("rmvpe", "session", EveryOtherChunk), ("fcpe", "pool", OneSlot)],
    ids=lambda x: getattr(x, "__name__", str(x)))
def test_a_broken_step_is_not_correct(tmp_path, pitch, door, fault):
    root = tiny.tiny_root(tmp_path, pitch=pitch, door=door, limits=LIMITS[pitch])
    if fault is OneSlot:
        fault = type("OneSlot", (OneSlot,), {"slot": harness.pick_streams(random.Random(3), 4, 2)[0]})
    r = _run(root, program_hook=fault)
    assert r["correct"] == (fault is None), r["checks"]
    if fault in (EveryOtherChunk, HalfTheBatch) or (fault is not None and issubclass(fault, OneSlot)):
        assert r["checks"]["chunks_off"]["value"] > LIMITS[pitch]["chunks_off"], r["checks"]


@pytest.mark.parametrize("pitch,door", [("rmvpe", "session"), ("fcpe", "pool")])
def test_a_step_that_skips_the_sola_search_is_not_correct(tmp_path, monkeypatch, pitch, door):
    """The program's SOLA always takes offset 0: the reference's own choice differs."""
    from obs_rvc_tpu_torch.stream import pipeline

    monkeypatch.setattr(pipeline, "sola_offset",
                        lambda out, buf, b, s: torch.zeros(out.shape[:-1], dtype=torch.long, device=out.device))
    root = tiny.tiny_root(tmp_path, pitch=pitch, door=door, limits=LIMITS[pitch])
    r = _run(root)
    assert not r["correct"], r["checks"]
    assert r["checks"]["chunks_off"]["value"] > LIMITS[pitch]["chunks_off"], r["checks"]


def test_a_fault_in_a_share_of_the_slots_meets_as_many_checked_chunks():
    """At ``fcpe.pool64``'s size (64 slots, 8 checked, 32 chunks), on 500
    seeds: half of the slots wrong always puts 16 of the 32 checked chunks
    among them, and a wrong slot that is checked 4, each over the cell's
    share; every block of 8 slots has one checked stream."""
    traffic = json.loads((REPO / "benchmark/traffic/pool64.json").read_text())
    n, k, m, steps = traffic["door"]["capacity"], traffic["checked_streams"], traffic["checked"], 470
    for seed in range(500):
        rng = random.Random(seed)
        keep = harness.pick_streams(rng, n, k)
        assert sorted(s // (n // k) for s in keep) == list(range(k))
        checked = harness.pick_checked(rng, {s: [None] * steps for s in keep}, steps, m)
        per_stream = collections.Counter(s for s, *_ in checked)
        assert len(checked) == m and set(per_stream.values()) == {m // k}
        assert all((s, steps - 1) in {(c[0], c[1]) for c in checked} for s in keep)
        assert sum(s >= n // 2 for s in per_stream.elements()) == m // 2
    assert (m // k) / m > LIMITS["fcpe"]["chunks_off"] and 0.5 > LIMITS["fcpe"]["chunks_off"]


@pytest.mark.parametrize("pitch,door", [("rmvpe", "session"), ("fcpe", "pool")])
def test_the_control_is_not_correct(tmp_path, pitch, door):
    """The reference one precision below bfloat16 (float8) in the program's
    place fails the cell's limits, where the bfloat16 program's readings
    lie well under the control's."""
    root = tiny.tiny_root(tmp_path, pitch=pitch, door=door, dtype="bfloat16", limits=LIMITS[pitch])
    prog = _run(root, seed=1, steps=8)
    ctl = _run(root, seed=1, steps=8, make_program=control.ReferenceProgram)
    assert not ctl["correct"], ctl["checks"]
    for name in judge.COMPARED:
        assert ctl["checks"][name]["value"] >= prog["checks"][name]["value"], (name, prog["checks"], ctl["checks"])
    assert ctl["checks"]["audio_err"]["value"] > 2.5 * prog["checks"]["audio_err"]["value"], (prog["checks"],
                                                                                             ctl["checks"])
