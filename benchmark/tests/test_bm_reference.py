"""The plain reference against the program at the CPU tests' reduced
widths: network by network on the same weights, and through a whole run of
the harness, whose comparison must find the float32 program correct."""

import io
import json

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import nets
from benchmark.reference import step as refstep
from benchmark.tests import tiny

torch.set_num_threads(2)


def _port_modules(cfg):
    from obs_rvc_tpu_torch.models import (RMVPE, ContentVec, ContentVecConfig, Fcpe, FcpeConfig, RMVPEConfig,
                                          Synthesizer, SynthesizerConfig)

    cv = cfg["contentvec"]
    mods = {"contentvec": ContentVec(ContentVecConfig(**cv, tap_layer=cv["num_layers"], out_dim=cv["dim"])),
            "synthesizer": Synthesizer(SynthesizerConfig(**{k: harness._tuples(v)
                                                            for k, v in cfg["synthesizer"].items()}))}
    if cfg["pitch"] == "rmvpe":
        mods["rmvpe"] = RMVPE(RMVPEConfig(**cfg["rmvpe"]))
    else:
        mods["fcpe"] = Fcpe(FcpeConfig(**cfg["fcpe"]))
    return {k: m.eval() for k, m in mods.items()}


@pytest.mark.parametrize("pitch", ["rmvpe", "fcpe"])
def test_networks_match_the_port(pitch):
    cfg = tiny.tiny_config(pitch)
    sizes = harness.sizes(cfg)
    sds = weights.make_weights(sizes, 5, "cpu")
    port = _port_modules(cfg)
    ref = {n: refstep.make_module(weights.MAKERS[n][0], sizes[n], "cpu", state_dict=sd) for n, sd in sds.items()}
    for name, m in port.items():
        m.load_state_dict(sds[name], strict=True)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        wav = torch.randn(2, 10880, generator=gen) * 0.1
        a, b = port["contentvec"](wav), ref["contentvec"](wav)
        assert torch.allclose(a, b, rtol=0, atol=1e-4 * b.abs().max()), (a - b).abs().max()
        mel = torch.randn(2, 128, 32, generator=gen)
        x = mel if pitch == "rmvpe" else mel.transpose(1, 2)
        a, b = port[pitch](x), ref[pitch](x)
        assert (a - b).abs().max() < 1e-4
        T = 15
        phone = torch.randn(2, T, cfg["synthesizer"]["feature_dim"], generator=gen)
        f0 = torch.rand(2, T, generator=gen) * 300 + 80
        codes = torch.randint(1, 255, (2, T), generator=gen)
        sid = torch.zeros(2, dtype=torch.long)
        a, b = port["synthesizer"](phone, codes, f0, sid), ref["synthesizer"](phone, codes, f0, sid)
        assert (a - b).abs().max() < 1e-4 * max(1.0, float(b.abs().max()))


def test_weights_load_strictly_into_the_port():
    """The benchmark's keys are the program's: ``strict=True`` finds no key missing or extra."""
    for pitch in ("rmvpe", "fcpe"):
        cfg = tiny.tiny_config(pitch)
        sds = weights.make_weights(harness.sizes(cfg), 1, "cpu")
        for name, m in _port_modules(cfg).items():
            m.load_state_dict(sds[name], strict=True)


def test_weights_repeat_from_the_seed():
    cfg = tiny.tiny_config("rmvpe")
    a = weights.make_weights(harness.sizes(cfg), 2**31 + 7, "cpu")
    b = weights.make_weights(harness.sizes(cfg), 2**31 + 7, "cpu")
    c = weights.make_weights(harness.sizes(cfg), 2**31 + 8, "cpu")
    key = "encoder.layers.0.fc1.weight"
    assert torch.equal(a["contentvec"][key], b["contentvec"][key])
    assert not torch.equal(a["contentvec"][key], c["contentvec"][key])


@pytest.mark.parametrize("pitch,door", [("rmvpe", "session"), ("fcpe", "pool")])
def test_a_run_of_the_float32_program_is_correct(tmp_path, pitch, door):
    root = tiny.tiny_root(tmp_path, pitch=pitch, door=door)
    out = io.StringIO()
    harness.run(tiny.args(seconds=60.0), 0.0, device="cpu", root=root, max_steps=6, out=out, err=io.StringIO())
    r = json.loads(out.getvalue().strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["checks"]["audio_err"]["value"] < 1e-4
    assert max(r["readings"]["per_chunk"]["audio_err"]) < 1e-4
    assert not any(r["readings"]["per_chunk"]["sola_gap"]), "the float32 program's SOLA chose another offset"
    assert r["failed"] == 0 and r["attempted"] == 6 * (1 if door == "session" else 4)
    assert list(r)[-1] == "checks"


def test_the_stateful_reference_matches_its_stateless_form():
    """``ReferenceStreams`` from a zeroed state, judged as the program is:
    the rings and the pitch slice rebuilt from the input alone agree with
    the chunk-by-chunk state, SOLA's choices with its own."""
    from benchmark import judge
    from benchmark.traffic import generate

    cfg = tiny.tiny_config("rmvpe")
    geo = harness.geometry(cfg)
    sizes = harness.sizes(cfg)
    sds = weights.make_weights(sizes, 9, "cpu")
    ref = refstep.build(geo, "rmvpe", {n: harness._asdict(s) for n, s in sizes.items()}, sds,
                        refstep.Controls(), "cpu")
    signal = generate.voice({"period_s": 1.0}, 1, geo.sample_rate, geo.chunk, 9, "cpu")
    streams = refstep.ReferenceStreams(ref, 1, "cpu")
    outs = [streams.step(generate.chunk(signal, 0, k, geo.chunk)[None])[0].numpy() for k in range(12)]
    checked = [(0, k, outs[k], outs[k - 1] if k else None) for k in (0, 1, 5, 9, 11)]
    r = judge.compare(ref, signal, checked, chunk_limit=1e-4, sola_margin=0.0)
    assert max(r["per_chunk"]["audio_err"]) < 1e-4 and not any(r["per_chunk"]["sola_gap"]) and r["chunks_off"] == 0


def test_precision_rounds_to_float8():
    p = nets.Precision("fp8")
    x = torch.linspace(-1, 1, 1001)
    y = p.act(x)
    assert 0 < (x - y).abs().max() <= 2.0 ** -4
    assert torch.equal(nets.FLOAT32.act(x), x)
