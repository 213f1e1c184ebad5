"""The plain reference against the program at the CPU tests' reduced
widths: network by network on the same weights, and through a whole run of
the harness, whose comparison must find the float32 program correct."""

import hashlib
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
    ref = {n: refstep.make_module(refstep.network(n).Net, sizes[n], "cpu", state_dict=sd) for n, sd in sds.items()}
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


#: taken on the tree before the pitch networks moved into ``reference/pitch/``, at
#: ``tiny.py``'s sizes and the seed below: the sha256 of every weight (network,
#: key, dtype, shape and bytes, in the order drawn), and, for chunks 2 and 5 of
#: two streams stepped by the reference, 8 seeded projections of each emitted
#: chunk and its norm (the projections move by ~3e-6 of the norm with the CPU's
#: thread count, which sums convolutions in another order)
MOVED_SEED = 2**31 + 11
BEFORE_THE_MOVE = {
    "rmvpe": ("ed4064de6d214c4abaef4fbb3e13994dd9dccceb1524abcaaffd813af41c654c", [
        ([-14.73048, -5.48074, -19.38464, -11.05062, -13.83814, -31.00871, -18.01302, 18.90314], 12.399405),
        ([-8.04051, -23.17204, -8.66636, -4.23964, 1.3189, -20.93842, -5.52408, 31.64168], 10.94569),
        ([-13.60882, -8.7741, -11.66229, -7.60198, -9.88223, -39.39526, -13.30203, 28.72752], 13.322908),
        ([-4.07412, -14.11785, -6.62845, -4.6924, -9.92117, -31.18791, -9.98628, 31.64803], 11.606114)],
        {"contentvec": 33447876608, "rmvpe": 4590403584, "synthesizer": 32847285600, "total": 70908401824}),
    "fcpe": ("3791b891a6253e4ec83eed0f4b4d03573179da771fb25758e1e55c60f64b08b8", [
        ([-8.2313, -9.32014, -10.27692, -0.6088, -7.11378, -3.14644, -11.87558, -6.59441], 11.460416),
        ([-6.23143, -6.67515, -6.94029, -5.52263, 0.52974, -1.20461, -22.62724, -13.97454], 11.737545),
        ([-5.93435, -11.08826, 5.40582, -8.42946, -1.86024, -3.19058, -7.06843, -0.31942], 11.73917),
        ([-8.8496, -9.09885, -0.69776, -6.35738, -9.85649, -2.20538, -8.29271, 2.71285], 11.965013)],
        {"contentvec": 33447876608, "fcpe": 1381761024, "synthesizer": 32847285600, "total": 67699759264}),
}


@pytest.mark.parametrize("pitch", sorted(BEFORE_THE_MOVE))
def test_nothing_the_benchmark_reads_moved(pitch):
    """The weights (bit for bit, drawn in the same order), the reference's
    emitted audio and the configurations' FLOPs a chunk read as they did
    before the pitch networks became one file each."""
    from benchmark.traffic import generate

    digest, chunks, flops = BEFORE_THE_MOVE[pitch]
    cfg = tiny.tiny_config(pitch)
    sizes = harness.sizes(cfg)
    sds = weights.make_weights(sizes, MOVED_SEED, "cpu")
    h = hashlib.sha256()
    for name, sd in sds.items():
        h.update(name.encode())
        for key, v in sd.items():
            h.update(f"{key}|{v.dtype}|{tuple(v.shape)}".encode())
            h.update(v.contiguous().numpy().tobytes())
    assert list(sds) == ["contentvec", pitch, "synthesizer"] and h.hexdigest() == digest
    geo = harness.geometry(cfg)
    ref = refstep.build(geo, pitch, {n: harness._asdict(s) for n, s in sizes.items()},
                        {n: weights.round_to(sd, torch.bfloat16) for n, sd in sds.items()}, refstep.Controls(), "cpu")
    signal = generate.voice({"period_s": 1.0}, 2, geo.sample_rate, geo.chunk, MOVED_SEED, "cpu")
    streams = refstep.ReferenceStreams(ref, 2, "cpu")
    emitted = [streams.step(torch.stack([generate.chunk(signal, s, k, geo.chunk) for s in range(2)]))
               for k in range(6)]
    probes = torch.randn(8, geo.chunk, generator=torch.Generator().manual_seed(0))
    rows = [e[s] for e in (emitted[2], emitted[5]) for s in range(2)]
    for row, (proj, norm) in zip(rows, chunks):
        assert float(torch.linalg.vector_norm(row)) == pytest.approx(norm, rel=1e-5)
        assert torch.allclose(probes @ row, torch.tensor(proj), rtol=0, atol=1e-4 * norm), (probes @ row, proj)
    stored = [json.loads((tiny.REPO / c["file"]).read_text()) for c in harness.load_spec()["configs"]]
    assert [c["flops_per_chunk"] for c in stored if c["pitch"] == pitch] == [flops]
