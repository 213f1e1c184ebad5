"""Retrieval through the port's step, its loaders and its CLI, and the weight
files the two packages share, on the CPU at the reduced widths of
``test_torch_port_pipeline.py`` and the small geometry (0.10 s chunks,
0.5 s of context) of the serving tests.

- The one-stream step with an exact and an ivf index at ``index_rate`` 0.75
  against the JAX step over 3 chunks: emitted audio atol 2e-3 and f0 rtol
  1e-4 (the tolerances of ``test_torch_port_pipeline.py``), and the blended
  features stage at rtol 1e-3, atol 2e-4 (the blend's tolerance over
  ContentVec's bound). The table is made from another voice's features
  (``extract_features``, held to the JAX package's too). At these widths
  and random weights the synthesizer barely hears its features, which is
  why the features are compared on their own.
- The batched step with an index, each stream at its own rate, against the
  port's one-stream steps (``test_torch_port_batch.py``'s rules).
- ``load_pipeline_params(index_path=)`` for ``.npy``, ``.index`` and
  ``.onnx`` in both modes: the table equal to the JAX loader's.
- ``.index``, ``.onnx`` and msgpack parameter files written by one package
  and read by the other, both ways, byte for byte.
- An ``.onnx`` synthesizer file through ``_torch_load``, and the CLI with
  ``--index table.npy --index-rate 0.75`` against the step in process.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.models import ContentVecConfig as JContentVecConfig
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
from obs_rvc_tpu.models import checkpoints as JC
from obs_rvc_tpu.models.onnx_reader import read_onnx_initializers as j_read_onnx
from obs_rvc_tpu.models.onnx_reader import write_onnx_weights as j_write_onnx
from obs_rvc_tpu.retrieval import RetrievalIndex as JIndex
from obs_rvc_tpu.retrieval.build import build_index as j_build_index
from obs_rvc_tpu.retrieval.build import extract_features as j_extract_features
from obs_rvc_tpu.retrieval.faiss_reader import read_ivf_flat_full as j_read_ivf
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamState as JState

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models import Synthesizer
from obs_rvc_tpu_torch.models import checkpoints as C
from obs_rvc_tpu_torch.models.contentvec import ContentVecConfig
from obs_rvc_tpu_torch.models.onnx_reader import read_onnx_initializers, write_onnx_weights
from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.models.weights import load_jax_params
from obs_rvc_tpu_torch.retrieval import RetrievalIndex, build_index, extract_features
from obs_rvc_tpu_torch.retrieval.faiss_reader import read_ivf_flat_full
from obs_rvc_tpu_torch.serve import cli
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState
from obs_rvc_tpu_torch.utils import read_wav, write_wav

from test_torch_port_batch import assert_rows_match, run_port_batch, run_port_single, stream_inputs, voiced
from test_torch_port_models import few_torch_threads, randomize  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import CV, RM, SY, voiced_signal

GEOMETRY = dict(sample_length=0.10, extra_inference_time=0.50)
SMALL = ["--sample-length", "0.10", "--extra-inference-time", "0.5"]
TABLE = ("vectors", "norms", "lengths", "offsets", "centroids", "cnorms")


def _port_pipe(cfg=None, **options):
    return RvcPipeline(cfg or ChunkConfig.build(**GEOMETRY), contentvec_cfg=ContentVecConfig(**CV),
                       rmvpe_cfg=RMVPEConfig(**RM), synth_cfg=SynthesizerConfig(**SY), device="cpu", **options)


def _jax_pipe(**options):
    return JPipeline(JChunkConfig.build(**GEOMETRY), contentvec_cfg=JContentVecConfig(**CV),
                     rmvpe_cfg=JRMVPEConfig(**RM), synth_cfg=JSynthesizerConfig(**SY), **options)


@pytest.fixture(scope="module")
def setup():
    """JAX parameters at reduced widths, and a feature table of 1024 rows:
    the ContentVec features of 2 s of another voice than the test signal's
    (through the JAX ``extract_features``), each with noisy copies."""
    jpipe = _jax_pipe()
    params = jpipe.init_params_fast(0)
    params = {k: randomize(v, seed=i) for i, (k, v) in enumerate(sorted(params.items()))}
    wav16 = voiced(32000, 16000, 260.0, seed=7)
    feats = j_extract_features(jpipe, params, [wav16])
    rng = np.random.default_rng(3)
    rows = feats[rng.integers(0, len(feats), 1024)]
    table = (rows + 0.3 * rng.standard_normal(rows.shape) * rows.std()).astype(np.float32)
    return dict(params=params, wav16=wav16, feats=feats, table=table)


def test_extract_features_matches_jax(setup):
    tpipe = _port_pipe()
    load_jax_params(tpipe, setup["params"])
    got = extract_features(tpipe, [setup["wav16"]])
    assert got.shape == setup["feats"].shape and got.shape[1] == CV["out_dim"]
    np.testing.assert_allclose(got, setup["feats"], rtol=2e-4, atol=2e-4)  # ContentVec's bound


def _index_pair(setup, mode):
    """The JAX and port pipelines with a retrieval index in ``mode`` over the
    table, the JAX params carrying it under ``"index"``."""
    jidx, tidx = JIndex(mode=mode, lcap=16 if mode == "ivf" else None), RetrievalIndex(mode=mode)
    params = dict(setup["params"])
    if mode == "ivf":
        from obs_rvc_tpu.retrieval.build import train_ivf as j_train_ivf
        from obs_rvc_tpu.retrieval.faiss_reader import IvfFlatIndex

        cent, assign = j_train_ivf(setup["table"], nlist=32, iters=4, seed=0)
        params["index"] = jidx.make_ivf_params(IvfFlatIndex(setup["table"], cent, assign), lcap=16)
    else:
        params["index"] = jidx.make_params(setup["table"])
    params["index"] = {k: jnp.asarray(v) for k, v in params["index"].items()}
    tpipe = _port_pipe(retrieval_index=tidx)
    load_jax_params(tpipe, params)
    return _jax_pipe(retrieval_index=jidx), params, tpipe


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_step_with_index_matches_jax(setup, mode):
    jpipe, params, tpipe = _index_pair(setup, mode)
    assert tpipe.retrieval_index.lcap == jpipe.retrieval_index.lcap and tpipe.retrieval_index.generation == 1
    assert "retrieval=" + tpipe.retrieval_index.describe() in tpipe.fingerprint()
    assert f"mode={mode}" in jpipe.fingerprint() and "retrieval=none" not in tpipe.fingerprint()
    cfg = tpipe.cfg
    wav = voiced_signal(3, cfg, seed=1)
    jstep, jfeatures = jax.jit(jpipe.step), jax.jit(jpipe._stage_features)
    jstate = jax.tree.map(jnp.asarray, JState.init(jpipe.cfg))
    tstate = StreamState.init(cfg, device="cpu")
    for i in range(3):
        chunk = wav[i * cfg.sample_frame_size : (i + 1) * cfg.sample_frame_size]
        jstate, jout = jstep(params, jstate, jnp.asarray(chunk), JControls.default(index_rate=0.75))
        tstate, tout = tpipe.step(tstate, torch.from_numpy(chunk), StepControls.default(index_rate=0.75))
        np.testing.assert_allclose(tstate.cache_pitchf.numpy(), np.asarray(jstate.cache_pitchf), rtol=1e-4)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-3, err_msg=f"{mode}, chunk {i}")
        assert np.abs(np.asarray(jout)).max() > 1e-3
        # the features stage itself, blended: the retrieval tolerance over ContentVec's 2e-4
        rate = np.float32(0.75)
        want = np.asarray(jfeatures(params, jstate.input_buffer_16k, rate))
        with torch.no_grad():
            got = tpipe.stage_features(tstate.input_buffer_16k[None], torch.tensor([rate]))
            unblended = tpipe.stage_features(tstate.input_buffer_16k[None], torch.tensor([0.0]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4, err_msg=f"{mode} features, chunk {i}")
        assert np.abs(unblended.numpy() - want).max() > 0.1 * np.abs(want).max()  # the blend moved them


@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_batched_step_with_index_matches_single_streams(setup, mode):
    """Three streams at index rates 0.75, 0.2 and 1.0 (ivf: each its own
    chunk union, as ``jax.vmap`` of the step gives them)."""
    _, _, tpipe = _index_pair(setup, mode)
    streams = [(150.0, 0.0, 1.0, 0), (180.0, 7.0, 0.3, 2), (230.0, -4.5, 0.6, 3)]
    chunks, controls = stream_inputs(tpipe.cfg, streams, 2)
    for c, rate in zip(controls, (0.75, 0.2, 1.0)):
        c["index_rate"] = rate
    batch = run_port_batch(tpipe, chunks, controls)
    assert_rows_match(batch, run_port_single(tpipe, chunks, controls), f"{mode}: batched vs one-stream steps")
    staged = run_port_batch(tpipe, chunks, controls, step=lambda s, c, k: tpipe.staged_step(s, c, k, batched=True))
    for got, want in zip(staged, batch):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _clustered_table(n=600, c=16, nclust=12, seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nclust, c)).astype(np.float32) * 4.0
    return (centers[rng.integers(0, nclust, n)] + 0.1 * rng.standard_normal((n, c))).astype(np.float32)


@pytest.mark.parametrize("fmt", ["npy", "index", "onnx"])
@pytest.mark.parametrize("mode", ["exact", "ivf"])
def test_load_pipeline_params_index_matches_jax(tmp_path, monkeypatch, fmt, mode):
    """Each artifact in each mode: the port's loaded table equals the JAX
    loader's ``params["index"]`` (ivf from a flat table: k-means trained at
    load in each package, on separated clusters)."""
    table = _clustered_table()
    path = tmp_path / f"voice.{fmt}"
    j_build_index(table, save_path=path, nlist=12, kmeans_iters=4)
    monkeypatch.setattr(JPipeline, "init_params", lambda self, rng: {})  # only the index is compared
    jidx = JIndex(mode=mode, lcap=64 if mode == "ivf" else None)
    jcfg = JChunkConfig.build(skip_inference=True, **GEOMETRY)
    want = JC.load_pipeline_params(JPipeline(jcfg, retrieval_index=jidx), index_path=str(path))["index"]
    tidx = RetrievalIndex(mode=mode, lcap=64 if mode == "ivf" else None)
    tpipe = RvcPipeline(ChunkConfig.build(skip_inference=True, **GEOMETRY), device="cpu", retrieval_index=tidx)
    C.load_pipeline_params(tpipe, index_path=path)
    assert set(want) == {k for k in TABLE if getattr(tidx, k) is not None}
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(tidx, k).numpy(), np.asarray(v), err_msg=f"{fmt} {mode}: {k}")
    assert tidx.lcap == jidx.lcap and tidx.nprobe == jidx.nprobe
    bf16 = RetrievalIndex(mode=mode, lcap=64 if mode == "ivf" else None)
    C.load_pipeline_params(RvcPipeline(ChunkConfig.build(skip_inference=True, **GEOMETRY), device="cpu",
                                       retrieval_index=bf16), index_path=path, index_dtype=torch.bfloat16)
    assert bf16.vectors.dtype == torch.bfloat16 and bf16.norms.dtype == torch.float32
    with pytest.raises(ValueError, match="retrieval_index"):
        C.load_pipeline_params(RvcPipeline(ChunkConfig.build(skip_inference=True, **GEOMETRY), device="cpu"),
                               index_path=path)


def test_index_and_onnx_files_cross_packages(tmp_path):
    """``build_index`` to ``.index`` and ``.onnx`` in each package: the same
    bytes, and each package reads the other's file."""
    table = _clustered_table()
    for fmt in ("index", "onnx"):
        j_build_index(table, save_path=tmp_path / f"j.{fmt}", nlist=12, kmeans_iters=4, seed=2)
        build_index(table, save_path=tmp_path / f"t.{fmt}", nlist=12, kmeans_iters=4, seed=2, device="cpu")
        assert (tmp_path / f"j.{fmt}").read_bytes() == (tmp_path / f"t.{fmt}").read_bytes(), fmt
    mine, theirs = read_ivf_flat_full(tmp_path / "j.index"), j_read_ivf(tmp_path / "t.index")
    for f in ("vectors", "centroids", "assignments"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    np.testing.assert_array_equal(mine.vectors, table)
    np.testing.assert_array_equal(read_onnx_initializers(tmp_path / "j.onnx")["vectors"], table)
    np.testing.assert_array_equal(j_read_onnx(tmp_path / "t.onnx")["vectors"], table)


def test_msgpack_params_cross_packages(setup, tmp_path):
    """The JAX package's ``save_params`` file of a whole parameter tree (a
    bfloat16 index included) and the port's: the same bytes, the same trees
    read back by either; the port's pipeline loads the file like the tree."""
    params = dict(setup["params"])
    params["index"] = JIndex.make_params(setup["table"], dtype=jnp.bfloat16)
    JC.save_params(tmp_path / "j.msgpack", params)
    tree = C.load_params(tmp_path / "j.msgpack")
    C.save_params(tmp_path / "t.msgpack", tree)
    assert (tmp_path / "t.msgpack").read_bytes() == (tmp_path / "j.msgpack").read_bytes()
    back = JC.load_params(tmp_path / "t.msgpack")
    assert tree["index"]["vectors"].dtype == torch.bfloat16
    flat_j, flat_t = jax.tree_util.tree_leaves_with_path(back), jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: np.asarray(t.float() if t.dtype == torch.bfloat16 else t), tree))
    assert [p for p, _ in flat_j] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_j, flat_t):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32), err_msg=str(path))
    from_file, from_tree = _port_pipe(retrieval_index=RetrievalIndex()), _port_pipe(retrieval_index=RetrievalIndex())
    load_jax_params(from_file, tree)
    load_jax_params(from_tree, params)
    for (k, a), (_, b) in zip(from_file.synthesizer.state_dict().items(), from_tree.synthesizer.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(from_file.retrieval_index.vectors, from_tree.retrieval_index.vectors)
    assert from_file.retrieval_index.vectors.dtype == torch.bfloat16


def test_msgpack_chunked_arrays_cross_packages(tmp_path, monkeypatch):
    """Arrays over flax's chunk size (1 GiB; a 1M x 768 float32 table is
    3 GiB) go as flax's chunked maps: the limit lowered to 256 bytes in both
    packages, the same bytes both ways and the same arrays back."""
    from flax import serialization

    from obs_rvc_tpu_torch.stream import state

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(state, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(6)
    tree = {"index": {"vectors": rng.standard_normal((40, 16)).astype(np.float32),
                      "offsets": np.arange(100, dtype=np.int64), "norms": np.ones(8, np.float32)}}
    tree["index"]["bf16"] = jnp.asarray(tree["index"]["vectors"][:30], jnp.bfloat16)
    JC.save_params(tmp_path / "j.msgpack", tree)
    C.save_params(tmp_path / "t.msgpack", tree)
    assert (tmp_path / "j.msgpack").read_bytes() == (tmp_path / "t.msgpack").read_bytes()
    back = C.load_params(tmp_path / "j.msgpack")["index"]
    np.testing.assert_array_equal(back["vectors"].numpy(), tree["index"]["vectors"])
    np.testing.assert_array_equal(back["offsets"].numpy(), tree["index"]["offsets"])
    np.testing.assert_array_equal(back["bf16"].float().numpy(), np.asarray(tree["index"]["bf16"], np.float32))
    assert back["norms"].shape == (8,)


def test_onnx_synthesizer_loads_through_torch_load(tmp_path):
    """A synthesizer's state dict as an ``.onnx`` container loads like the
    ``.pth`` of the same weights; either package's writer makes the bytes
    the other reads."""
    synth = Synthesizer(SynthesizerConfig(**SY))
    rng = np.random.default_rng(4)
    sd = {k: (rng.standard_normal(tuple(v.shape)) * 0.1).astype(np.float32) for k, v in synth.state_dict().items()}
    write_onnx_weights(tmp_path / "t.onnx", sd)
    j_write_onnx(tmp_path / "j.onnx", sd)
    assert (tmp_path / "t.onnx").read_bytes() == (tmp_path / "j.onnx").read_bytes()
    for name, arr in j_read_onnx(tmp_path / "t.onnx").items():
        np.testing.assert_array_equal(arr, sd[name])
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "t.pth")
    a, b = Synthesizer(SynthesizerConfig(**SY)), Synthesizer(SynthesizerConfig(**SY))
    assert C.load_synthesizer(a, tmp_path / "t.onnx") == {}
    C.load_synthesizer(b, tmp_path / "t.pth")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
        assert torch.equal(v, torch.from_numpy(sd[k])), k


def test_cli_with_index_matches_the_step_in_process(tmp_path, monkeypatch, setup):
    """``serve.cli --index table.npy --index-rate 0.75`` with the networks'
    default configs swapped for reduced ones, against a pipeline built and
    loaded the same way in process, converting the same clip."""
    from obs_rvc_tpu_torch.stream import pipeline as pipeline_mod

    monkeypatch.setattr(ContentVecConfig, "v2", staticmethod(lambda: ContentVecConfig(**CV)))
    monkeypatch.setattr(pipeline_mod, "RMVPEConfig", lambda: RMVPEConfig(**RM))
    monkeypatch.setattr(SynthesizerConfig, "for_sample_rate",
                        staticmethod(lambda sr, feature_dim=768: SynthesizerConfig(**SY)))
    np.save(tmp_path / "table.npy", setup["table"])
    sr = 48000
    cfg = ChunkConfig.build(**GEOMETRY)
    wav = voiced_signal(4, cfg, seed=5)
    write_wav(tmp_path / "in.wav", wav[None], sr)
    cli.main([str(tmp_path / "in.wav"), str(tmp_path / "out.wav"), "--index", str(tmp_path / "table.npy"),
              "--index-rate", "0.75", "--device", "cpu", *SMALL])
    got, got_sr = read_wav(tmp_path / "out.wav")

    pipe = _port_pipe(retrieval_index=RetrievalIndex())
    C.load_pipeline_params(pipe, index_path=tmp_path / "table.npy")
    controls = StepControls.default(rms_mix_rate=0.5, index_rate=0.75)  # the CLI's default --loudness-factor
    mono, _ = read_wav(tmp_path / "in.wav")  # the clip as the CLI reads it, PCM16-rounded
    want = pipe.convert_offline(torch.from_numpy(mono[0]), controls).numpy()
    assert got_sr == sr and got.shape == (1, want.size) and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got[0], want, atol=1.5 / 32768)  # PCM16 rounding
