"""The port's ``parallel/`` (``obs_rvc_tpu_torch/parallel/``) against the
JAX package's, on the CPU: the counterparts of ``tests/test_parallel.py``
and the mesh-sharded retrieval.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``; the
port's meshes name the CPU eight times, the same grid. Weights cross through
the port's ``models/weights.py``. Tolerances: the port against JAX, the
step's (emitted audio 2e-3 absolute, ``test_torch_port_batch.py``) and the
blend's (rtol 1e-3, atol 1e-4, ``test_torch_port_retrieval.py``); the
port's mesh against the port's one device, 2e-4 (the JAX mesh tests' own).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.config import ChunkConfig as JChunkConfig
from obs_rvc_tpu.models import ContentVec as JContentVec
from obs_rvc_tpu.models import ContentVecConfig as JContentVecConfig
from obs_rvc_tpu.models import RMVPEConfig as JRMVPEConfig
from obs_rvc_tpu.models import SynthesizerConfig as JSynthesizerConfig
from obs_rvc_tpu.parallel import make_mesh as j_make_mesh
from obs_rvc_tpu.parallel import param_partition_spec as j_spec
from obs_rvc_tpu.parallel import shard_controls as j_shard_controls
from obs_rvc_tpu.parallel import shard_params as j_shard_params
from obs_rvc_tpu.parallel import shard_state as j_shard_state
from obs_rvc_tpu.retrieval import index as J
from obs_rvc_tpu.stream import RvcPipeline as JPipeline
from obs_rvc_tpu.stream import StepControls as JControls
from obs_rvc_tpu.stream import StreamState as JState

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.models.contentvec import ContentVec, ContentVecConfig
from obs_rvc_tpu_torch.models.rmvpe import RMVPEConfig
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.models.weights import contentvec_state_dict, load_jax_params
from obs_rvc_tpu_torch.parallel import make_mesh, param_partition_spec, shard_controls, shard_params, shard_state
from obs_rvc_tpu_torch.parallel.dryrun import dryrun_multichip
from obs_rvc_tpu_torch.parallel.sharding import gather_rows, shard_contentvec, step_rows
from obs_rvc_tpu_torch.retrieval import index as T
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls, StreamState

from test_torch_port_batch import voiced
from test_torch_port_models import few_torch_threads, randomize  # noqa: F401 (autouse fixture)
from test_torch_port_pipeline import CV, RM, SY

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

CPU8 = ["cpu"] * 8
#: per stream of the batched step: (pitch shift, rms mix rate, speaker id)
STREAMS = [(0.0, 1.0, 0), (5.0, 0.5, 1), (-3.0, 0.8, 2), (2.0, 0.3, 3)]
BLEND_TOL = dict(rtol=1e-3, atol=1e-4)
#: compiled once per mesh and table shape (the tied and untied tables share one)
j_sharded_knn_blend = jax.jit(J.sharded_knn_blend, static_argnames=("mesh", "k"))


def small(cls):
    return cls.build(sample_rate=48000, sample_length=0.10, extra_inference_time=0.50)


def _shard_ids(shape, spec, n):
    """Each element's shard along the spec's "model" dimension out of ``n``
    (``tensor_split``'s pieces), -1 everywhere for a replicated array."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    if "model" not in spec:
        return np.full(shape, -1.0, np.float32)
    d = spec.index("model")
    ids = np.concatenate([np.full(len(c), i) for i, c in enumerate(np.array_split(np.arange(shape[d]), n))])
    view = [1] * len(shape)
    view[d] = shape[d]
    return np.broadcast_to(ids.reshape(view), shape).astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_partition_rules_split_the_jax_axes(n):
    """Every element of the JAX ContentVec's parameters, marked with its
    shard under the JAX rules, lands through the exporter on the port's
    element of the same shard under the port's rules: the same heads, the
    same FFN columns, the rest replicated. The table splits by rows in both."""
    cfg = JContentVecConfig(dim=64, num_layers=2, tap_layer=2, num_heads=4, ffn_dim=128, out_dim=64)
    variables = jax.eval_shape(JContentVec(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 4000), jnp.float32))
    marked = jax.tree_util.tree_map_with_path(
        lambda path, leaf: _shard_ids(leaf.shape, j_spec("contentvec/" + "/".join(str(p.key) for p in path),
                                                         leaf.ndim), n), variables)
    split = 0
    for name, ids in contentvec_state_dict(marked, num_layers=2).items():
        want = _shard_ids(ids.shape, param_partition_spec(f"contentvec.{name}", ids.ndim), n)
        np.testing.assert_array_equal(want, ids, err_msg=name)
        split += "model" in param_partition_spec(f"contentvec.{name}", ids.ndim)
    assert split == 2 * 10  # a layer: q, k, v weights and biases, out_proj, fc1 weight and bias, fc2
    assert param_partition_spec("synthesizer.dec.conv_pre.weight", 3) == (None,) * 3
    for name, ndim in (("vectors", 2), ("norms", 1)):
        jspec = tuple(j_spec(f"index/{name}", ndim))
        assert param_partition_spec(f"index.{name}", ndim) == jspec + (None,) * (ndim - len(jspec)) == \
            ("model",) + (None,) * (ndim - 1)


@pytest.fixture(scope="module")
def mesh_pipes():
    """The reduced-width pipeline in both packages at the JAX mesh tests'
    short geometry, the port's with the JAX weights (norms, biases and
    statistics perturbed, as ``test_torch_port_pipeline.py`` does)."""
    jpipe = JPipeline(small(JChunkConfig), contentvec_cfg=JContentVecConfig(**CV), rmvpe_cfg=JRMVPEConfig(**RM),
                      synth_cfg=JSynthesizerConfig(**SY))
    params = jpipe.init_params_fast(0)
    params = {k: randomize(v, seed=i) for i, (k, v) in enumerate(sorted(params.items()))}
    tpipe = RvcPipeline(small(ChunkConfig), contentvec_cfg=ContentVecConfig(**CV), rmvpe_cfg=RMVPEConfig(**RM),
                        synth_cfg=SynthesizerConfig(**SY), device="cpu")
    load_jax_params(tpipe, params)
    return jpipe, params, tpipe


def test_sharded_step_matches_jax_mesh_and_one_device(mesh_pipes):
    """Three chunks of the batched step of four streams with their own
    controls on a 4x2 mesh (streams along data, ContentVec along model):
    against the JAX ``jit_step_batch`` on its 4x2 mesh, and against the
    port's one-device batched step; the state carried between chunks."""
    jpipe, params, tpipe = mesh_pipes
    cfg = tpipe.cfg
    B, n = len(STREAMS), cfg.sample_frame_size
    wavs = np.stack([voiced(3 * n, cfg.sample_rate, f0, seed=k) for k, f0 in enumerate((150.0, 180.0, 210.0, 250.0))])
    chunks = np.ascontiguousarray(wavs.reshape(B, 3, n).transpose(1, 0, 2))
    kw = [dict(pitch_shift=p, rms_mix_rate=m, sid=s) for p, m, s in STREAMS]

    jmesh = j_make_mesh(n_data=4, n_model=2)
    jcontrols = j_shard_controls(jax.tree.map(lambda *xs: jnp.stack(xs), *[JControls.default(**k) for k in kw]),
                                 jmesh)
    jstate = j_shard_state(jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * B), JState.init(jpipe.cfg)), jmesh)
    jparams = j_shard_params(params, jmesh)

    mesh = make_mesh(n_data=4, n_model=2, devices=CPU8)
    rows = shard_params(tpipe, mesh)
    assert len(rows) == 4 and all(len(layer.self_attn.shards) == 2 for layer in rows[0].contentvec.encoder.layers)
    assert rows[0].contentvec is rows[3].contentvec  # rows on the same devices share their shards
    controls = StepControls.stack([StepControls.default(**k) for k in kw], "cpu")
    states = shard_state(StreamState.init_batch(cfg, B, device="cpu"), mesh)
    one_state = StreamState.init_batch(cfg, B, device="cpu")
    loudest = 0.0
    for i in range(3):
        jstate, jout = jpipe.jit_step_batch(jparams, jstate, j_shard_state(jnp.asarray(chunks[i]), jmesh), jcontrols)
        with torch.no_grad():
            states, outs = step_rows(rows, states, shard_state(torch.from_numpy(chunks[i]), mesh),
                                     shard_controls(controls, mesh))
            one_state, one_out = tpipe.step(one_state, torch.from_numpy(chunks[i]), controls, batched=True)
        out = gather_rows(outs).numpy()
        np.testing.assert_allclose(out, one_out.numpy(), atol=2e-4, err_msg=f"mesh vs one device, chunk {i}")
        np.testing.assert_allclose(out, np.asarray(jout), atol=2e-3, err_msg=f"port mesh vs JAX mesh, chunk {i}")
        loudest = max(loudest, float(np.abs(np.asarray(jout)).max()))
    assert loudest > 1e-3  # the comparison is not of silence
    state = gather_rows(states)
    np.testing.assert_allclose(state.input_buffer_16k.numpy(), np.asarray(jstate.input_buffer_16k), atol=1e-5)
    np.testing.assert_allclose(state.input_buffer[:, -n:].numpy(), chunks[2], atol=1e-6)
    np.testing.assert_allclose(state.cache_pitchf.numpy(), one_state.cache_pitchf.numpy(), rtol=1e-4, atol=1e-3)


def test_shard_params_holds_rows_until_the_weights_change(mesh_pipes):
    """The same rows for the same pipeline, mesh and weights; a reload
    shards afresh, and the new rows compute with the new weights."""
    _, _, tpipe = mesh_pipes
    mesh = make_mesh(n_data=2, n_model=2, devices=["cpu"] * 4)
    rows = shard_params(tpipe, mesh)
    assert shard_params(tpipe, make_mesh(n_data=2, n_model=2, devices=["cpu"] * 4)) is not None
    assert [r is s for r, s in zip(rows, shard_params(tpipe, mesh))] == [True, True]
    assert shard_params(tpipe, make_mesh(n_data=1, n_model=1, devices=["cpu"]))[0] is tpipe
    q = rows[0].contentvec.encoder.layers[0].self_attn.shards[0].q_proj_weight
    saved = {k: v.clone() for k, v in tpipe.contentvec.state_dict().items()}
    try:
        with torch.no_grad():
            tpipe.contentvec.encoder.layers[0].self_attn.q_proj.weight.mul_(2.0)
        again = shard_params(tpipe, mesh)
        assert again[0] is not rows[0]
        q2 = again[0].contentvec.encoder.layers[0].self_attn.shards[0].q_proj_weight
        torch.testing.assert_close(q2, 2.0 * q)
    finally:
        tpipe.contentvec.load_state_dict(saved)


@pytest.mark.parametrize("n_model,heads", [(2, 4), (8, 12), (5, 12)])
def test_contentvec_tensor_parallel_matches_unsharded(n_model, heads):
    """ContentVec with its heads and FFN split over ``n_model`` devices,
    ``tensor_split``'s pieces (12 heads over 8: 2, 2, 2, 2, 1, 1, 1, 1),
    against the unsharded network."""
    cfg = ContentVecConfig(dim=8 * heads, num_layers=2, tap_layer=2, num_heads=heads, ffn_dim=100, out_dim=8 * heads)
    torch.manual_seed(0)
    model = ContentVec(cfg).eval()
    wav = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4000)).astype(np.float32) * 0.1)
    tp = shard_contentvec(model, ["cpu"] * n_model)
    attn = tp.encoder.layers[0].self_attn
    assert [s.q_proj_weight.shape[0] // 8 for s in attn.shards] == [len(c) for c in np.array_split(range(heads),
                                                                                                   n_model) if len(c)]
    with torch.no_grad():
        torch.testing.assert_close(tp(wav), model(wav), atol=2e-5, rtol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("n_model", [2, 4])
def test_production_dim_contentvec_tp_parity(n_model):
    """The 768-d / 12-head / 3072-FFN ContentVec split over ``n_model``
    devices against the unsharded network (the JAX test's bounds)."""
    cfg = ContentVecConfig.v2()
    assert cfg.dim == 768 and cfg.num_heads == 12 and cfg.ffn_dim == 3072
    torch.manual_seed(0)
    model = ContentVec(cfg).eval()
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 16000)).astype(np.float32) * 0.1)
    tp = shard_contentvec(model, ["cpu"] * n_model)
    assert tp.encoder.layers[0].ffn.shards[0].fc1_weight.shape == (3072 // n_model, 768)
    with torch.no_grad():
        want, got = model(wav), tp(wav)
    assert got.shape == want.shape == (1, 49, 768)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-4)


def test_dryrun_multichip_on_eight_cpu_devices(capsys):
    """``dryrun_multichip(8)`` at production widths over the CPU named eight
    times: data=4 x model=2 (with a pool tick) and data=2 x model=4."""
    with torch.no_grad():
        dryrun_multichip(8, devices=CPU8)
    out = capsys.readouterr().out
    assert "mesh data=4 model=2" in out and "mesh data=2 model=4" in out and "pool tick ok" in out


def _tied_table(n, c, seed):
    """A table whose second half repeats its first: every row has a twin on
    the other shard of a 2-way split, so the gathered candidates tie."""
    rng = np.random.default_rng(seed)
    half = rng.standard_normal((n // 2, c)).astype(np.float32)
    return np.concatenate([half, half]), (half[rng.integers(0, n // 2, 12)]
                                          + 0.05 * rng.standard_normal((12, c))).astype(np.float32)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("tied", [False, True])
def test_sharded_knn_blend_matches_jax(n_model, tied):
    """The table split by rows over ``n_model`` devices: the port's
    ``sharded_knn_blend`` against JAX's on its mesh and against the port's
    unsharded ``knn_blend``; with ``tied``, each row has a duplicate in
    another shard, so the gathered candidates tie and the lower position wins."""
    rng = np.random.default_rng(3 + n_model)
    if tied:
        table, q = _tied_table(256, 16, 4)
    else:
        table = rng.standard_normal((256, 16)).astype(np.float32)  # JAX's row split must be even
        q = table[rng.integers(0, 256, 12)] + 0.1 * rng.standard_normal((12, 16)).astype(np.float32)
    phone = q.reshape(2, 6, 16)
    jp = J.RetrievalIndex.make_params(table)
    jmesh = j_make_mesh(n_model=n_model)
    sh = j_shard_params({"index": jp}, jmesh)["index"]
    want = np.asarray(j_sharded_knn_blend(sh["vectors"], sh["norms"], jnp.asarray(phone), 0.75, jmesh, k=8))

    tp = T.RetrievalIndex.make_params(table)
    mesh = make_mesh(n_model=n_model, devices=CPU8)
    got = T.sharded_knn_blend(tp["vectors"], tp["norms"], torch.from_numpy(phone), 0.75, mesh, k=8)
    np.testing.assert_allclose(got.numpy(), want, **BLEND_TOL)
    plain = T.knn_blend(tp["vectors"], tp["norms"], torch.from_numpy(phone), 0.75, k=8)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **BLEND_TOL)
    # an uneven split (tensor_split's pieces), which JAX's NamedSharding refuses
    odd = T.RetrievalIndex.make_params(table[:-1])
    np.testing.assert_allclose(
        T.sharded_knn_blend(odd["vectors"], odd["norms"], torch.from_numpy(phone), 0.75, mesh).numpy(),
        T.knn_blend(odd["vectors"], odd["norms"], torch.from_numpy(phone), 0.75).numpy(), **BLEND_TOL)

    # the index on that mesh: the table split at load, the same blend at [B] rates
    idx = T.RetrievalIndex(mesh=mesh).load(tp, device="cpu")
    assert len(idx.shards) == n_model and idx.vectors is None
    assert sum(s.vectors.shape[0] for s in idx.shards) == len(table)
    rates = torch.tensor([0.75, 0.75])
    torch.testing.assert_close(idx.blend(torch.from_numpy(phone), rates), got)
    assert idx.describe().endswith(f"mesh={{'data': {8 // n_model}, 'model': {n_model}}}")
    assert T.RetrievalIndex().describe().endswith("mesh=None")


def test_ivf_index_stays_whole_on_each_row(mesh_pipes):
    """``shard_params`` over a pipeline with an IVF index keeps the table
    whole on each row's first device and probes it as the one-device index
    does; an exact table splits by rows."""
    from obs_rvc_tpu.retrieval.faiss_reader import IvfFlatIndex

    table = np.random.default_rng(5).standard_normal((300, 16)).astype(np.float32)
    ivf = T.RetrievalIndex(mode="ivf")
    ivf.load(ivf.make_ivf_params(IvfFlatIndex(table, table[:6], np.arange(300) % 6), lcap=64), device="cpu")
    row = ivf.on_row(["cpu", "cpu"])
    assert row.shards is None and row.vectors is ivf.vectors
    phone = torch.from_numpy(table[:10].reshape(2, 5, 16) + 0.01)
    torch.testing.assert_close(row.blend(phone, 0.5), ivf.blend(phone, 0.5))
    exact = T.RetrievalIndex().load(T.RetrievalIndex.make_params(table), device="cpu")
    assert len(exact.on_row(["cpu", "cpu", "cpu"]).shards) == 3
    assert exact.on_row(["cpu"]).vectors is exact.vectors


@pytest.fixture(scope="module")
def mesh_steps(mesh_pipes):
    """Three chunks of four streams on a 4x2 mesh of the CPU: the inputs, the
    JAX ``jit_step_batch`` on its 4x2 mesh, and the port's eager rows
    (``step_rows``), each chunk's emitted audio joined ``[B, N]``."""
    jpipe, params, tpipe = mesh_pipes
    cfg = tpipe.cfg
    B, n = len(STREAMS), cfg.sample_frame_size
    wavs = np.stack([voiced(3 * n, cfg.sample_rate, f0, seed=k) for k, f0 in enumerate((160.0, 190.0, 220.0, 260.0))])
    chunks = np.ascontiguousarray(wavs.reshape(B, 3, n).transpose(1, 0, 2))
    kw = [dict(pitch_shift=p, rms_mix_rate=m, sid=s) for p, m, s in STREAMS]
    jmesh = j_make_mesh(n_data=4, n_model=2)
    jcontrols = j_shard_controls(jax.tree.map(lambda *xs: jnp.stack(xs), *[JControls.default(**k) for k in kw]),
                                 jmesh)
    jstate = j_shard_state(jax.tree.map(lambda x: jnp.stack([jnp.asarray(x)] * B), JState.init(jpipe.cfg)), jmesh)
    jparams = j_shard_params(params, jmesh)
    mesh = make_mesh(n_data=4, n_model=2, devices=CPU8)
    rows = shard_params(tpipe, mesh)
    controls = StepControls.stack([StepControls.default(**k) for k in kw], "cpu")
    states = shard_state(StreamState.init_batch(cfg, B, device="cpu"), mesh)
    jouts, eager = [], []
    for i in range(3):
        jstate, jout = jpipe.jit_step_batch(jparams, jstate, j_shard_state(jnp.asarray(chunks[i]), jmesh), jcontrols)
        jouts.append(np.asarray(jout))
        with torch.no_grad():
            states, outs = step_rows(rows, states, shard_state(torch.from_numpy(chunks[i]), mesh),
                                     shard_controls(controls, mesh))
        eager.append(gather_rows(outs))
    return dict(mesh=mesh, rows=rows, chunks=chunks, controls=controls, kw=kw, jax=jouts, eager=eager)


def _segmented_rows_step(form, tpipe, ms):
    """Each chunk's joined output of the steps' segmented ``form`` on the mesh."""
    from obs_rvc_tpu_torch.stream import StreamPool

    mesh, rows, chunks, controls = ms["mesh"], ms["rows"], ms["chunks"], ms["controls"]
    cfg, B = tpipe.cfg, chunks.shape[1]
    outs = []
    if form.endswith("pool"):
        pool = StreamPool(tpipe, capacity=B, mesh=mesh, mode=form.split("_")[0])
        slots = [pool.attach(StepControls.default(**k)) for k in ms["kw"]]
        for i in range(len(chunks)):
            for k, s in enumerate(slots):
                pool.push_audio(s, chunks[i, k])
            with torch.no_grad():
                assert pool.process_pending() == B
            outs.append(torch.from_numpy(np.stack([pool.pull_audio(s, cfg.sample_frame_size) for s in slots])))
        assert all(r.pipeline.segmented for r in pool._rows)
        return outs
    states = shard_state(StreamState.init_batch(cfg, B, device="cpu"), mesh)
    for i in range(len(chunks)):
        parts = shard_state(torch.from_numpy(chunks[i]), mesh)
        ctls = shard_controls(controls, mesh)
        with torch.no_grad():
            if form == "fused":
                states, got = step_rows(rows, states, parts, ctls, graphed=True)
            else:
                got = []
                for row, state, part, ctl in zip(rows, states, parts, ctls):
                    got.append(row.staged_step(state, part, ctl, batched=True)[1])
        outs.append(gather_rows(got))
    return outs


@pytest.mark.parametrize("form", ["fused", "staged", "fused_pool", "staged_pool"])
def test_segmented_forms_match_eager_rows_and_jax_mesh(mesh_pipes, mesh_steps, form):
    """Each graphed form of the step on a 4x2 mesh, its rows' features run as
    per-device segments (``stream/graphs.py:SegmentedFunction``; on the CPU
    each segment is called eagerly over its static copies and the copies
    between them run as on a card): bit for bit with the eager rows
    (``step_rows``), and within the step's 2e-3 of the JAX mesh's
    ``jit_step_batch``, over three chunks of four streams with their own
    controls, the state carried."""
    from obs_rvc_tpu_torch.stream.graphs import SegmentedFunction

    _, _, tpipe = mesh_pipes
    got = _segmented_rows_step(form, tpipe, mesh_steps)
    for i, (g, want, jout) in enumerate(zip(got, mesh_steps["eager"], mesh_steps["jax"])):
        assert torch.equal(g, want), f"{form} chunk {i}: off the eager rows by {(g - want).abs().max():.3e}"
        np.testing.assert_allclose(g.numpy(), jout, atol=2e-3, err_msg=f"{form} vs JAX mesh, chunk {i}")
    assert max(np.abs(j).max() for j in mesh_steps["jax"]) > 1e-3
    row = mesh_steps["rows"][0]
    if form == "fused":
        graph = row.batch_graph(1).graph
        assert isinstance(graph, SegmentedFunction) and "features/layer0/ffn_sum" in graph.segments
    if form == "staged":
        names = list(row.staged_batch_graphs(1).graphs)
        assert names[:2] == ["pre", "features/embed"] and "features" not in names and "after_features" not in names


@pytest.mark.parametrize("form", ["jit_infer", "jit_step", "jit_convert_scan"])
def test_segmented_one_stream_forms_match_eager(mesh_pipes, form):
    """The one-stream graphed forms on a data=1 x model=2 row (the engine's
    ``jit_infer``, the sessions' ``jit_step``, the CLI's whole-clip
    ``jit_convert_scan``), as segments: bit for bit with the row's eager step."""
    from obs_rvc_tpu_torch.stream.graphs import SegmentedFunction

    _, _, tpipe = mesh_pipes
    row = shard_params(tpipe, make_mesh(n_data=1, n_model=2, devices=CPU8))[0]
    cfg = row.cfg
    n = cfg.sample_frame_size
    wav = torch.from_numpy(voiced(3 * n, cfg.sample_rate, 200.0, seed=3))
    controls = StepControls.default(pitch_shift=2.0, rms_mix_rate=0.6, sid=1)
    with torch.no_grad():
        state = row.new_state()
        eager = []
        for i in range(3):
            state, out = row.step(state, wav[i * n : (i + 1) * n], controls)
            eager.append(out)
        if form == "jit_infer":
            cache = torch.from_numpy(np.random.default_rng(4).uniform(0, 300, cfg.pitch_cache_len).astype(np.float32))
            graph = row.jit_infer
            got, want = graph(cache, state.input_buffer_16k, controls), row._infer_single(cache, state.input_buffer_16k,
                                                                                          controls.on("cpu"))
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        elif form == "jit_step":
            graph = row.jit_step.graph
            state = row.new_state()
            for i in range(3):
                state, out = row.jit_step(state, wav[i * n : (i + 1) * n], controls)
                assert torch.equal(out, eager[i]), f"chunk {i}"
        else:
            got = row.jit_convert_scan(wav.reshape(3, n), controls)
            graph = row._graphs["jit_convert_scan"][3]
            assert torch.equal(got, torch.cat(eager))
    assert isinstance(graph, SegmentedFunction)
    assert {g.device for g in graph.segments.values()} == {torch.device("cpu")}
    assert sum(name.endswith("/attn_sum") for name in graph.segments) == tpipe.contentvec_cfg.tap_layer


def test_segmented_function_recaptures_every_segment_on_new_weights(mesh_pipes):
    """A weight change under a segmented graph (here a load into the row's
    split ContentVec) drops every segment: the next call makes them anew,
    and computes with the new weights."""
    _, _, tpipe = mesh_pipes
    row = shard_params(tpipe, make_mesh(n_data=1, n_model=2, devices=CPU8))[0]
    n = row.cfg.sample_frame_size
    chunk = torch.from_numpy(voiced(n, row.cfg.sample_rate, 180.0, seed=5))
    step = row.jit_step
    with torch.no_grad():
        step(row.new_state(), chunk, StepControls.default())
        before = dict(step.graph.segments)
        shard = row.contentvec.encoder.layers[0].ffn.shards[1]
        saved = shard.fc1_weight.clone()
        try:
            shard.fc1_weight.mul_(0.5)
            _, out = step(row.new_state(), chunk, StepControls.default())
            after = step.graph.segments
            assert list(after) == list(before) and all(after[k] is not before[k] for k in before)
            _, want = row.step(row.new_state(), chunk, StepControls.default())
            assert torch.equal(out, want)
        finally:
            shard.fc1_weight.copy_(saved)


def test_networks_copied_to_another_card_drop_their_kernel_packs(mesh_pipes):
    """A mesh row on another card deep-copies the pipeline's networks
    (``sharding._to``). The RMVPE chain levels and the NSF bank levels cache
    their packs for the kernels, which hold ctypes pointer arrays no copy
    can take: the copies start without them (and pack their own at their
    first launch), and the originals keep theirs."""
    import copy

    from obs_rvc_tpu_torch.models.rmvpe import _Chain
    from obs_rvc_tpu_torch.models.synthesizer import GeneratorNSF

    _, _, tpipe = mesh_pipes
    chains = [m for m in tpipe.rmvpe.modules() if isinstance(m, _Chain) and m.fused]
    gen = next(m for m in tpipe.synthesizer.modules() if isinstance(m, GeneratorNSF))
    for chain in chains:
        chain._packed(torch.float32)
    packed = []
    for i in range(len(gen._bank_cache)):
        try:
            gen.packed_bank(i, torch.float32)
            packed.append(i)
        except (NotImplementedError, ValueError):  # a level the kernel is not built for
            pass
    assert chains and packed
    rmvpe, synth = copy.deepcopy(tpipe.rmvpe), copy.deepcopy(tpipe.synthesizer)
    assert all(c._fold is None for c in rmvpe.modules() if isinstance(c, _Chain))
    assert all(level is None for m in synth.modules() if isinstance(m, GeneratorNSF) for level in m._bank_cache)
    assert all(torch.float32 in c._fold[2] for c in chains) and all(torch.float32 in gen._bank_cache[i][2]
                                                                      for i in packed)
