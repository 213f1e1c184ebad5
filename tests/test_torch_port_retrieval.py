"""The port's retrieval (``obs_rvc_tpu_torch/retrieval/``) against the JAX
package's, function by function, on the CPU at reduced sizes (N ≤ 4096
rows, C ≤ 64). Seeded numpy tables and queries go through both; the
tolerance is the JAX package's own for the blend (rtol 1e-3, atol 1e-4,
``tests/test_retrieval.py``); k-means assignments must be equal and the
centroids within 1e-5; the list-major layout and the balanced lists equal.

IVF ``rows`` are compared as sets over the valid rows: among equal scores
(the masked rows of a union with fewer than k valid ones) the order is not
specified. The probe ranking is compared exactly, ties included: the
duplicate-forced-lists case has more distinct forced lists than probes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from obs_rvc_tpu.retrieval import index as J
from obs_rvc_tpu.retrieval.build import balance_lists as j_balance_lists
from obs_rvc_tpu.retrieval.build import train_ivf as j_train_ivf
from obs_rvc_tpu.retrieval.faiss_reader import IvfFlatIndex

from obs_rvc_tpu_torch.parallel.mesh import Mesh
from obs_rvc_tpu_torch.retrieval import index as T
from obs_rvc_tpu_torch.retrieval.build import balance_lists, default_nlist, train_ivf

from test_torch_port_models import few_torch_threads  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-3, atol=1e-4)
TABLE = ("vectors", "norms", "lengths", "offsets", "centroids", "cnorms")
#: the JAX search and blends compiled once per geometry (op by op, each call compiles every op)
j_ivf_search = jax.jit(J.ivf_search, static_argnames=("k", "probes", "lcap", "nprobe"))
j_ivf_knn_blend = jax.jit(J.ivf_knn_blend, static_argnames=("k", "probes", "lcap", "nprobe"))
j_knn_blend = jax.jit(J.knn_blend, static_argnames=("k",))


def clustered(seed, n=2048, c=48, nclust=48, spread=0.6):
    """A clustered, heavy-tailed table and a correlated query chunk near
    its rows (a random walk from a table row), as ``scripts/ivf_recall.py``
    makes them."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((nclust, c)).astype(np.float32) * 2.0
    table = centers[rng.integers(0, nclust, n)] + spread * rng.standard_t(4, (n, c)).astype(np.float32)
    start = table[rng.integers(0, n)]
    walk = start + np.cumsum(0.2 * rng.standard_normal((24, c)), axis=0)
    return table.astype(np.float32), walk.astype(np.float32)


@pytest.fixture(scope="module")
def ivf():
    """A trained, balanced IVF table in both packages' layouts (JAX's numpy
    params, the port's tensors) and the index objects that built them."""
    table, walk = clustered(0)
    cent, assign = j_train_ivf(table, nlist=48, iters=6, seed=1)
    jidx, tidx = J.RetrievalIndex(mode="ivf"), T.RetrievalIndex(mode="ivf")
    jp = jidx.make_ivf_params(IvfFlatIndex(table, cent, assign), lcap=40)
    tp = tidx.make_ivf_params(IvfFlatIndex(table, cent, assign), lcap=40)
    return dict(table=table, walk=walk, cent=cent, assign=assign, jidx=jidx, tidx=tidx, jp=jp, tp=tp)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jax_table(p):
    return [jnp.asarray(p[k]) for k in TABLE]


def test_make_ivf_params_matches_jax(ivf):
    """Balanced at lcap 40 (lists over 40 rows split), reordered list-major,
    padded: the same arrays; the same lcap, row order and nprobe."""
    jp, tp = ivf["jp"], ivf["tp"]
    assert len(jp["lengths"]) > 48 and int(np.max(jp["lengths"])) <= 40  # balancing split some lists
    for k in TABLE:
        np.testing.assert_array_equal(_np(tp[k]), np.asarray(jp[k]), err_msg=k)
    assert ivf["tidx"].lcap == ivf["jidx"].lcap == 40
    np.testing.assert_array_equal(ivf["tidx"].row_order, ivf["jidx"].row_order)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.75, 0.0, 1.0])
def test_knn_blend_matches_jax(dtype, rate):
    table, walk = clustered(1, n=4096, c=64)
    phone = walk[:20].reshape(2, 10, 64)
    jp = J.RetrievalIndex.make_params(table, dtype=getattr(jnp, dtype))
    tp = T.RetrievalIndex.make_params(table, dtype=getattr(torch, dtype))
    want = np.asarray(j_knn_blend(jnp.asarray(jp["vectors"]), jnp.asarray(jp["norms"]), jnp.asarray(phone), rate))
    got = T.knn_blend(tp["vectors"], tp["norms"], torch.from_numpy(phone), rate)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if rate == 0.0:
        np.testing.assert_array_equal(got.numpy(), phone)


@pytest.mark.parametrize("case", [
    dict(probes=8, nprobe=1),
    dict(probes=64, nprobe=1),  # more than nlist: every list, so exact
    dict(probes=6, nprobe=3),
    dict(probes=8, nprobe=1, dtype="bfloat16"),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_ivf_search_matches_jax(ivf, case):
    case = dict(case)
    dtype = case.pop("dtype", "float32")
    jidx, tidx = J.RetrievalIndex(mode="ivf"), T.RetrievalIndex(mode="ivf")
    data = IvfFlatIndex(ivf["table"], ivf["cent"], ivf["assign"])
    jp = jidx.make_ivf_params(data, dtype=getattr(jnp, dtype), lcap=40)
    tp = tidx.make_ivf_params(data, dtype=getattr(torch, dtype), lcap=40)
    q = ivf["walk"]
    jn, js, jr = j_ivf_search(*_jax_table(jp), jnp.asarray(q), k=8, lcap=40, **case)
    tn, ts, tr = T.ivf_search(*[tp[k] for k in TABLE], torch.from_numpy(q), k=8, lcap=40, **case)
    assert ts.dtype == torch.float32 and tn.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(_np(tn), np.asarray(jn, np.float32), **TOL)
    valid = np.asarray(js) > -1e29
    assert valid.all()  # each query found k rows in its union
    for got, want in zip(tr.numpy(), np.asarray(jr)):
        assert set(got.tolist()) == set(want.tolist())


@pytest.mark.parametrize("rate", [0.75, 0.3])
def test_ivf_knn_blend_matches_jax(ivf, rate):
    phone = ivf["walk"].reshape(2, 12, -1)
    want = np.asarray(j_ivf_knn_blend(*_jax_table(ivf["jp"]), jnp.asarray(phone), rate, k=8, probes=10, lcap=40))
    got = T.ivf_knn_blend(*[ivf["tp"][k] for k in TABLE], torch.from_numpy(phone), rate, k=8, probes=10, lcap=40)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", ["exact", "ivf"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_retrieval_index_blend_matches_jax(ivf, mode, dtype):
    """``RetrievalIndex.blend`` of one stream ``[1, T, C]``: the JAX blend of
    the same chunk, at the default ``probes`` (``max(64, T)``)."""
    jidx, tidx = J.RetrievalIndex(mode=mode), T.RetrievalIndex(mode=mode)
    if mode == "ivf":
        data = IvfFlatIndex(ivf["table"], ivf["cent"], ivf["assign"])
        jp = jidx.make_ivf_params(data, dtype=getattr(jnp, dtype), lcap=40)
        tidx.load(tidx.make_ivf_params(data, dtype=getattr(torch, dtype), lcap=40), device="cpu")
    else:
        jp = jidx.make_params(ivf["table"], dtype=getattr(jnp, dtype))
        tidx.load(tidx.make_params(ivf["table"], dtype=getattr(torch, dtype)), device="cpu")
    phone = ivf["walk"][None]
    want = np.asarray(jax.jit(jidx.blend)({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(phone), 0.75))
    got = tidx.blend(torch.from_numpy(phone), torch.tensor([0.75]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tidx.vectors.dtype == getattr(torch, dtype) and tidx.norms.dtype == torch.float32


def test_batched_ivf_blend_matches_vmapped_jax_blend(ivf):
    """Three streams, each its own union and index_rate: ``jax.vmap`` of the
    JAX blend over one-stream chunks, as the JAX batched step runs it."""
    jp = {k: jnp.asarray(v) for k, v in ivf["jp"].items()}
    tidx = T.RetrievalIndex(mode="ivf", probes=6).load(ivf["tp"], device="cpu")
    jidx = J.RetrievalIndex(mode="ivf", probes=6, lcap=40)
    _, other = clustered(2)
    phone = np.stack([ivf["walk"][:8], ivf["walk"][8:16], other[:8]])
    rates = np.array([0.75, 0.2, 1.0], np.float32)
    want = jax.jit(jax.vmap(lambda ph, r: jidx.blend(jp, ph[None], r)[0]))(jnp.asarray(phone), jnp.asarray(rates))
    got = tidx.blend(torch.from_numpy(phone), torch.from_numpy(rates))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_duplicate_forced_lists_pick_jax_lists():
    """Many queries force the same lists (JAX's ``.at[].add(1e30)``
    accumulates), more distinct lists are forced than ``probes`` takes, and
    lists forced equally often tie: the port probes JAX's lists (counts
    first, then the lower list id)."""
    rng = np.random.default_rng(5)
    c, nlist, per = 16, 12, 10
    cent = rng.standard_normal((nlist, c)).astype(np.float32) * 4.0
    table = np.repeat(cent, per, axis=0) + 0.1 * rng.standard_normal((nlist * per, c)).astype(np.float32)
    assign = np.repeat(np.arange(nlist), per)
    # 3 queries at list 7, 2 at list 2, 2 at list 9, 1 each at lists 4, 0 and 11: six distinct forced lists
    near = [7, 7, 7, 2, 2, 9, 9, 4, 0, 11]
    q = (cent[near] + 0.05 * rng.standard_normal((len(near), c))).astype(np.float32)
    data = IvfFlatIndex(table, cent, assign)
    jp = J.RetrievalIndex(mode="ivf").make_ivf_params(data)
    tp = T.RetrievalIndex(mode="ivf").make_ivf_params(data)
    for probes in (2, 4):
        _, js, jr = j_ivf_search(*_jax_table(jp), jnp.asarray(q), k=4, probes=probes, lcap=16)
        _, ts, tr = T.ivf_search(*[tp[k] for k in TABLE], torch.from_numpy(q), k=4, probes=probes, lcap=16)
        want_lists = np.unique(np.asarray(jr)[np.asarray(js) > -1e29] // per)
        got_lists = np.unique(tr.numpy()[ts.numpy() > -1e29] // per)
        np.testing.assert_array_equal(got_lists, want_lists, err_msg=f"probes={probes}")
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # probes=4 takes 7 (3 queries), then the ties 2 and 9 (2 each), then 0 (lowest id among 4, 0, 11)
    assert want_lists.tolist() == [0, 2, 7, 9]


def test_empty_probed_union_falls_back_to_phone():
    """A query whose union holds no valid row keeps its own features, at any
    rate, in both packages (``tests/test_retrieval.py``'s case)."""
    rng = np.random.default_rng(27)
    c = 8
    vectors = (10.0 + rng.standard_normal((12, c))).astype(np.float32)
    assign = np.zeros(12, np.int64)
    query = -10.0 * np.ones((1, 1, c), np.float32)
    cent = np.stack([vectors.mean(0), query.reshape(c)]).astype(np.float32)
    jidx, tidx = J.RetrievalIndex(mode="ivf", probes=1, k=4), T.RetrievalIndex(mode="ivf", probes=1, k=4)
    jp = jidx.make_ivf_params(IvfFlatIndex(vectors, cent, assign))
    tidx.load(tidx.make_ivf_params(IvfFlatIndex(vectors, cent, assign)), device="cpu")
    want = np.asarray(jax.jit(jidx.blend)({k: jnp.asarray(v) for k, v in jp.items()}, jnp.asarray(query), 1.0))
    got = tidx.blend(torch.from_numpy(query), 1.0).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, query, atol=1e-6)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("nlist,iters,seed", [(48, 6, 1), (20, 3, 4)])
def test_train_ivf_matches_jax(nlist, iters, seed):
    """Separated clusters, so that no near-tie decides an assignment."""
    rng = np.random.default_rng(20 + seed)
    centers = rng.standard_normal((nlist, 24)).astype(np.float32) * 3.0
    vectors = np.repeat(centers, 12, axis=0) + 0.05 * rng.standard_normal((nlist * 12, 24)).astype(np.float32)
    jc, ja = j_train_ivf(vectors, nlist=nlist, iters=iters, seed=seed)
    tc, ta = train_ivf(vectors, nlist=nlist, iters=iters, seed=seed, device="cpu")
    assert ta.dtype == np.int32 and tc.dtype == np.float32
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tc, jc, atol=1e-5)
    assert default_nlist(100_000) == 2564 and default_nlist(1_000_000) == 16000 and default_nlist(100) == 4


@pytest.mark.parametrize("cap", [16, 40])
def test_balance_lists_matches_jax(ivf, cap):
    jc, ja = j_balance_lists(ivf["table"], ivf["cent"], ivf["assign"], cap)
    tc, ta = balance_lists(ivf["table"], ivf["cent"], ivf["assign"], cap)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tc, jc)
    assert np.bincount(ta).max() <= cap


def test_index_refusals():
    with pytest.raises(ValueError, match="'model' axis"):  # a retrieval mesh splits the table along model
        T.RetrievalIndex(mesh=Mesh(["cpu", "cpu"], ("rows",)))
    with pytest.raises(ValueError, match="mode"):
        T.RetrievalIndex(mode="hnsw")
    flat = T.RetrievalIndex.make_params(np.ones((32, 8), np.float32))
    with pytest.raises(ValueError, match="make_ivf_params"):
        T.RetrievalIndex(mode="ivf").load(flat, device="cpu")
    idx = T.RetrievalIndex(mode="ivf", lcap=64)
    data = IvfFlatIndex(np.ones((32, 8), np.float32), np.ones((2, 8), np.float32), np.arange(32) % 2)
    p = T.RetrievalIndex(mode="ivf").make_ivf_params(data, lcap=16)
    with pytest.raises(ValueError, match="padding"):
        idx.load(p, device="cpu")  # a 64-row slab would read past the 16 padding rows
    assert T.RetrievalIndex().blend(torch.ones(1, 2, 8), 0.5).equal(torch.ones(1, 2, 8))  # no table yet
