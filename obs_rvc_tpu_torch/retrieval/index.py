"""Feature retrieval with RVC's blend (counterpart of
``obs_rvc_tpu/retrieval/index.py``).

Upstream Python RVC does, per chunk::

    score, ix = index.search(feats, k=8)          # squared-L2 distances
    weight = (1 / score)**2;  weight /= weight.sum(axis=1, keepdims=True)
    feats = index_rate * sum(big_npy[ix] * weight) + (1 - index_rate) * feats

Exact mode (:func:`knn_blend`): the distances of every query to every row
by one ``[Q, C] @ [C, N]`` product plus the norm terms, ``torch.topk`` over
``N``. IVF mode (:func:`ivf_search`, :func:`ivf_knn_blend`): the chunk-level
union probe of the JAX package. Lists are ranked by their centroid's
distance to the nearest query of the chunk, every query's own top-``nprobe``
lists are forced in, the top ``probes`` lists are gathered as fixed
``lcap``-row slabs of a list-major table, and every query searches the
whole union. Shapes are static throughout and nothing waits for the host,
so every path replays inside a CUDA graph.

**Scores are float32 whatever the table's dtype**, with JAX's promotion:

- :func:`knn_blend` takes float32 queries against the table. A float32
  table gives one float32 product. For a bfloat16 table on the card, each
  query is split into three bfloat16 pieces whose sum is exactly the
  float32 query. The stacked pieces go through one bfloat16 product with
  float32 output (``torch.mm(..., out_dtype=torch.float32)``), whose terms
  are exact, and the three partial scores are summed. The table is then
  read once, at bfloat16 width. On the CPU (no ``mm.dtype`` kernel there)
  the table is widened block by block.
- :func:`ivf_search` rounds the queries to the table's dtype first (JAX's
  ``q.astype(sub.dtype)``). The probed slabs are small, so both sides are
  widened to float32 for the product: a product of two bfloat16 values is
  exact in float32.

Matmuls run with whatever TF32 setting the caller chose; nothing here
turns it on.

**Ties.** ``lax.top_k`` puts the lower index first among equal values. The
probe ranking meets ties by design: a forced list's ``1e30`` bonus swamps
its score, so every list forced by the same number of queries scores the
same. The bonus is accumulated (``scatter_add_``, as ``.at[].add`` does)
and the lists are ranked by a stable descending sort. The neighbour
top-k uses ``torch.topk``: its exact ties are between masked rows, whose
weights underflow to 0.

**Streams.** The JAX batched step is ``jax.vmap(step)``, so each stream
blends alone. :func:`ivf_search` takes queries ``[Q, C]`` (one union over
all of them, the JAX function) or ``[S, Q, C]`` (one union per stream, each
as its own vmap lane would). :meth:`RetrievalIndex.blend` takes ``phone [B,
T, C]`` as ``B`` streams, each with its own union, ``probes = max(64, T)``
and ``index_rate``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from obs_rvc_tpu_torch.device import resolve_device
from obs_rvc_tpu_torch.retrieval.build import balance_lists

#: rows of a bfloat16 table widened at once on the CPU
_WIDEN_ROWS = 65536
#: the JAX package's bonus that forces a query's own lists into the probe set
_FORCE = 1e30


def _bf16_pieces(q: torch.Tensor) -> torch.Tensor:
    """``[3, ..., C]`` bfloat16 pieces whose float32 sum is exactly ``q``
    (float32): each piece takes the next 8 significant bits."""
    hi = q.to(torch.bfloat16)
    rest = q - hi.float()
    mid = rest.to(torch.bfloat16)
    return torch.stack([hi, mid, (rest - mid.float()).to(torch.bfloat16)])


def table_products(q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``q [Q, C] @ table[N, C].T`` as float32 ``[Q, N]`` for float32 queries
    and a float32 or bfloat16 table: JAX's ``jnp.dot(q, table.T,
    preferred_element_type=float32)`` with the table promoted to float32."""
    q = q.to(torch.float32)
    if table.dtype == torch.float32:
        return q @ table.T
    if q.is_cuda:
        pieces = _bf16_pieces(q)
        s = torch.mm(pieces.flatten(0, 1), table.T, out_dtype=torch.float32).unflatten(0, pieces.shape[:2])
        return (s[0] + s[1]) + s[2]
    out = q.new_empty(q.shape[0], table.shape[0])
    for start in range(0, table.shape[0], _WIDEN_ROWS):
        out[:, start : start + _WIDEN_ROWS] = q @ table[start : start + _WIDEN_ROWS].float().T
    return out


def _rate(index_rate, batch: int, device) -> torch.Tensor:
    """``index_rate`` (a number, a 0-d tensor or one value a stream) as a
    float32 ``[1 or B, 1, 1]`` tensor."""
    rate = torch.as_tensor(index_rate, dtype=torch.float32, device=device).reshape(-1, 1, 1)
    if rate.shape[0] not in (1, batch):
        raise ValueError(f"index_rate has {rate.shape[0]} values for {batch} streams")
    return rate


def knn_blend(vectors: torch.Tensor, norms: torch.Tensor, phone: torch.Tensor, index_rate,
              k: int = 8) -> torch.Tensor:
    """Exact retrieval and blend: ``vectors [N, C]`` (float32 or bfloat16),
    ``norms [N]`` their squared norms, ``phone [B, T, C]``; returns the
    blended ``[B, T, C]`` float32. Each row searches alone, so ``B`` may be
    streams or one stream's batch alike."""
    B, T, C = phone.shape
    q = phone.reshape(B * T, C)
    # 2 q·v − |v|², the negated distance up to |q|²: JAX's -(-2 q·v + |v|²) exactly
    neg = table_products(q, vectors).mul_(2.0).sub_(norms)
    neg_dist, idx = torch.topk(neg, k, dim=-1)
    return _blend(q, vectors[idx], neg_dist, phone, index_rate)


def _blend(q: torch.Tensor, neighbors: torch.Tensor, neg_scores: torch.Tensor, phone: torch.Tensor,
           index_rate) -> torch.Tensor:
    """RVC's blend tail: ``neg_scores = 2 q·v − |v|²`` (descending) of the
    chosen ``neighbors [Q, k, C]`` → their inverse-square-distance mix into
    ``phone [B, T, C]`` (``Q = B·T``)."""
    B, T, C = phone.shape
    d2 = (-neg_scores + torch.sum(q * q, dim=-1, keepdim=True)).clamp_min(1e-10)
    weight = (1.0 / d2) ** 2
    # masked rows (d2 ≈ 1e30: an IVF union with fewer than k valid rows)
    # underflow to a weight of exactly 0; a query with no valid neighbour at
    # all keeps its own row instead of 0/0
    wsum = torch.sum(weight, dim=-1, keepdim=True)
    weight = weight / wsum.clamp_min(1e-38)
    mixed = torch.sum(neighbors.float() * weight[..., None], dim=1)
    mixed = torch.where(wsum > 0.0, mixed, q.float())
    rate = _rate(index_rate, B, phone.device)
    return rate * mixed.reshape(B, T, C) + (1.0 - rate) * phone


def ivf_search(vectors, norms, lengths, offsets, centroids, cnorms, q: torch.Tensor, k: int = 8,
               probes: int = 64, lcap: int = 128, nprobe: int = 1):
    """Chunk-union IVF probe and exact search over the probed rows.

    ``vectors [N + lcap, C]`` list-major with padding rows, ``norms [N +
    lcap]`` (padding 1e30), ``lengths``/``offsets [nlist]`` int64,
    ``centroids [nlist, C]``, ``cnorms [nlist]``; ``q [Q, C]`` is one chunk,
    ``q [S, Q, C]`` ``S`` streams, each probed alone. Returns
    ``(neighbors [..., Q, k, C], neg_scores [..., Q, k], rows [..., Q, k])``
    with ``neg_scores = 2 q·v − |v|²`` descending and ``rows`` ids into the
    list-major table."""
    one = q.dim() == 2
    if one:
        q = q[None]
    S, Q, C = q.shape
    q = q.to(torch.float32)
    nlist = centroids.shape[0]
    probes = min(probes, nlist)

    # centroid distances up to each query's |q|²: [S, Q, nlist]
    cd = cnorms - 2.0 * (q @ centroids.to(torch.float32).T)
    # lists ranked by their nearest query, every query's own top-nprobe forced in
    list_score = -cd.amin(dim=1)
    query_lists = torch.topk(-cd, min(nprobe, nlist), dim=-1).indices.reshape(S, -1)
    list_score = list_score.scatter_add(1, query_lists, torch.full(query_lists.shape, _FORCE, device=q.device))
    probe_ids = torch.sort(list_score, dim=-1, descending=True, stable=True).indices[:, :probes]

    offs = offsets[probe_ids]  # [S, P]
    span = torch.arange(lcap, device=q.device)
    rows = offs[..., None] + span  # [S, P, lcap]; make_ivf_params pads lcap rows, so all in bounds
    # rows past a list's end belong to the next list (or the padding): masked out
    valid = span < lengths[probe_ids].clamp_max(lcap)[..., None]
    sub = vectors[rows].flatten(1, 2)  # [S, P·lcap, C]
    subn = torch.where(valid, norms[rows], _FORCE).flatten(1)
    scores = 2.0 * (q.to(sub.dtype).float() @ sub.float().transpose(1, 2)) - subn[:, None, :]
    neg_scores, idx = torch.topk(scores, k, dim=-1)  # [S, Q, k]
    flat = idx.flatten(1)
    neighbors = torch.gather(sub, 1, flat[..., None].expand(-1, -1, C)).unflatten(1, (Q, k))
    rows = torch.gather(rows.flatten(1), 1, flat).unflatten(1, (Q, k))
    if one:
        return neighbors[0], neg_scores[0], rows[0]
    return neighbors, neg_scores, rows


def ivf_knn_blend(vectors, norms, lengths, offsets, centroids, cnorms, phone: torch.Tensor, index_rate,
                  k: int = 8, probes: int = 64, lcap: int = 128, nprobe: int = 1) -> torch.Tensor:
    """:func:`ivf_search` and the blend, one union over all ``B·T`` queries
    of ``phone [B, T, C]`` (the JAX function; :meth:`RetrievalIndex.blend`
    probes each stream alone)."""
    B, T, C = phone.shape
    q = phone.reshape(B * T, C).to(torch.float32)
    neighbors, neg_scores, _ = ivf_search(vectors, norms, lengths, offsets, centroids, cnorms, q, k=k,
                                          probes=probes, lcap=lcap, nprobe=nprobe)
    return _blend(q, neighbors, neg_scores, phone, index_rate)


def _row_shards(vectors, norms, devices) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(vectors, norms)`` by rows over ``devices``, in ``tensor_split``'s
    sizes: a list of shards as it is when it already has one per device,
    else joined and split again. A shard on the device it lies on is a view."""
    if isinstance(vectors, torch.Tensor):
        vectors, norms = [vectors], [norms]
    if len(vectors) != len(devices):
        vectors = torch.cat([v.to(vectors[0].device) for v in vectors]).tensor_split(len(devices))
        norms = torch.cat([n.to(norms[0].device) for n in norms]).tensor_split(len(devices))
    return [(v.to(d), n.to(d)) for v, n, d in zip(vectors, norms, devices)]


def _sharded_blend(shards, phone: torch.Tensor, index_rate, k: int) -> torch.Tensor:
    """The exact search over table shards ``[(vectors, norms), ...]`` and the blend, on ``phone``'s device."""
    B, T, C = phone.shape
    q = phone.reshape(B * T, C).to(torch.float32)
    negs, cands = [], []
    for v, n in shards:
        qs = q.to(v.device)
        neg = table_products(qs, v).mul_(2.0).sub_(n)
        local, idx = torch.topk(neg, min(k, v.shape[0]), dim=-1)
        negs.append(local.to(q.device))
        cands.append(v[idx].to(q.device))
    # the candidates in shard order, as a tiled all_gather lays them out; a stable sort
    # keeps lax.top_k's lower-position-first among equal scores (duplicate rows across shards)
    all_neg, all_vecs = torch.cat(negs, dim=1), torch.cat(cands, dim=1)
    order = torch.sort(all_neg, dim=-1, descending=True, stable=True).indices[:, :k]
    chosen = torch.gather(all_vecs, 1, order[..., None].expand(-1, -1, C))
    return _blend(q, chosen, torch.gather(all_neg, 1, order), phone, index_rate)


def sharded_knn_blend(vectors, norms, phone: torch.Tensor, index_rate, mesh, k: int = 8) -> torch.Tensor:
    """Exact retrieval over a table split by rows along the mesh's ``model``
    axis (counterpart of the JAX ``sharded_knn_blend``): each shard's local
    top-``k`` of ``2 q·v − |v|²``, the ``k`` candidates' scores and vectors
    gathered to ``phone``'s device in shard order, a global top-``k`` among
    them, then RVC's blend. ``vectors``/``norms`` are the whole table (split
    here over the mesh's first row, a view per shard on the device it lies
    on) or one shard per model device."""
    return _sharded_blend(_row_shards(vectors, norms, mesh.rows()[0]), phone, index_rate, k)


_TABLE = ("vectors", "norms", "lengths", "offsets", "centroids", "cnorms")


class _Shard(nn.Module):
    """One model device's rows of the exact table, as buffers."""

    def __init__(self, vectors: torch.Tensor, norms: torch.Tensor):
        super().__init__()
        self.register_buffer("vectors", vectors)
        self.register_buffer("norms", norms)


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of an array of either package (a JAX bfloat16 array comes
    as numpy with ``ml_dtypes``' bfloat16, read through its bits)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class RetrievalIndex(nn.Module):
    """The retrieval table as buffers (``vectors``, ``norms`` and, in ivf
    mode, ``lengths``, ``offsets``, ``centroids``, ``cnorms``; ``None`` until
    :meth:`load`) and its static search geometry as plain attributes.

    ``mode='ivf'`` probes the coarse structure instead of searching the
    whole table. ``lcap`` (the slab length) is set by :meth:`make_ivf_params`
    or, for a table built elsewhere, read off its padding at :meth:`load`;
    ``probes=None`` sizes the union at ``max(64, T)`` a stream.

    Each :meth:`load` puts new tensors in the buffers and counts itself in
    :attr:`generation`, which the step's CUDA graphs watch (beside the
    networks' weights), so loading another index captures them again.
    ``RvcPipeline.modules()`` does not list the index: it is neither
    randomised nor cast for serving (its dtype is the table's own).

    **On a mesh.** With ``mesh`` (a ``('data', 'model')`` mesh of
    ``model > 1``), :meth:`load` splits the table by rows along ``model``
    over the mesh's first row (:attr:`shards`), and :meth:`blend` is
    :func:`sharded_knn_blend`'s exact search in either mode, as the JAX
    index's is (the list-major IVF table's padding rows never rank).
    ``parallel.shard_params`` gives each data row of a pipeline's mesh its
    own index (:meth:`on_row`): an exact table split by rows over the row's
    devices, an IVF table whole on the row's first device (a split by rows
    would cut the list slabs; GSPMD gives the JAX step the same results
    either way)."""

    def __init__(self, k: int = 8, mode: str = "exact", probes: Optional[int] = None, nprobe: int = 1,
                 lcap: Optional[int] = None, mesh=None):
        super().__init__()
        if mode not in ("exact", "ivf"):
            raise ValueError(f"unknown retrieval mode {mode!r}")
        if mesh is not None and "model" not in mesh.axis_names:
            raise ValueError(f"a retrieval mesh needs a 'model' axis, not {mesh.axis_names}")
        #: the mesh whose ``model`` axis the table is split along (None: whole on one device)
        self.mesh = mesh
        #: the exact table's rows, one :class:`_Shard` per model device (None: whole in ``vectors``)
        self.shards: Optional[nn.ModuleList] = None
        self.k = k
        self.mode = mode
        self.probes = probes
        self.nprobe = nprobe
        self.lcap = lcap
        #: loads so far
        self.generation = 0
        #: reordered-row → original-row permutation of the last :meth:`make_ivf_params`
        self.row_order: Optional[np.ndarray] = None
        for name in _TABLE:
            self.register_buffer(name, None)

    @staticmethod
    def make_params(vectors: np.ndarray, dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
        """The exact-mode table from ``[N, C]`` rows: ``vectors`` in ``dtype``
        (bfloat16 halves the bytes the search reads) and float32 ``norms``."""
        v32 = np.array(vectors, dtype=np.float32)
        return {"vectors": torch.from_numpy(v32).to(dtype), "norms": torch.from_numpy(np.sum(v32 * v32, axis=-1))}

    def make_ivf_params(self, ivf, dtype: torch.dtype = torch.float32, lcap: Optional[int] = None,
                        balance: bool = True) -> dict[str, torch.Tensor]:
        """The ivf-mode table from an :class:`~obs_rvc_tpu_torch.retrieval.faiss_reader.IvfFlatIndex`
        (or anything with ``vectors``/``centroids``/``assignments``), as the
        JAX package builds it: lists longer than a finite ``lcap`` split into
        balanced sublists (``balance``), rows reordered list-major, ``lcap``
        padding rows of norm 1e30 appended so every slab is in bounds.
        Records ``lcap`` (rounded up to 8 from the longest list when not
        given), ``nprobe`` and :attr:`row_order` on this index."""
        v32 = np.asarray(ivf.vectors, dtype=np.float32)
        cent = np.asarray(ivf.centroids, dtype=np.float32)
        assign = np.asarray(ivf.assignments, dtype=np.int64)
        if lcap is not None and balance:
            counts = np.bincount(assign, minlength=len(cent))
            if counts.max() > lcap:
                cent, assign = balance_lists(v32, cent, assign, int(lcap))
                assign = assign.astype(np.int64)
        nlist = len(cent)
        order = np.argsort(assign, kind="stable")
        self.row_order = order
        v = v32[order]
        lengths = np.bincount(assign, minlength=nlist).astype(np.int64)
        offsets = np.zeros(nlist, dtype=np.int64)
        offsets[1:] = np.cumsum(lengths[:-1])
        if lcap is None:
            lcap = max(8, -(-int(lengths.max()) // 8) * 8)
        self.lcap = int(lcap)
        self.nprobe = max(self.nprobe, int(getattr(ivf, "nprobe", 1)))
        norms = np.concatenate([np.sum(v * v, axis=-1), np.full(lcap, _FORCE, np.float32)])
        v = np.concatenate([v, np.zeros((lcap, v.shape[1]), np.float32)])
        return {
            "vectors": torch.from_numpy(v).to(dtype),
            "norms": torch.from_numpy(norms.astype(np.float32)),
            "lengths": torch.from_numpy(lengths),
            "offsets": torch.from_numpy(offsets),
            "centroids": torch.from_numpy(cent),
            "cnorms": torch.from_numpy(np.sum(cent * cent, axis=-1).astype(np.float32)),
        }

    def load(self, params: Mapping, device=None) -> "RetrievalIndex":
        """Put a table (from :meth:`make_params`/:meth:`make_ivf_params`, or
        the JAX package's ``params["index"]``) on ``device`` (``None`` means
        the card; with a mesh, its first device). An ivf table's slab
        length must fit its padding: the slab gather does not clamp."""
        device = resolve_device(device if device is not None or self.mesh is None else self.mesh.rows()[0][0])
        if self.mode == "ivf" and "offsets" not in params:
            raise ValueError("mode='ivf' but the table was built by make_params; build it with make_ivf_params")
        t = {name: _tensor(params[name]) for name in _TABLE if name in params}
        if "offsets" in t:
            t["lengths"], t["offsets"] = t["lengths"].long(), t["offsets"].long()
            pad = t["vectors"].shape[0] - int(t["lengths"].sum())
            if self.lcap is None:
                self.lcap = pad
            if len(t["offsets"]) and int(t["offsets"].max()) + self.lcap > t["vectors"].shape[0]:
                raise ValueError(f"lcap {self.lcap} reaches past the table's {pad} padding rows")
        self.shards = None
        if self.mesh is not None and self.mesh.shape["model"] > 1:
            # split from the host copy: no device holds the whole table
            self.shards = self._split(self.mesh.rows()[0], t.pop("vectors"), t.pop("norms"))
        for name in _TABLE:
            setattr(self, name, t[name].to(device) if name in t else None)
        self.generation += 1
        return self

    def _split(self, devices, vectors=None, norms=None) -> nn.ModuleList:
        """The exact table (``vectors``/``norms``, else this index's) by rows over ``devices``."""
        if vectors is None:
            if self.shards is not None:
                vectors, norms = [s.vectors for s in self.shards], [s.norms for s in self.shards]
            else:
                vectors, norms = self.vectors, self.norms
        return nn.ModuleList(_Shard(v, n) for v, n in _row_shards(vectors, norms, devices))

    def on_row(self, devices) -> "RetrievalIndex":
        """This index for one data row of a mesh over ``devices`` (its model
        shards), as the class docstring says: sharded over ``devices`` when
        exact with more than one, or when this index has a mesh of its own;
        else whole on ``devices[0]``. A tensor already on its device is not
        copied."""
        devices = [torch.device(d) for d in devices]
        row = RetrievalIndex(k=self.k, mode=self.mode, probes=self.probes, nprobe=self.nprobe, lcap=self.lcap,
                             mesh=self.mesh)
        row.row_order, row.generation = self.row_order, self.generation
        if self.shards is None and self.vectors is None:
            return row
        if self.shards is not None or (self.mode == "exact" and len(devices) > 1):
            row.shards = self._split(devices)
        else:
            for name in _TABLE:
                t = getattr(self, name)
                setattr(row, name, None if t is None else t.to(devices[0]))
        return row

    def blend(self, phone: torch.Tensor, index_rate) -> torch.Tensor:
        """Retrieve and blend each of ``B`` streams' features ``phone [B, T,
        C]`` with its ``index_rate`` (one value, or ``[B]``); ``phone``
        unchanged while no table is loaded."""
        if self.shards is not None:
            return _sharded_blend([(s.vectors, s.norms) for s in self.shards], phone, index_rate, self.k)
        if self.vectors is None:
            return phone
        if self.mode == "exact":
            return knn_blend(self.vectors, self.norms, phone, index_rate, self.k)
        T = phone.shape[1]
        probes = self.probes if self.probes is not None else max(64, T)
        q = phone.to(torch.float32)
        neighbors, neg_scores, _ = ivf_search(self.vectors, self.norms, self.lengths, self.offsets, self.centroids,
                                              self.cnorms, q, k=self.k, probes=probes, lcap=self.lcap,
                                              nprobe=self.nprobe)
        return _blend(q.flatten(0, 1), neighbors.flatten(0, 1), neg_scores.flatten(0, 1), phone, index_rate)

    def describe(self) -> str:
        """The static geometry, as the JAX ``RvcPipeline.fingerprint`` spells it."""
        mesh = None if self.mesh is None else self.mesh.shape
        return f"k={self.k},mode={self.mode},probes={self.probes},nprobe={self.nprobe},lcap={self.lcap},mesh={mesh}"
