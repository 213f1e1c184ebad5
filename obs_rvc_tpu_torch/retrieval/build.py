"""Building a retrieval index (counterpart of ``obs_rvc_tpu/retrieval/build.py``).

RVC builds its faiss index offline from the 100 Hz ContentVec features of
the target speaker's training clips. This module extracts those features
with the encoder the pipeline serves, trains the IVF quantizer (Lloyd
k-means, its distance blocks on the device), balances oversized lists for a
fixed slab length, and writes any of the supported artifacts (``.npy``,
faiss-compatible ``.index``, ``.onnx`` weights container).
"""

from __future__ import annotations

import pathlib
from typing import Iterable, Optional

import numpy as np
import torch

from obs_rvc_tpu_torch.device import resolve_device
from obs_rvc_tpu_torch.dsp import resample_poly
from obs_rvc_tpu_torch.models.contentvec import extract_feature
from obs_rvc_tpu_torch.retrieval.faiss_reader import (
    IvfFlatIndex,
    load_index_vectors,
    read_ivf_flat_full,
    write_ivf_flat,
)


@torch.no_grad()
def extract_features(pipeline, wavs: Iterable[np.ndarray], sample_rate: int = 16000,
                     max_seconds: float = 30.0) -> np.ndarray:
    """Mono clips → stacked 100 Hz feature rows ``[N, C]``, through the
    pipeline's ContentVec on its device. Clips longer than ``max_seconds``
    are split; non-16 kHz input is resampled."""
    rows = []
    limit = int(max_seconds * 16000)
    for wav in wavs:
        wav = np.asarray(wav, np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=0)
        w = torch.from_numpy(np.ascontiguousarray(wav)).to(pipeline.device)
        if sample_rate != 16000:
            w = resample_poly(w, sample_rate, 16000)
        for start in range(0, w.shape[0], limit):
            piece = w[start : start + limit]
            if piece.shape[0] < 800:  # shorter than the conv receptive field
                continue
            rows.append(extract_feature(pipeline.contentvec(piece[None]))[0].float().cpu().numpy())
    if not rows:
        raise ValueError("no usable audio provided")
    return np.concatenate(rows, axis=0)


def default_nlist(n: int) -> int:
    """RVC's IVF sizing rule: ``min(16·√N, N/39)``, floored at 4."""
    return max(4, min(int(16 * np.sqrt(n)), n // 39 if n >= 156 else 4))


@torch.no_grad()
def train_ivf(features: np.ndarray, nlist: Optional[int] = None, iters: int = 10, seed: int = 0,
              batch: int = 65536, device=None) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd k-means over feature rows → ``(centroids [nlist, C] float32,
    assignments [N] int32)``, the JAX ``train_ivf`` on ``device`` (``None``
    means the card): the same initial centroids from
    ``np.random.default_rng(seed)``, distance blocks of ``[batch, nlist]``
    float32 with the first minimum taken, centroid sums in float64, empty
    clusters re-seeded at the rows farthest from their centroid."""
    device = resolve_device(device)
    x = np.ascontiguousarray(features, dtype=np.float32)
    if not x.flags.writeable:  # a table read straight from a file's buffer
        x = x.copy()
    n, c = x.shape
    if nlist is None:
        nlist = default_nlist(n)
    nlist = min(nlist, n)
    rng = np.random.default_rng(seed)
    cent = x[rng.choice(n, nlist, replace=False)].copy()
    xd = torch.from_numpy(x).to(device)

    def assign(cent: np.ndarray):
        cd = torch.from_numpy(cent).to(device)
        cn = torch.sum(cd * cd, dim=1)
        dmin = torch.empty(n, device=device)
        amin = torch.empty(n, dtype=torch.long, device=device)
        for s in range(0, n, batch):
            d = cn[None, :] - 2.0 * (xd[s : s + batch] @ cd.T)
            dmin[s : s + batch], amin[s : s + batch] = torch.min(d, dim=1)
        return amin, dmin

    for _ in range(max(1, iters)):
        amin, dmin = assign(cent)
        sums = torch.zeros(nlist, c, dtype=torch.float64, device=device)
        for s in range(0, n, batch):
            sums.index_add_(0, amin[s : s + batch], xd[s : s + batch].double())
        counts = np.bincount(amin.cpu().numpy(), minlength=nlist)
        sums, dmin = sums.cpu().numpy(), dmin.cpu().numpy()
        nonzero = counts > 0
        cent[nonzero] = (sums[nonzero] / counts[nonzero, None]).astype(np.float32)
        for li in np.nonzero(~nonzero)[0]:  # re-seed empties at outliers
            far = int(np.argmax(dmin))
            cent[li] = x[far]
            dmin[far] = -1.0
    # the final assignment against the last update
    return cent, assign(cent)[0].cpu().numpy().astype(np.int32)


def _split_rows(v: np.ndarray, rows: np.ndarray, cap: int, rng: np.random.Generator, iters: int,
                depth: int = 0) -> list:
    """Recursively split one oversized inverted list (row-index array) into
    sublists of ≤ ``cap`` members via local k-means; degenerate clusters
    (identical points, no k-means progress) fall back to an arbitrary chop,
    which is still correct: probing cost counts sublists, and siblings of a
    tight cluster carry near-identical centroids."""
    if len(rows) <= cap:
        return [rows]
    if depth >= 8:
        return [rows[i : i + cap] for i in range(0, len(rows), cap)]
    m = -(-len(rows) // cap)
    pts = v[rows]
    pn = np.sum(pts * pts, axis=1)
    c = pts[rng.choice(len(rows), m, replace=False)].copy()
    for _ in range(max(1, iters)):
        d = pn[:, None] - 2.0 * pts @ c.T + np.sum(c * c, axis=1)[None, :]
        a = np.argmin(d, axis=1)
        for j in range(m):
            sel = a == j
            if sel.any():
                c[j] = pts[sel].mean(axis=0)
            else:
                c[j] = pts[rng.integers(len(rows))]
    d = pn[:, None] - 2.0 * pts @ c.T + np.sum(c * c, axis=1)[None, :]
    a = np.argmin(d, axis=1)
    sizes = np.bincount(a, minlength=m)
    if sizes.max() == len(rows):  # no progress: chop
        return [rows[i : i + cap] for i in range(0, len(rows), cap)]
    out: list = []
    for j in range(m):
        g = rows[a == j]
        if len(g):
            out.extend(_split_rows(v, g, cap, rng, iters, depth + 1))
    return out


def balance_lists(vectors: np.ndarray, centroids: np.ndarray, assignments: np.ndarray, cap: int,
                  iters: int = 4, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Split inverted lists longer than ``cap`` into sublists via local
    k-means (host numpy, a copy of the JAX package's), so a fixed slab
    length (``ivf_search``'s ``lcap``) loses no rows. Each sublist gets its
    own centroid; the chunk-union probe ranks sublists individually.

    Returns ``(centroids', assignments')`` with ``nlist' ≥ nlist`` and every
    list ≤ ``cap`` members. Original list ids are not preserved."""
    rng = np.random.default_rng(seed)
    v = np.asarray(vectors, np.float32)
    assign = np.asarray(assignments)
    nlist = len(centroids)
    counts = np.bincount(assign, minlength=nlist)
    order = np.argsort(assign, kind="stable")
    offs = np.zeros(nlist + 1, np.int64)
    offs[1:] = np.cumsum(counts)
    new_cent: list = []
    groups: list = []
    for li in range(nlist):
        rows = order[offs[li] : offs[li + 1]]
        if len(rows) <= cap:
            new_cent.append(np.asarray(centroids[li], np.float32))
            groups.append(rows)
        else:
            for g in _split_rows(v, rows, cap, rng, iters):
                new_cent.append(v[g].mean(axis=0))
                groups.append(g)
    out_assign = np.empty(len(assign), np.int32)
    for j, g in enumerate(groups):
        out_assign[g] = j
    return np.stack(new_cent).astype(np.float32), out_assign


def load_or_train_ivf(path: str | pathlib.Path, nlist: Optional[int] = None, kmeans_iters: int = 10,
                      seed: int = 0, device=None) -> IvfFlatIndex:
    """An artifact for ivf-mode search: a faiss ``.index`` carries its coarse
    structure; a flat ``.npy``/``.npz``/``.onnx`` table gets a quantizer
    trained at load on ``device`` (``None`` means the card)."""
    p = pathlib.Path(path)
    if p.suffix.lower() not in (".npy", ".npz", ".onnx"):
        return read_ivf_flat_full(p)
    table = load_index_vectors(p)
    cent, assign = train_ivf(table, nlist=nlist, iters=kmeans_iters, seed=seed, device=device)
    return IvfFlatIndex(vectors=table, centroids=cent, assignments=assign, nprobe=1)


def build_index(features: np.ndarray, save_path: Optional[str | pathlib.Path] = None,
                max_vectors: Optional[int] = None, seed: int = 0, nlist: Optional[int] = None,
                kmeans_iters: int = 10, device=None) -> np.ndarray:
    """Feature rows → retrieval table (optionally subsampled), saved in the
    format ``save_path``'s suffix names (.npy / .index / .onnx). An
    ``.index`` gets a quantizer trained on ``device`` (``None`` means the
    card), so it probes correctly in faiss and in ivf mode."""
    table = np.ascontiguousarray(features, dtype=np.float32)
    if max_vectors is not None and len(table) > max_vectors:
        idx = np.random.default_rng(seed).choice(len(table), max_vectors, replace=False)
        table = table[np.sort(idx)]
    if save_path is not None:
        save_path = pathlib.Path(save_path)
        if save_path.suffix == ".npy":
            np.save(save_path, table)
        elif save_path.suffix == ".index":
            cent, assign = train_ivf(table, nlist=nlist, iters=kmeans_iters, seed=seed, device=device)
            write_ivf_flat(save_path, table, centroids=cent, assignments=assign)
        elif save_path.suffix == ".onnx":
            from obs_rvc_tpu_torch.models.onnx_reader import write_onnx_weights

            write_onnx_weights(save_path, {"vectors": table})
        else:
            raise ValueError(f"unknown index format {save_path.suffix!r}")
    return table
