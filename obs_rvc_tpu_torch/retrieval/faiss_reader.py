"""Readers and a writer for RVC retrieval-index artifacts (the port's copy of
``obs_rvc_tpu/retrieval/faiss_reader.py``, pure numpy).

RVC trains a faiss ``IVF{nlist},Flat`` index over 100 Hz ContentVec features
and ships it as ``*.index`` (plus, historically, a raw ``total_fea.npy``).
The faiss binary format is parsed directly (no faiss dependency):
``IwFl`` (IndexIVFFlat) → header → ``IxF2``/``IxFI``/``IxFl`` flat
quantizer → direct map → ``ilar`` ArrayInvertedLists with ``full`` lists.
Only what RVC writes is supported; anything else raises with the offending
fourcc. Two consumption modes downstream:

- exact: discard the coarse structure and search the flat ``[N, C]`` table
  by one matmul (``load_index_vectors``);
- ivf: keep centroids and list assignments (``read_ivf_flat_full``) and
  probe a chunk-level union of lists (``retrieval.index.ivf_knn_blend``),
  the counterpart of faiss's ``nprobe`` search that RVC runs in production
  (``index.nprobe = 1``).

Files written here and by the JAX package's writer are the same bytes.
"""

from __future__ import annotations

import dataclasses
import pathlib
import struct
from typing import BinaryIO

import numpy as np


@dataclasses.dataclass
class IvfFlatIndex:
    """Parsed IndexIVFFlat: flat table in insertion order + coarse structure."""

    vectors: np.ndarray       # [N, C] float32, original insertion order
    centroids: np.ndarray     # [nlist, C] float32 coarse quantizer
    assignments: np.ndarray   # [N] int32 — list id of each row
    nprobe: int = 1


def _u32(f: BinaryIO) -> int:
    return struct.unpack("<I", f.read(4))[0]


def _i32(f: BinaryIO) -> int:
    return struct.unpack("<i", f.read(4))[0]


def _u64(f: BinaryIO) -> int:
    return struct.unpack("<Q", f.read(8))[0]


def _fourcc(x: int) -> str:
    return struct.pack("<I", x).decode("latin1")


def _read_vector(f: BinaryIO, dtype: np.dtype) -> np.ndarray:
    n = _u64(f)
    return np.frombuffer(f.read(n * np.dtype(dtype).itemsize), dtype=dtype)


def _read_index_header(f: BinaryIO) -> tuple[int, int, int]:
    """Common Index header → (d, ntotal, metric_type)."""
    d = _i32(f)
    ntotal = _u64(f)
    f.read(16)  # two dummy idx_t
    f.read(1)  # is_trained bool
    metric = _i32(f)
    if metric > 1:
        f.read(4)  # metric_arg float
    return d, ntotal, metric


def _read_flat_index(f: BinaryIO) -> np.ndarray:
    h = _fourcc(_u32(f))
    if h not in ("IxF2", "IxFI", "IxFl"):
        raise ValueError(f"expected flat quantizer, got fourcc {h!r}")
    d, ntotal, _ = _read_index_header(f)
    # codes serialized as float count + raw bytes (faiss WRITEXBVECTOR)
    xb = _read_vector(f, np.float32)
    return xb.reshape(ntotal, d)


def read_ivf_flat_full(path: str | pathlib.Path) -> IvfFlatIndex:
    """Parse a faiss ``IndexIVFFlat`` file → :class:`IvfFlatIndex` with rows
    restored to original insertion order via the stored ids, plus the coarse
    quantizer centroids and per-row list assignments."""
    with open(path, "rb") as f:
        h = _fourcc(_u32(f))
        if h != "IwFl":
            raise ValueError(f"not an IndexIVFFlat file (fourcc {h!r})")
        d, ntotal, _metric = _read_index_header(f)
        nlist = _u64(f)
        nprobe = _u64(f)

        centroids = _read_flat_index(f)  # coarse quantizer

        # direct map: type byte + idx vector
        f.read(1)
        _read_vector(f, np.int64)

        il = _fourcc(_u32(f))
        if il != "ilar":
            raise ValueError(f"expected ArrayInvertedLists ('ilar'), got {il!r}")
        il_nlist = _u64(f)
        code_size = _u64(f)
        if il_nlist != nlist:
            raise ValueError(f"invlists nlist {il_nlist} != header nlist {nlist}")
        if code_size != d * 4:
            raise ValueError(f"code_size {code_size} != d*4 (not a Flat index?)")
        list_type = _fourcc(_u32(f))
        if list_type != "full":
            raise ValueError(f"unsupported inverted list layout {list_type!r}")
        sizes = _read_vector(f, np.uint64)
        if len(sizes) != nlist:
            raise ValueError("corrupt sizes vector")

        out = np.zeros((ntotal, d), dtype=np.float32)
        assignments = np.zeros(ntotal, dtype=np.int32)
        seen = 0
        for li, sz in enumerate(sizes):
            sz = int(sz)
            if sz == 0:
                continue
            ids = np.frombuffer(f.read(8 * sz), dtype=np.int64)
            codes = np.frombuffer(f.read(code_size * sz), dtype=np.float32).reshape(sz, d)
            out[ids] = codes
            assignments[ids] = li
            seen += sz
        if seen != ntotal:
            raise ValueError(f"list sizes sum {seen} != ntotal {ntotal}")
        return IvfFlatIndex(
            vectors=out,
            centroids=centroids,
            assignments=assignments,
            nprobe=max(1, int(nprobe)),
        )


def read_ivf_flat(path: str | pathlib.Path) -> np.ndarray:
    """Parse a faiss ``IndexIVFFlat`` file → dense ``[ntotal, d]`` float32
    table, rows restored to original insertion order via the stored ids."""
    return read_ivf_flat_full(path).vectors


def load_index_vectors(path: str | pathlib.Path) -> np.ndarray:
    """Load retrieval vectors from any RVC artifact: faiss ``.index``,
    ``.npy`` feature dump, ``.npz`` with a ``vectors`` array, or the
    ``.onnx`` weights container :func:`build.build_index` writes."""
    path = pathlib.Path(path)
    suffix = path.suffix.lower()
    if suffix == ".onnx":
        from obs_rvc_tpu_torch.models.onnx_reader import read_onnx_initializers

        return np.asarray(read_onnx_initializers(path)["vectors"], dtype=np.float32)
    if suffix == ".npy":
        return np.asarray(np.load(path), dtype=np.float32)
    if suffix == ".npz":
        return np.asarray(np.load(path)["vectors"], dtype=np.float32)
    return read_ivf_flat(path)


def write_ivf_flat(
    path: str | pathlib.Path,
    vectors: np.ndarray,
    nlist: int = 4,
    centroids: np.ndarray | None = None,
    assignments: np.ndarray | None = None,
    nprobe: int = 1,
) -> None:
    """Write a faiss-compatible IndexIVFFlat file (round-trip tested against
    :func:`read_ivf_flat_full`). With ``centroids``/``assignments`` (e.g.
    from :func:`obs_rvc_tpu_torch.retrieval.build.train_ivf`) the coarse structure
    is real and the artifact probes correctly in faiss and in our ivf search
    mode; without them vectors are assigned by a trivial hash to zero
    centroids — sufficient only for exact-search consumers."""
    v = np.ascontiguousarray(vectors, dtype=np.float32)
    n, d = v.shape
    if (centroids is None) != (assignments is None):
        raise ValueError("centroids and assignments must be given together")
    if centroids is not None:
        nlist = len(centroids)
        assign = np.asarray(assignments, dtype=np.int64)
        if assign.shape != (n,) or (n and (assign.min() < 0 or assign.max() >= nlist)):
            raise ValueError("bad assignments")
    else:
        assign = np.arange(n) % nlist

    def w_u32(f, x):
        f.write(struct.pack("<I", x))

    def w_u64(f, x):
        f.write(struct.pack("<Q", x))

    with open(path, "wb") as f:
        w_u32(f, struct.unpack("<I", b"IwFl")[0])
        # index header
        f.write(struct.pack("<i", d))
        w_u64(f, n)
        w_u64(f, 1 << 20)
        w_u64(f, 1 << 20)
        f.write(b"\x01")  # is_trained
        f.write(struct.pack("<i", 1))  # METRIC_L2
        w_u64(f, nlist)
        w_u64(f, nprobe)
        # quantizer: IxF2 with nlist centroids
        w_u32(f, struct.unpack("<I", b"IxF2")[0])
        f.write(struct.pack("<i", d))
        w_u64(f, nlist)
        w_u64(f, 1 << 20)
        w_u64(f, 1 << 20)
        f.write(b"\x01")
        f.write(struct.pack("<i", 1))
        cent = (
            np.zeros((nlist, d), dtype=np.float32)
            if centroids is None
            else np.ascontiguousarray(centroids, dtype=np.float32)
        )
        if cent.shape != (nlist, d):
            raise ValueError(f"centroids shape {cent.shape} != ({nlist}, {d})")
        w_u64(f, cent.size)
        f.write(cent.tobytes())
        # direct map: NoMap + empty vector
        f.write(b"\x00")
        w_u64(f, 0)
        # inverted lists
        w_u32(f, struct.unpack("<I", b"ilar")[0])
        w_u64(f, nlist)
        w_u64(f, d * 4)
        w_u32(f, struct.unpack("<I", b"full")[0])
        sizes = np.bincount(assign, minlength=nlist).astype(np.uint64)
        w_u64(f, nlist)
        f.write(sizes.tobytes())
        for li in range(nlist):
            ids = np.nonzero(assign == li)[0].astype(np.int64)
            f.write(ids.tobytes())
            f.write(v[ids].tobytes())
