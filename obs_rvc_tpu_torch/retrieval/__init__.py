"""Feature retrieval, "the R in RVC" (counterpart of ``obs_rvc_tpu.retrieval``):

- :mod:`index`  exact kNN over the feature table as one matmul, and the
  chunk-union IVF probe, each with RVC's blend
  (``weight = 1/d²`` normalised, ``feats = rate·knn + (1-rate)·feats``);
  :class:`RetrievalIndex` holds the table as buffers of an ``nn.Module``
- :mod:`faiss_reader`  faiss ``IndexIVFFlat`` files (the ``.index`` RVC
  trains), ``.npy``/``.npz`` feature dumps and ``.onnx`` tables
- :mod:`build`  feature extraction, k-means IVF training, list balancing,
  export

``index.sharded_knn_blend`` is the exact search over a table split by rows
along a mesh's ``model`` axis (``RetrievalIndex(mesh=...)``).
"""

from obs_rvc_tpu_torch.retrieval.build import build_index, extract_features, train_ivf
from obs_rvc_tpu_torch.retrieval.faiss_reader import IvfFlatIndex, load_index_vectors, read_ivf_flat_full
from obs_rvc_tpu_torch.retrieval.index import RetrievalIndex, ivf_knn_blend, knn_blend

__all__ = [
    "RetrievalIndex", "knn_blend", "ivf_knn_blend", "load_index_vectors",
    "IvfFlatIndex", "read_ivf_flat_full", "build_index", "extract_features",
    "train_ivf",
]
