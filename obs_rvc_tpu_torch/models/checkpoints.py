"""Load upstream checkpoints straight into the port's modules (counterpart of
``obs_rvc_tpu/models/checkpoints.py``).

The port's modules carry the upstream key layout (fairseq HuBERT/ContentVec,
RMVPE ``E2E``, torchcrepe ``Crepe``, torchfcpe ``CFNaiveMelPE``, RVC
``SynthesizerTrnMs*NSFsid``), so a checkpoint's state dict needs no layout
transform: prefixes are stripped, weight-normed pairs
(``weight_g``/``weight_v``, or ``parametrizations.weight.original0/1``) are
folded into plain weights, keys the module does not have (training-only
heads such as ``enc_q`` or fairseq's ``label_embs_concat``) are dropped, and
the rest goes through ``load_state_dict(strict=True)``, so a missing key or
a wrong shape raises.

Checkpoints are unpickled with ``torch.load(weights_only=False)``, as the
upstream files need (fairseq stores its config objects): load only files you
trust. ``.onnx`` weight containers are parsed without the onnx package
(``models/onnx_reader.py``): torch-exported initializer names are the
state-dict names, so the same loaders apply. :func:`save_params` and
:func:`load_params` write and read the JAX package's msgpack parameter
files (flax's format, byte for byte); ``models/weights.load_jax_params``
puts such a tree into a pipeline.
"""

from __future__ import annotations

import pathlib
from typing import Any, Mapping, Optional

import numpy as np
import torch

from obs_rvc_tpu_torch.models.onnx_reader import read_onnx_initializers
from obs_rvc_tpu_torch.models.synthesizer import SynthesizerConfig
from obs_rvc_tpu_torch.models.weights import load_state_dict
from obs_rvc_tpu_torch.retrieval.build import load_or_train_ivf
from obs_rvc_tpu_torch.retrieval.faiss_reader import load_index_vectors
from obs_rvc_tpu_torch.stream.state import pack_tree, unpack_tree

_SR_STRINGS = {"32k": 32000, "40k": 40000, "48k": 48000}


def _torch_load(path) -> Any:
    """A weight container: torch ``.pth``/``.pt``, or ``.onnx`` (its initializers)."""
    if str(path).endswith(".onnx"):
        return read_onnx_initializers(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def fold_weight_norm(sd: Mapping[str, Any]) -> dict[str, Any]:
    """The state dict with every weight-normed pair folded into
    ``prefix.weight = g * v / ||v||``, the norm taken over the axes where
    ``g`` has size 1 (all but dim 0 for torch's default, all but the tap axis
    for fairseq's ``pos_conv``)."""
    out = {}
    pairs = {}
    for k, v in sd.items():
        for g_name, v_name in ((".weight_g", ".weight_v"),
                               (".parametrizations.weight.original0", ".parametrizations.weight.original1")):
            if k.endswith(g_name) or k.endswith(v_name):
                prefix = k[: -len(g_name)] if k.endswith(g_name) else k[: -len(v_name)]
                pairs.setdefault(prefix, {})["g" if k.endswith(g_name) else "v"] = v
                break
        else:
            out[k] = v
    for prefix, gv in pairs.items():
        if set(gv) != {"g", "v"}:
            raise KeyError(f"{prefix}: weight norm needs both its g and v tensors")
        g, v = _np(gv["g"]), _np(gv["v"])
        axes = tuple(d for d in range(v.ndim) if g.shape[d] == 1)
        norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        out[f"{prefix}.weight"] = g * v / np.maximum(norm, 1e-12)
    return out


def load_module(module: torch.nn.Module, sd: Mapping[str, Any]) -> torch.nn.Module:
    """Fold weight norm, keep the module's keys and load them strictly."""
    sd = fold_weight_norm(sd)
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the module's keys, e.g. {missing[:3]}")
    picked = {k: _np(sd[k]) for k in own if k in sd}
    for k, v in picked.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: checkpoint shape {tuple(v.shape)}, module shape {tuple(own[k].shape)}")
    return load_state_dict(module, picked)


def _state_dict(ckpt) -> Mapping[str, Any]:
    return ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt


def load_contentvec(module: torch.nn.Module, path) -> torch.nn.Module:
    """fairseq ContentVec/HuBERT ``.pt`` (``model`` payload, ``hubert.`` or
    ``model.`` prefixes) into a :class:`~obs_rvc_tpu_torch.models.ContentVec`."""
    sd = {k.removeprefix("hubert.").removeprefix("model."): v
          for k, v in _state_dict(_torch_load(path)).items()}
    return load_module(module, sd)


def load_rmvpe(module: torch.nn.Module, path) -> torch.nn.Module:
    """RMVPE ``E2E`` state dict into a :class:`~obs_rvc_tpu_torch.models.RMVPE`."""
    sd = {k.removeprefix("model."): v for k, v in _state_dict(_torch_load(path)).items()}
    return load_module(module, sd)


def load_crepe(module: torch.nn.Module, path) -> torch.nn.Module:
    """torchcrepe ``.pth`` (a plain state dict: ``conv{i}.weight [out, in, k,
    1]``, ``conv{i}_BN.*``, ``classifier.*``) into a
    :class:`~obs_rvc_tpu_torch.models.crepe.Crepe`."""
    return load_module(module, _state_dict(_torch_load(path)))


def load_fcpe(module: torch.nn.Module, path) -> torch.nn.Module:
    """torchfcpe ``.pt`` (the ``model`` payload, its config beside it) into a
    :class:`~obs_rvc_tpu_torch.models.fcpe.Fcpe`; the weight-normed
    ``output_proj`` (``weight_v [out, in]``, ``weight_g [out, 1]``) is folded
    over the input axis."""
    return load_module(module, _state_dict(_torch_load(path)))


def load_synthesizer_state(path) -> tuple[dict, dict]:
    """RVC ``.pth`` → (state dict, metadata). The release format
    ``{"weight", "config", "f0", "version", "sr"}`` gives its metadata; a bare
    state dict gives none."""
    ckpt = _torch_load(path)
    if isinstance(ckpt, dict) and "weight" in ckpt:
        return dict(ckpt["weight"]), {k: v for k, v in ckpt.items() if k != "weight"}
    return dict(_state_dict(ckpt)), {}


def load_synthesizer(module: torch.nn.Module, path) -> dict:
    """Load an RVC ``.pth`` into a :class:`~obs_rvc_tpu_torch.models.Synthesizer`;
    returns the file's metadata."""
    sd, meta = load_synthesizer_state(path)
    load_module(module, sd)
    return meta


def synthesizer_config_from_meta(meta: dict) -> SynthesizerConfig:
    """The synthesizer geometry an RVC release checkpoint was trained with:
    its ``config`` list (the positional arguments of
    ``SynthesizerTrnMs{256,768}NSFsid``) and its ``sr``/``version`` fields."""
    sr = meta.get("sr", 40000)
    if isinstance(sr, str):
        sr = _SR_STRINGS.get(sr, int(sr.rstrip("k")) * 1000 if sr.endswith("k") else int(sr))
    feature_dim = 256 if str(meta.get("version", "v2")) == "v1" else 768
    cfg = meta.get("config")
    if not cfg:
        return SynthesizerConfig.for_sample_rate(sr, feature_dim=feature_dim)
    (_spec_channels, _segment_size, inter_channels, hidden_channels, filter_channels, n_heads, n_layers,
     kernel_size, _p_dropout, _resblock, resblock_kernel_sizes, resblock_dilation_sizes, upsample_rates,
     upsample_initial_channel, upsample_kernel_sizes, spk_embed_dim, gin_channels, *rest) = cfg
    if rest:
        if isinstance(rest[0], str):
            sr = _SR_STRINGS.get(rest[0], sr)
        elif isinstance(rest[0], int):
            sr = rest[0]
    return SynthesizerConfig(
        feature_dim=feature_dim,
        inter_channels=inter_channels,
        hidden_channels=hidden_channels,
        filter_channels=filter_channels,
        n_heads=n_heads,
        n_layers=n_layers,
        kernel_size=kernel_size,
        resblock_kernel_sizes=tuple(resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(tuple(d) for d in resblock_dilation_sizes),
        upsample_rates=tuple(upsample_rates),
        upsample_kernel_sizes=tuple(upsample_kernel_sizes),
        upsample_initial_channel=upsample_initial_channel,
        spk_embed_dim=spk_embed_dim,
        gin_channels=gin_channels,
        sample_rate=sr,
    )


def load_pipeline_params(
    pipeline,
    contentvec_path: Optional[str | pathlib.Path] = None,
    rmvpe_path: Optional[str | pathlib.Path] = None,
    synthesizer_path: Optional[str | pathlib.Path] = None,
    seed: int = 0,
    crepe_path: Optional[str | pathlib.Path] = None,
    fcpe_path: Optional[str | pathlib.Path] = None,
    index_path: Optional[str | pathlib.Path] = None,
    index_dtype: torch.dtype = torch.float32,
) -> None:
    """Fill a pipeline's networks: random fan-in-scaled weights from ``seed``
    (``RvcPipeline.init_params(seed, std=None)``), then each checkpoint that
    is given; a network whose path is left out keeps its random weights. A
    path for a pitch network the pipeline does not run raises ``ValueError``
    (the JAX loader fails on it too: the pipeline has no parameters for it).

    ``index_path`` (``.index``, ``.npy``, ``.npz`` or ``.onnx``) loads the
    pipeline's retrieval index, its rows in ``index_dtype``: in ivf mode
    through ``load_or_train_ivf`` and ``make_ivf_params`` at the index's
    ``lcap`` (a flat table gets its quantizer trained on the pipeline's
    device), otherwise through ``load_index_vectors`` and ``make_params``.
    A pipeline without a retrieval index raises ``ValueError`` for it."""
    pipeline.init_params(seed, std=None)
    if contentvec_path:
        load_contentvec(pipeline.contentvec, contentvec_path)
    for path, name, load in ((rmvpe_path, "rmvpe", load_rmvpe), (crepe_path, "crepe", load_crepe),
                             (fcpe_path, "fcpe", load_fcpe)):
        if path:
            if pipeline.pitch_algorithm != name:
                raise ValueError(f"a {name} checkpoint was given, but the pipeline's pitch algorithm is "
                                 f"{pipeline.pitch_algorithm}")
            load(pipeline.modules()[name], path)
    if synthesizer_path:
        load_synthesizer(pipeline.synthesizer, synthesizer_path)
    if index_path:
        ridx = pipeline.retrieval_index
        if ridx is None:
            raise ValueError("an index path was given, but the pipeline has no retrieval_index")
        if ridx.mode == "ivf":
            table = ridx.make_ivf_params(load_or_train_ivf(index_path, device=pipeline.device), dtype=index_dtype,
                                         lcap=ridx.lcap)
        else:
            table = ridx.make_params(load_index_vectors(index_path), dtype=index_dtype)
        ridx.load(table, pipeline.device)


def cast_params_for_serving(pipeline, dtype: torch.dtype = torch.bfloat16):
    """Cast every floating parameter and buffer of the pipeline's networks
    to ``dtype`` (default bfloat16), in place; integer buffers (BatchNorm's
    ``num_batches_tracked``) keep theirs. Returns the pipeline.

    The port's copy of the JAX package's ``cast_params_for_serving``. There,
    flax casts each weight to the compute dtype at use and the pre-cast
    spares the per-op converts; here a network computes in the dtype of its
    weights, and ``RvcPipeline`` builds its networks in ``compute_dtype`` so
    that loading already rounds every weight to it. The cast therefore makes
    sure of it (a module swapped in after construction included) and raises
    ``ValueError`` when ``dtype`` is not the pipeline's compute dtype, since
    it would change what the networks compute in. The packs of the chain and
    bank kernels are keyed on each weight's storage and version, so they
    are rebuilt after a cast that moved a weight. The pitch network is cast
    whichever it is, BatchNorm statistics included, as the JAX cast maps over
    the whole tree. The retrieval index is left alone, as the JAX cast leaves
    its ``"index"`` subtree: ``modules()`` does not list it, and its dtype is
    the table's own (``index_dtype``).
    """
    if dtype != pipeline.compute_dtype:
        raise ValueError(f"cast_params_for_serving: the pipeline computes in {pipeline.compute_dtype}; "
                         f"casting its weights to {dtype} would change that (build it with compute_dtype={dtype})")
    for module in pipeline.modules().values():
        module.to(dtype)
    return pipeline


# ---------------------------------------------------------------------------
# the JAX package's msgpack parameter files
# ---------------------------------------------------------------------------


def save_params(path: str | pathlib.Path, params: Mapping) -> None:
    """Write a parameter tree (nested maps of numpy arrays or torch tensors,
    in the JAX package's layout) as flax msgpack, the bytes the JAX
    package's ``save_params`` writes for the same arrays."""
    pathlib.Path(path).write_bytes(pack_tree(params))


def load_params(path: str | pathlib.Path) -> dict:
    """Read a flax msgpack parameter file, of either package: nested dicts
    of CPU tensors (bfloat16 kept)."""
    return unpack_tree(pathlib.Path(path).read_bytes())
