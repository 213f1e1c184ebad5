"""The partition rules and the placement of weights, stream state and
controls on a mesh (counterpart of ``obs_rvc_tpu/parallel/sharding.py``).

The rules are the JAX package's, over the port's parameter names (the
exporter's, ``models/weights.py``, under the pipeline's module names):
megatron-style tensor parallelism of the ContentVec transformer, which holds
most of the parameters. Its attention is column-parallel by whole heads
(``q/k/v_proj`` split along their output rows) and row-parallel in
``out_proj`` (split along its input columns); its FFN is column-parallel in
``fc1`` and row-parallel in ``fc2``. The exact retrieval table splits by
rows. Everything else is replicated.

:func:`shard_params` applies them to an :class:`RvcPipeline`: it returns one
pipeline per data row of the mesh, each on its row's first device, whose
ContentVec layers hold one shard per model device of the row. A shard's
input is copied to its device, and the row-parallel partial outputs are
copied back to the row's first device and summed there in shard order;
``out_proj`` and ``fc2`` add their bias once, after the sum, as GSPMD's
``psum`` does. Each partial output comes out of its shard's product in the
compute dtype: in bfloat16 each is a float32 accumulation rounded once to
bfloat16, and the partials are then added in float32 with the bias and
rounded to bfloat16 once more. Heads split with ``tensor_split`` semantics
(12 heads over 8 devices: 2, 2, 2, 2, 1, 1, 1, 1), as GSPMD pads them; a
device given no head holds no shard.

Each layer's work is a sequence of segments, each on one device
(:class:`ParallelTransformerLayer`), as is the split table's search
(``retrieval.index._sharded_blend``): eagerly the segments run one after
the other, and a row pipeline's graphed forms replay a CUDA graph of each
on its own card (``stream/graphs.py:SegmentedFunction``), whether the row's
devices are distinct cards or one card named several times.

Rows whose devices are the same hold the same module objects (the sharded
ContentVec, the replicated networks), so a mesh that names one card several
times holds each weight once per distinct row. Each row pipeline has graphs
of its own. The rows are made once per pipeline, mesh and weights: a later
call with the same ones returns the same rows, and a change to the
pipeline's weights (a load, a cast, another retrieval table) makes the next
call shard them afresh, into new row pipelines whose graphs are captured
again.

:func:`shard_state` and :func:`shard_controls` split the stream axis into
``n_data`` contiguous groups, each on its row's first device;
:func:`step_rows` runs the batched step on each row and :func:`gather_rows`
joins the rows' results. Rows that another process feeds
(:mod:`distributed`) are ``None``.
"""

from __future__ import annotations

import copy
import math
import re
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from obs_rvc_tpu_torch.device import run_inline
from obs_rvc_tpu_torch.parallel.mesh import Mesh
from obs_rvc_tpu_torch.stream.graphs import WeightsVersion, leaves, tree_map

#: (name regex, spec by the parameter's ndim); the first match wins. A spec
#: names the axis ("model") or None for each dimension.
_PARAM_RULES: tuple[tuple[str, dict[int, tuple]], ...] = (
    # attention: q/k/v column-parallel by whole heads, out_proj row-parallel (summed after)
    (r"^contentvec\.encoder\.layers\.\d+\.self_attn\.[qkv]_proj\.weight$", {2: ("model", None)}),
    (r"^contentvec\.encoder\.layers\.\d+\.self_attn\.[qkv]_proj\.bias$", {1: ("model",)}),
    (r"^contentvec\.encoder\.layers\.\d+\.self_attn\.out_proj\.weight$", {2: (None, "model")}),
    # FFN: fc1 [ffn, dim] column-parallel, fc2 [dim, ffn] row-parallel
    (r"^contentvec\.encoder\.layers\.\d+\.fc1\.weight$", {2: ("model", None)}),
    (r"^contentvec\.encoder\.layers\.\d+\.fc1\.bias$", {1: ("model",)}),
    (r"^contentvec\.encoder\.layers\.\d+\.fc2\.weight$", {2: (None, "model")}),
    # the exact retrieval table by rows
    (r"^index\.vectors$", {2: ("model", None)}),
    (r"^index\.norms$", {1: ("model",)}),
)


def param_partition_spec(name: str, ndim: int) -> tuple:
    """The spec of the parameter ``name`` (``"<module>.<state-dict key>"``,
    the module as ``RvcPipeline.modules()`` names it, or ``index.vectors``/
    ``index.norms``): ``"model"`` or ``None`` per dimension; all ``None`` is
    replicated."""
    for pattern, by_ndim in _PARAM_RULES:
        if re.search(pattern, name):
            return by_ndim.get(ndim, (None,) * ndim)
    return (None,) * ndim


def _split_ranges(n: int, parts: int, unit: int = 1) -> list[tuple[int, int]]:
    """``(start, length)`` of ``parts`` contiguous pieces of ``n // unit``
    whole units (heads), in ``tensor_split``'s sizes, scaled by ``unit``."""
    return [(int(c[0]) * unit, len(c) * unit) if len(c) else (0, 0)
            for c in np.array_split(np.arange(n // unit), parts)]


def _take(t: torch.Tensor, spec: tuple, piece: tuple[int, int], device) -> torch.Tensor:
    """Shard ``piece`` of ``t`` along its ``"model"`` dimension (all of a
    replicated ``t``), as a contiguous copy on ``device``."""
    if "model" in spec:
        t = t.narrow(spec.index("model"), *piece)
    return nn.Parameter(t.detach().to(device, copy=True).contiguous(), requires_grad=False)


def _to(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` itself when its tensors are on ``device``, else a copy there."""
    tensors = list(module.parameters()) + list(module.buffers())
    if all(t.device == device for t in tensors):
        return module
    return copy.deepcopy(module).to(device)


def _shell(module: nn.Module) -> nn.Module:
    """A shallow copy of ``module`` with child, parameter and buffer maps of its own."""
    other = copy.copy(module)
    other._modules, other._parameters, other._buffers = (dict(module._modules), dict(module._parameters),
                                                          dict(module._buffers))
    return other


def _row_sum(parts: list[torch.Tensor], bias: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The row-parallel partial outputs summed on ``like``'s device in shard
    order, in float32, the bias added once; in ``like``'s dtype."""
    acc = parts[0].to(like.device, torch.float32, copy=True)
    for p in parts[1:]:
        acc += p.to(like.device, torch.float32)
    return (acc + bias.float()).to(like.dtype)


class _AttnShard(nn.Module):
    """One model device's heads: q/k/v, their attention and their slice of
    ``out_proj`` (no bias), computed on :attr:`device` from ``x`` there."""

    def __init__(self, attn: nn.Module, piece: tuple[int, int], device: torch.device, prefix: str, head_dim: int):
        super().__init__()
        self.device, self.head_dim = device, head_dim
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin = getattr(attn, name)
            w = _take(lin.weight, param_partition_spec(f"{prefix}.{name}.weight", 2), piece, device)
            self.register_parameter(f"{name}_weight", w)
            if name != "out_proj":
                self.register_parameter(f"{name}_bias", _take(
                    lin.bias, param_partition_spec(f"{prefix}.{name}.bias", 1), piece, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, E]
        B, T, _ = x.shape
        D = self.head_dim

        def split(t):
            return t.view(B, T, -1, D).transpose(1, 2)  # [B, H_s, T, D]

        q = split(F.linear(x, self.q_proj_weight, self.q_proj_bias)) / math.sqrt(D)
        k = split(F.linear(x, self.k_proj_weight, self.k_proj_bias))
        v = split(F.linear(x, self.v_proj_weight, self.v_proj_bias))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return F.linear((w @ v).transpose(1, 2).reshape(B, T, -1), self.out_proj_weight)


class _FFNShard(nn.Module):
    """One model device's slice of the FFN's hidden width: ``fc1``, gelu, and
    its slice of ``fc2`` (no bias)."""

    def __init__(self, fc1: nn.Linear, fc2: nn.Linear, gelu: str, piece: tuple[int, int], device: torch.device,
                 prefix: str):
        super().__init__()
        self.device, self.gelu = device, gelu
        self.fc1_weight = _take(fc1.weight, param_partition_spec(f"{prefix}.fc1.weight", 2), piece, device)
        self.fc1_bias = _take(fc1.bias, param_partition_spec(f"{prefix}.fc1.bias", 1), piece, device)
        self.fc2_weight = _take(fc2.weight, param_partition_spec(f"{prefix}.fc2.weight", 2), piece, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(F.gelu(F.linear(x, self.fc1_weight, self.fc1_bias), approximate=self.gelu), self.fc2_weight)


class ParallelSelfAttention(nn.Module):
    """``models.contentvec._SelfAttention`` with its heads split over
    ``devices``: a shard (:class:`_AttnShard`) per device given a head; the
    partials are summed by :func:`_row_sum` with :attr:`out_bias`."""

    def __init__(self, attn: nn.Module, devices: list[torch.device], prefix: str):
        super().__init__()
        E = attn.q_proj.weight.shape[0]
        self.head_dim = E // attn.heads
        self.shards = nn.ModuleList(_AttnShard(attn, piece, dev, prefix, self.head_dim)
                                    for piece, dev in zip(_split_ranges(E, len(devices), unit=self.head_dim), devices)
                                    if piece[1])
        self.out_bias = nn.Parameter(attn.out_proj.bias.detach().to(devices[0], copy=True), requires_grad=False)


class ParallelFFN(nn.Module):
    """``fc2(gelu(fc1(x)))`` with the hidden width split over ``devices``
    (:class:`_FFNShard`); the partials summed with :attr:`fc2_bias`."""

    def __init__(self, fc1: nn.Linear, fc2: nn.Linear, gelu: str, devices: list[torch.device], prefix: str):
        super().__init__()
        self.shards = nn.ModuleList(_FFNShard(fc1, fc2, gelu, piece, dev, prefix)
                                    for piece, dev in zip(_split_ranges(fc1.weight.shape[0], len(devices)), devices)
                                    if piece[1])
        self.fc2_bias = nn.Parameter(fc2.bias.detach().to(devices[0], copy=True), requires_grad=False)


class ParallelTransformerLayer(nn.Module):
    """``models.contentvec._TransformerLayer`` over the shards above, its
    sums and norms on the row's first device.

    A layer is four kinds of segment, each given to ``run`` (see
    :func:`~obs_rvc_tpu_torch.device.run_inline`; a graphed step replays a
    graph of each): a shard's attention on its device, then on the first
    device the sum of the partials, the residual and the first LayerNorm;
    a shard's FFN on its device, then the sum, the residual and the final
    LayerNorm. Each segment's input is copied to its device. The arithmetic
    and the order of the sums are the same however ``run`` runs them."""

    def __init__(self, layer: nn.Module, devices: list[torch.device], prefix: str):
        super().__init__()
        self.device = devices[0]
        self.self_attn = ParallelSelfAttention(layer.self_attn, devices, f"{prefix}.self_attn")
        self.self_attn_layer_norm = _to(layer.self_attn_layer_norm, devices[0])
        self.ffn = ParallelFFN(layer.fc1, layer.fc2, layer.gelu, devices, prefix)
        self.final_layer_norm = _to(layer.final_layer_norm, devices[0])

    def attn_sum(self, x: torch.Tensor, *parts: torch.Tensor) -> torch.Tensor:
        return self.self_attn_layer_norm(x + _row_sum(list(parts), self.self_attn.out_bias, x))

    def ffn_sum(self, x: torch.Tensor, *parts: torch.Tensor) -> torch.Tensor:
        return self.final_layer_norm(x + _row_sum(list(parts), self.ffn.fc2_bias, x))

    def forward(self, x: torch.Tensor, run=run_inline, name: str = "layer") -> torch.Tensor:
        parts = [run(f"{name}/attn{i}", s, x, device=s.device) for i, s in enumerate(self.self_attn.shards)]
        x = run(f"{name}/attn_sum", self.attn_sum, x, *parts, device=self.device)
        parts = [run(f"{name}/ffn{i}", s, x, device=s.device) for i, s in enumerate(self.ffn.shards)]
        return run(f"{name}/ffn_sum", self.ffn_sum, x, *parts, device=self.device)


def shard_contentvec(contentvec: nn.Module, devices, name: str = "contentvec") -> nn.Module:
    """``contentvec`` with each transformer layer tensor-parallel over
    ``devices`` (:class:`ParallelTransformerLayer`) and its other modules on
    ``devices[0]``; the original is left as it was."""
    devices = [torch.device(d) for d in devices]
    tp = _shell(contentvec)
    for child, module in contentvec.named_children():
        if child != "encoder" and module is not None:
            setattr(tp, child, _to(module, devices[0]))
    enc = _shell(contentvec.encoder)
    for child, module in contentvec.encoder.named_children():
        if child != "layers":
            setattr(enc, child, _to(module, devices[0]))
    enc.layers = nn.ModuleList(ParallelTransformerLayer(layer, devices, f"{name}.encoder.layers.{i}")
                               for i, layer in enumerate(contentvec.encoder.layers))
    tp.encoder = enc
    #: the model devices its layers are split over
    tp.model_devices = devices
    return tp


def _row_pipeline(pipe, row: list[torch.device], first: bool, shared: dict):
    """The pipeline of one data row: ``pipe`` itself for a one-device row on
    ``pipe``'s device (the first such row), else a copy on ``row[0]`` with
    graphs of its own, whose networks are ``pipe``'s (moved when ``row[0]``
    is another device) and whose ContentVec is tensor-parallel over ``row``.
    ``shared`` holds what rows of the same devices share."""
    dev = row[0]
    if first and len(row) == 1 and dev == pipe.device:
        return pipe
    key = tuple(str(d) for d in row)
    if key not in shared:
        mods = {name: _to(m, dev) for name, m in pipe.modules().items()}
        if len(row) > 1 and "contentvec" in mods:
            mods["contentvec"] = shard_contentvec(pipe.contentvec, row)
        index = pipe.retrieval_index
        shared[key] = (mods, None if index is None else index.on_row(row))
    mods, index = shared[key]
    other = copy.copy(pipe)
    other.device = dev
    for name, m in mods.items():
        setattr(other, name, m)
    other.retrieval_index = index
    other.mel = pipe.mel.to(dev)
    if hasattr(pipe, "fcpe_mel"):
        other.fcpe_mel = pipe.fcpe_mel.to(dev)
    other._set_geometry(pipe.cfg)
    return other


def _mesh_key(mesh: Mesh) -> tuple:
    procs = None if mesh.processes is None else tuple(mesh.processes.flat)
    return mesh.devices.shape, tuple(str(d) for d in mesh.devices.flat), procs


def shard_params(pipeline, mesh: Mesh) -> list:
    """One pipeline per data row of ``mesh`` by the rules above (``None`` for
    a row another process feeds); the same rows again while ``pipeline``'s
    weights are unchanged (the pipeline holds them, ``RvcPipeline._mesh_rows``)."""
    if "data" not in mesh.axis_names or "model" not in mesh.axis_names:
        raise ValueError(f"a mesh with ('data', 'model') axes is needed, not {mesh.axis_names}")
    held = pipeline._mesh_rows
    if "version" not in held:
        held["version"] = WeightsVersion(pipeline._weight_modules)
    wkey, mkey = held["version"].key(), _mesh_key(mesh)
    hit = held.get(mkey)
    if hit is None or hit[0] != wkey:
        shared: dict = {}
        hit = held[mkey] = (wkey, [_row_pipeline(pipeline, row, r == 0, shared) if mesh.row_is_local(r) else None
                                   for r, row in enumerate(mesh.rows())])
    return hit[1]


def _row_part(t, n: int, r: int, device):
    if not isinstance(t, torch.Tensor):
        return t
    if t.dim() == 0 or t.shape[0] % n:
        raise ValueError(f"a stream axis of {t.shape[0] if t.dim() else 0} does not split into {n} data rows")
    return t.tensor_split(n)[r].to(device, copy=True)


def shard_state(state, mesh: Mesh) -> list:
    """Each data row's group of streams of ``state`` (a tensor, or a tree of
    them, with a leading stream axis), on the row's first device; ``None``
    for a row another process feeds."""
    rows = mesh.rows()
    return [tree_map(lambda t: _row_part(t, len(rows), r, row[0]), state) if mesh.row_is_local(r) else None
            for r, row in enumerate(rows)]


def shard_controls(controls, mesh: Mesh) -> list:
    """Per-stream controls (``[B]`` leaves) split as :func:`shard_state` splits a state."""
    return shard_state(controls, mesh)


def step_rows(rows: list, states: list, chunks: list, controls: list, graphed: bool = False):
    """The batched step on each local data row: ``rows`` from
    :func:`shard_params`, the rest from :func:`shard_state` and
    :func:`shard_controls`. Eagerly, or with ``graphed`` through each row's
    ``jit_step_batch``. Returns ``(new states, emitted audio)``, a list each
    (``None`` for other processes' rows)."""
    new_states, outs = [], []
    for pipe, state, chunk, ctl in zip(rows, states, chunks, controls):
        if pipe is None:
            new_states.append(None)
            outs.append(None)
            continue
        new, out = pipe.jit_step_batch(state, chunk, ctl) if graphed else pipe.step(state, chunk, ctl, batched=True)
        new_states.append(new)
        outs.append(out)
    return new_states, outs


def gather_rows(parts: list, device: Optional[torch.device] = "cpu"):
    """The rows' results (tensors, or trees of them) joined along the stream
    axis on ``device``."""
    cols = [leaves(p) for p in parts if p is not None]
    joined = iter([torch.cat([c[i].to(device) for c in cols]) if isinstance(cols[0][i], torch.Tensor) else cols[0][i]
                   for i in range(len(cols[0]))])
    return tree_map(lambda _: next(joined), next(p for p in parts if p is not None))
