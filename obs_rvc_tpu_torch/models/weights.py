"""Carry weights into the port: parameter trees in the JAX package's layout →
upstream PyTorch state dicts → ``load_state_dict(strict=True)``.

The port's own copy of the ``export_*`` transforms of
``obs_rvc_tpu/models/weights.py``. Its input is any nested mapping of arrays
in that layout (for example the JAX pipeline's parameter dict fetched with
``jax.device_get``); its output uses the upstream RVC / fairseq / RMVPE key
names, the layout the port's modules carry, so upstream checkpoints can be
loaded the same way.

Layout transforms (JAX layout → PyTorch):

- Dense ``[in, out]`` → Linear ``[out, in]``; as a 1x1 Conv1d ``[out, in, 1]``
- Conv ``[k, in, out]`` → Conv1d ``[out, in, k]``; ``[kh, kw, in, out]`` → Conv2d ``[out, in, kh, kw]``
- transposed convs are stored spatially flipped ``[*k, in, out]`` → flip → ``[in, out, *k]``
- BatchNorm ``scale/bias`` + ``mean/var`` → ``weight/bias/running_mean/running_var``
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _a(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out, prefix, p):
    out[f"{prefix}.weight"] = _a(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _conv1x1(out, prefix, p):
    out[f"{prefix}.weight"] = _a(p["kernel"]).T[:, :, None]
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _conv1d(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_a(p["kernel"]), (2, 1, 0))
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _conv2d(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_a(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _conv_transpose1d(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_a(p["kernel"])[::-1], (1, 2, 0)).copy()
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _conv_transpose2d(out, prefix, p):
    out[f"{prefix}.weight"] = np.transpose(_a(p["kernel"])[::-1, ::-1], (2, 3, 0, 1)).copy()
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def _norm(out, prefix, p, vits=False):
    a, b = ("gamma", "beta") if vits else ("weight", "bias")
    out[f"{prefix}.{a}"] = _a(p["scale"])
    out[f"{prefix}.{b}"] = _a(p["bias"])


def _bn(out, prefix, p, stats):
    out[f"{prefix}.weight"] = _a(p["scale"])
    out[f"{prefix}.bias"] = _a(p["bias"])
    out[f"{prefix}.running_mean"] = _a(stats["mean"])
    out[f"{prefix}.running_var"] = _a(stats["var"])


def contentvec_state_dict(variables: Mapping[str, Any], num_layers: int,
                          final_proj: bool = False) -> dict[str, np.ndarray]:
    """ContentVec variables → fairseq HuBERT state dict."""
    p = variables["params"]
    sd: dict[str, np.ndarray] = {}
    fe = p["feature_extractor"]
    for i in range(7):
        sd[f"feature_extractor.conv_layers.{i}.0.weight"] = np.transpose(
            _a(fe[f"conv_{i}"]["kernel"]), (2, 1, 0))
    sd["feature_extractor.conv_layers.0.2.weight"] = _a(fe["group_norm"]["scale"])
    sd["feature_extractor.conv_layers.0.2.bias"] = _a(fe["group_norm"]["bias"])
    _norm(sd, "layer_norm", p["post_extract_ln"])
    _linear(sd, "post_extract_proj", p["post_extract_proj"])
    pc = p["pos_conv"]["pos_conv"]
    sd["encoder.pos_conv.0.weight"] = np.transpose(_a(pc["kernel"]), (2, 1, 0))
    sd["encoder.pos_conv.0.bias"] = _a(pc["bias"])
    _norm(sd, "encoder.layer_norm", p["encoder_ln"])
    for i in range(num_layers):
        lp = p[f"layer_{i}"]
        a = lp["attn"]
        E = _a(a["out_bias"]).shape[0]
        qkv_k = _a(a["qkv_kernel"])  # [E, 3, H, D]
        qkv_b = _a(a["qkv_bias"])  # [3, H, D]
        for s, name in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"encoder.layers.{i}.self_attn.{name}.weight"] = qkv_k[:, s].reshape(E, E).T
            sd[f"encoder.layers.{i}.self_attn.{name}.bias"] = qkv_b[s].reshape(E)
        sd[f"encoder.layers.{i}.self_attn.out_proj.weight"] = _a(a["out_kernel"]).reshape(E, E).T
        sd[f"encoder.layers.{i}.self_attn.out_proj.bias"] = _a(a["out_bias"])
        _norm(sd, f"encoder.layers.{i}.self_attn_layer_norm", lp["attn_ln"])
        _linear(sd, f"encoder.layers.{i}.fc1", lp["fc1"])
        _linear(sd, f"encoder.layers.{i}.fc2", lp["fc2"])
        _norm(sd, f"encoder.layers.{i}.final_layer_norm", lp["ffn_ln"])
    if final_proj:
        _linear(sd, "final_proj", p["final_proj"])
    return sd


def rmvpe_state_dict(variables: Mapping[str, Any], n_blocks: int = 4, en_de_layers: int = 5,
                     inter_layers: int = 4) -> dict[str, np.ndarray]:
    """RMVPE variables → ``E2E`` state dict."""
    p = variables["params"]["unet"]
    st = variables["batch_stats"]["unet"]
    sd: dict[str, np.ndarray] = {}

    def block(prefix, bp, bs):
        _conv2d(sd, f"{prefix}.conv.0", bp["conv1"])
        _bn(sd, f"{prefix}.conv.1", bp["bn1"], bs["bn1"])
        _conv2d(sd, f"{prefix}.conv.3", bp["conv2"])
        _bn(sd, f"{prefix}.conv.4", bp["bn2"], bs["bn2"])
        if "shortcut" in bp:
            _conv2d(sd, f"{prefix}.shortcut", bp["shortcut"])

    _bn(sd, "unet.encoder.bn", p["in_bn"], st["in_bn"])
    for i in range(en_de_layers):
        for j in range(n_blocks):
            block(f"unet.encoder.layers.{i}.conv.{j}", p[f"encoder_{i}"][f"block_{j}"],
                  st[f"encoder_{i}"][f"block_{j}"])
    for i in range(inter_layers):
        for j in range(n_blocks):
            block(f"unet.intermediate.layers.{i}.conv.{j}", p[f"intermediate_{i}"][f"block_{j}"],
                  st[f"intermediate_{i}"][f"block_{j}"])
    for i in range(en_de_layers):
        dp, ds = p[f"decoder_{i}"], st[f"decoder_{i}"]
        _conv_transpose2d(sd, f"unet.decoder.layers.{i}.conv1.0", dp["up"])
        _bn(sd, f"unet.decoder.layers.{i}.conv1.1", dp["bn"], ds["bn"])
        for j in range(n_blocks):
            block(f"unet.decoder.layers.{i}.conv2.{j}", dp[f"block_{j}"], ds[f"block_{j}"])
    top = variables["params"]
    _conv2d(sd, "cnn", top["cnn"])
    for d, s in ((0, ""), (1, "_reverse")):
        sd[f"fc.0.gru.weight_ih_l0{s}"] = _a(top["gru"][f"l0_d{d}_w_ih"])
        sd[f"fc.0.gru.weight_hh_l0{s}"] = _a(top["gru"][f"l0_d{d}_w_hh"])
        sd[f"fc.0.gru.bias_ih_l0{s}"] = _a(top["gru"][f"l0_d{d}_b_ih"])
        sd[f"fc.0.gru.bias_hh_l0{s}"] = _a(top["gru"][f"l0_d{d}_b_hh"])
    _linear(sd, "fc.1", top["fc"])
    return sd


def synthesizer_state_dict(variables: Mapping[str, Any], cfg) -> dict[str, np.ndarray]:
    """Synthesizer variables → ``SynthesizerTrnMsNSFsid`` state dict (weight norm folded)."""
    p = variables["params"]
    sd: dict[str, np.ndarray] = {}
    enc = p["enc_p"]
    _linear(sd, "enc_p.emb_phone", enc["emb_phone"])
    sd["enc_p.emb_pitch.weight"] = _a(enc["emb_pitch"]["embedding"])
    for i in range(cfg.n_layers):
        a = enc[f"attn_{i}"]
        for c in ("conv_q", "conv_k", "conv_v", "conv_o"):
            _conv1x1(sd, f"enc_p.encoder.attn_layers.{i}.{c}", a[c])
        sd[f"enc_p.encoder.attn_layers.{i}.emb_rel_k"] = _a(a["emb_rel_k"])
        sd[f"enc_p.encoder.attn_layers.{i}.emb_rel_v"] = _a(a["emb_rel_v"])
        _norm(sd, f"enc_p.encoder.norm_layers_1.{i}", enc[f"norm1_{i}"], vits=True)
        _conv1d(sd, f"enc_p.encoder.ffn_layers.{i}.conv_1", enc[f"ffn_{i}"]["conv_1"])
        _conv1d(sd, f"enc_p.encoder.ffn_layers.{i}.conv_2", enc[f"ffn_{i}"]["conv_2"])
        _norm(sd, f"enc_p.encoder.norm_layers_2.{i}", enc[f"norm2_{i}"], vits=True)
    _conv1x1(sd, "enc_p.proj", enc["proj"])
    for fi in range(cfg.flow_flows):
        fl = p["flow"][f"flow_{fi}"]
        f = f"flow.flows.{2 * fi}"
        _conv1x1(sd, f"{f}.pre", fl["pre"])
        _conv1x1(sd, f"{f}.post", fl["post"])
        _conv1x1(sd, f"{f}.enc.cond_layer", fl["enc"]["cond_layer"])
        for j in range(cfg.flow_layers):
            _conv1d(sd, f"{f}.enc.in_layers.{j}", fl["enc"][f"in_{j}"])
            _conv1d(sd, f"{f}.enc.res_skip_layers.{j}", fl["enc"][f"res_skip_{j}"])
    dec = p["dec"]
    _conv1d(sd, "dec.conv_pre", dec["conv_pre"])
    _conv1x1(sd, "dec.cond", dec["cond"])
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        _conv_transpose1d(sd, f"dec.ups.{i}", dec[f"ups_{i}"])
        _conv1d(sd, f"dec.noise_convs.{i}", dec[f"noise_conv_{i}"])
        for j in range(nk):
            rb = dec[f"resblock_{i}_{j}"]
            for l in range(len(cfg.resblock_dilation_sizes[j])):
                _conv1d(sd, f"dec.resblocks.{i * nk + j}.convs1.{l}", rb[f"conv1_{l}"])
                _conv1d(sd, f"dec.resblocks.{i * nk + j}.convs2.{l}", rb[f"conv2_{l}"])
    _conv1d(sd, "dec.conv_post", dec["conv_post"])
    _linear(sd, "dec.m_source.l_linear", dec["source_linear"])
    sd["emb_g.weight"] = _a(p["emb_g"]["embedding"])
    return sd


def load_state_dict(module: torch.nn.Module, sd: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """``load_state_dict(strict=True)`` from numpy arrays onto the module's
    device; BatchNorm's ``num_batches_tracked`` counters (bookkeeping with no
    effect in eval mode) are filled in where the source has none. Leaves the
    module in eval mode."""
    full = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    for name, buf in module.named_buffers():
        if name.endswith("num_batches_tracked") and name not in full:
            full[name] = torch.zeros_like(buf, device="cpu")
    module.load_state_dict(full, strict=True)
    return module.eval()


def load_jax_params(pipe, params: Mapping[str, Any]) -> None:
    """Load the JAX pipeline's parameter dict ``{"contentvec", "rmvpe",
    "synthesizer"}`` into a port :class:`~obs_rvc_tpu_torch.stream.pipeline.RvcPipeline`."""
    cv = pipe.contentvec_cfg
    rm = pipe.rmvpe_cfg
    load_state_dict(pipe.contentvec,
                    contentvec_state_dict(params["contentvec"], cv.num_layers, cv.final_proj))
    load_state_dict(pipe.rmvpe,
                    rmvpe_state_dict(params["rmvpe"], rm.n_blocks, rm.en_de_layers, rm.inter_layers))
    load_state_dict(pipe.synthesizer, synthesizer_state_dict(params["synthesizer"], pipe.synth_cfg))
