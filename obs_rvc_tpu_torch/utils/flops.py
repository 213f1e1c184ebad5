"""Analytic FLOP counts for the three networks, per chunk (counterpart of
``obs_rvc_tpu/utils/flops.py``, copied: the port imports nothing of the JAX
package).

``scripts/torch_bench.py`` and ``chip_smoke.py`` divide them by the step's
time for the step's MFU against the card's peak. Counts are multiply-add =
2 FLOPs, inference path only, matching the shapes the default streaming
geometry feeds. ``crepe_gflops``, ``fcpe_gflops`` and ``chunk_gflops`` are
the port's own: they count the pitch network the pipeline runs.
"""

from __future__ import annotations


def contentvec_gflops(L16k: int, dim: int = 768, layers: int = 12, ffn: int = 3072) -> float:
    """Conv frontend + transformer FLOPs for one [1, L16k] chunk."""
    t = L16k
    fl = 0.0
    specs = [(1, 512, 10, 5)] + [(512, 512, 3, 2)] * 4 + [(512, 512, 2, 2)] * 2
    for cin, cout, k, s in specs:
        t = (t - k) // s + 1
        fl += 2 * t * k * cin * cout
    T = t
    per_layer = 2 * (4 * T * dim * dim) + 2 * (2 * T * T * dim) + 2 * (2 * T * dim * ffn)
    fl += layers * per_layer
    return fl / 1e9


def rmvpe_gflops(T: int, mels: int = 128) -> float:
    """DeepUnet + BiGRU + head FLOPs for one [1, 128, T] mel chunk."""
    fl = 0.0
    h, w = T, mels
    ch_in = 1
    for ch in (16, 32, 64, 128, 256):
        fl += 2 * h * w * 9 * ch_in * ch
        fl += 2 * h * w * 9 * ch * ch * (2 * 4 - 1)
        h, w = h // 2, w // 2
        ch_in = ch
    fl += 2 * h * w * 9 * 256 * 512
    fl += 2 * h * w * 9 * 512 * 512 * (2 * 4 - 1)
    ch = 512
    for _ in range(5):
        h, w = h * 2, w * 2
        ch = ch // 2
        fl += 2 * h * w * 9 * (2 * ch) * ch * (2 * 4)
    fl += 2 * T * (3 * 256 * 384 + 3 * 256 * 256) * 2
    fl += 2 * T * 512 * 360
    return fl / 1e9


def synth_gflops(T: int, upsample_rates=(10, 10, 2, 2),
                 upsample_kernels=(16, 16, 4, 4)) -> float:
    """TextEncoder + flow + GeneratorNSF FLOPs for T feature frames."""
    d, f = 192, 768
    fl = 6 * (2 * 4 * T * d * d + 2 * 2 * T * T * d + 2 * 2 * T * d * f * 3)
    fl += 4 * (2 * T * (96 * 192) + 3 * 2 * T * 5 * 192 * 384 + 2 * T * 192 * 96)
    L = T
    ch = 512
    fl += 2 * L * 7 * 192 * 512
    for u, k in zip(upsample_rates, upsample_kernels):
        L *= u
        ch //= 2
        fl += 2 * L * k * (2 * ch) * ch / u
        fl += 3 * 6 * 2 * L * 11 * ch * ch
    fl += 2 * L * 7 * ch
    return fl / 1e9


def pipeline_gflops_per_chunk(cfg, feature_dim: int = 768) -> float:
    """Total neural-net GFLOPs per streaming chunk at geometry ``cfg``."""
    return (
        contentvec_gflops(cfg.input_buffer_16k_size, dim=feature_dim if feature_dim == 768 else 768)
        + rmvpe_gflops(cfg.rmvpe_n_frames)
        + synth_gflops(cfg.return_length)
    )


def crepe_gflops(crepe, n_frames: int) -> float:
    """CREPE's multiply-adds (x2) over ``n_frames`` frames of 1024 samples:
    six convolutions over the frame axis (pads 254/254, then 31/32; stride 4
    on the first), each output halved by its max-pool, and the classifier."""
    fl, length = 0, 1024
    for i in range(1, 7):
        conv = getattr(crepe, f"conv{i}")
        k, stride = conv.kernel_size[0], conv.stride[0]
        out = (length + (508 if i == 1 else 63) - k) // stride + 1
        fl += 2 * out * conv.in_channels * conv.out_channels * k
        length = out // 2
    fl += 2 * crepe.classifier.in_features * crepe.classifier.out_features
    return n_frames * fl / 1e9


def fcpe_gflops(fcpe, n_frames: int) -> float:
    """FCPE's multiply-adds (x2) over ``n_frames`` mel frames: the two k3
    input convs, each layer's two pointwise convs and its depthwise conv,
    and the output projection (norms and gates not counted, as the counts
    above count none)."""
    c = fcpe.cfg
    inner = c.hidden * c.expansion
    per_layer = c.hidden * 2 * inner + inner * c.conv_kernel + inner * c.hidden
    fl = 3 * c.n_mels * c.hidden + 3 * c.hidden * c.hidden + c.n_layers * per_layer + c.hidden * c.out_dims
    return 2 * n_frames * fl / 1e9


def chunk_gflops(pipe) -> float:
    """The networks' GFLOP for one stream's chunk of an ``RvcPipeline``:
    ContentVec, the pitch network it runs (RMVPE, CREPE or FCPE, each
    counted; the JAX package's bench counts RMVPE for all three) and the
    synthesizer."""
    cfg = pipe.cfg
    total = pipeline_gflops_per_chunk(cfg, pipe.contentvec_cfg.out_dim)
    if pipe.pitch_algorithm == "rmvpe":
        return total
    total -= rmvpe_gflops(cfg.rmvpe_n_frames)
    if pipe.pitch_algorithm == "crepe":
        return total + crepe_gflops(pipe.crepe, cfg.rmvpe_n_frames)
    return total + fcpe_gflops(pipe.fcpe, cfg.rmvpe_n_frames)
