"""RMVPE's U-Net chain kernel (``csrc/unet_block.cu``) against its bound:
the bound of every chain launch a step makes, at the shapes launched
(``yardstick.chain_flops_bytes`` per level the configuration routes to the
kernel), times the traced steps, over the kernels' summed device time."""

from benchmark import yardstick
from benchmark.metrics._kernels import share_pct

MARKERS = ("conv3x3_kernel", "ring_batch_kernel")


def levels(cfg):
    """``(H, W, cin, C)`` of each U-Net level the chain kernel runs."""
    if cfg["pitch"] != "rmvpe" or not cfg["rmvpe"].get("pallas_unet", True):
        return []
    r = cfg["rmvpe"]
    from benchmark.harness import geometry

    T, mels, max_ch = geometry(cfg).pitch_frames, 128, r.get("pallas_unet_max_ch", 32)
    out, c = [], r["en_out_channels"]
    for i in range(r["en_de_layers"]):  # encoder level i, then the decoder level at its resolution
        C, cin = c * 2**i, (1 if i == 0 else c * 2 ** (i - 1))
        if C <= max_ch:
            out += [(T >> i, mels >> i, cin, C), (T >> i, mels >> i, 2 * C, C)]
    return out


def read(ctx):
    elem = yardstick.ELEM[ctx.cfg["dtype"]]
    peak = yardstick.PEAK_BY_DTYPE[ctx.cfg["dtype"]]
    B = ctx.window["streams"]
    bound = sum(yardstick.bound_ms(*yardstick.chain_flops_bytes(B, H, W, cin, C, elem, elem,
                                                                ctx.cfg["rmvpe"]["n_blocks"]), peak)[0]
                for H, W, cin, C in levels(ctx.cfg))
    if not bound:
        return None
    return share_pct(ctx.trace, MARKERS, bound)
