"""The synthesizer's resblock bank kernel (``csrc/resblock.cu``) against its
bound: the bound of each upsample level the configuration routes to the
kernel (``yardstick.bank_flops_bytes`` at the level's length and width),
times the traced steps, over the kernels' summed device time."""

from benchmark import yardstick
from benchmark.metrics._kernels import share_pct

MARKERS = ("resblock_bank_kernel", "resblock_bank_sum_kernel")
#: the widths the program's bank kernel takes
BANK_MAX_CH = 64


def levels(cfg):
    """``(L, C)`` of each upsample level whose bank runs on the kernel."""
    s = cfg["synthesizer"]
    dils = s["resblock_dilation_sizes"]
    if not s.get("pallas_resblocks", True) or any(d != dils[0] for d in dils):
        return []
    from benchmark.harness import geometry

    L, out = geometry(cfg).return_frames, []
    for i, u in enumerate(s["upsample_rates"]):
        L *= u
        C = s["upsample_initial_channel"] // 2 ** (i + 1)
        if C <= BANK_MAX_CH:
            out.append((L, C))
    return out


def read(ctx):
    s = ctx.cfg["synthesizer"]
    elem = yardstick.ELEM[ctx.cfg["dtype"]]
    peak = yardstick.PEAK_BY_DTYPE[ctx.cfg["dtype"]]
    B = ctx.window["streams"]
    bound = sum(yardstick.bound_ms(*yardstick.bank_flops_bytes(B, L, C, elem, elem, tuple(s["resblock_kernel_sizes"]),
                                                               tuple(s["resblock_dilation_sizes"][0])), peak)[0]
                for L, C in levels(ctx.cfg))
    return share_pct(ctx.trace, MARKERS, bound)
