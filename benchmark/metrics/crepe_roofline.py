"""CREPE's conv stack against its bound: the bound of one step's forward at
the shapes launched (``crepe_flops_bytes`` at the cell's streams times the
pitch window's frames), over the median, across the steps the program
timed (every few steps, on the timed path), of the summed ``crepe.*``
spans: the device ms between the CUDA events the program records before
CREPE's first block, after each of its six blocks and after its
classifier, inside the ``salience`` stage's graph (read from its
process-wide collector, ``serve/metrics.py:process_samples``). None for any
other pitch network, and where the program records none of the spans (the
CPU has no such events, nor has a program without them)."""

from statistics import median

from benchmark import yardstick

SPANS = tuple(f"crepe.conv{i}" for i in range(1, 7)) + ("crepe.head",)
#: each block's output channels by capacity, kernels and strides (``reference/pitch/crepe.py``'s tables, copied)
CHANNELS = {"full": (1024, 128, 128, 128, 256, 512), "tiny": (128, 16, 16, 16, 32, 64)}
KERNELS = (512, 64, 64, 64, 64, 64)
STRIDES = (4, 1, 1, 1, 1, 1)
#: each block's zero padding, both sides together
PADS = (508, 63, 63, 63, 63, 63)
FRAME, BINS = 1024, 360


def crepe_flops_bytes(frames: int, capacity: str = "full", elem: int = 2):
    """Operations and bytes of CREPE's forward over ``frames`` frames (a
    multiply-add 2 operations; convolutions and the classifier, as
    ``benchmark/flops.py`` counts them). Bytes: each weight, bias and norm
    parameter read once, the frames read once, each block's pooled output
    written once and read once, the salience written once, every element
    ``elem`` bytes."""
    flops, nbytes, cin, L = 0, frames * FRAME * elem, 1, FRAME
    for c, k, s, pad in zip(CHANNELS[capacity], KERNELS, STRIDES, PADS):
        L = (L + pad - k) // s + 1  # block 1: 1024 → 256; the others keep their length
        flops += 2 * k * cin * c * L * frames
        nbytes += elem * (k * cin * c + c + 4 * c)
        L //= 2
        nbytes += 2 * elem * frames * c * L
        cin = c
    features = cin * L
    flops += 2 * features * BINS * frames
    nbytes += elem * (features * BINS + BINS + frames * BINS)
    return flops, nbytes


def read(ctx):
    if ctx.cfg.get("pitch") != "crepe":
        return None
    try:
        from obs_rvc_tpu_torch.serve.metrics import process_samples
    except ImportError:
        return None
    samples = [process_samples(name) for name in SPANS]
    if not all(samples):
        return None
    steps = [sum(parts) for parts in zip(*samples)]
    frames = ctx.window["streams"] * ctx.geometry.pitch_frames
    bound = yardstick.bound_ms(*crepe_flops_bytes(frames, ctx.cfg["crepe"]["capacity"],
                                                  yardstick.ELEM[ctx.cfg["dtype"]]),
                               yardstick.PEAK_BY_DTYPE[ctx.cfg["dtype"]])[0]
    return 100.0 * bound / median(steps)
