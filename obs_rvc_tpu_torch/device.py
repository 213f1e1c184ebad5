"""Where the port's entry points put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the card; with no card that is an error, never a silent
    move to the CPU (pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def deterministic_cudnn() -> None:
    """Hold cuDNN to its deterministic engines, for the whole process: the
    step is bitwise repeatable on a card. cuDNN's default engine for RMVPE's
    decoder ``ConvTranspose2d`` in float32 is not (many of the salience's
    elements move in their last bits from call to call), and which engine
    its heuristics rank first is cuDNN's to change, in bfloat16 too, where
    one moved bit reaches the audio. Every pipeline built on a card sets it;
    nothing in the port clears it."""
    torch.backends.cudnn.deterministic = True


def run_inline(name: str, fn, *args, device=None):
    """The eager runner of a step's pieces: ``fn(*args)``, the tensor
    arguments first moved to ``device`` when one is named. The graphed forms
    (``stream/graphs.py``) take the same ``run(name, fn, *args, device=)``
    calls and replay a graph of each named piece on its device instead."""
    if device is not None:
        args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    return fn(*args)
