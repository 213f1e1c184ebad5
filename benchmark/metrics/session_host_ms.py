"""The session's host time a chunk, ms: the median over chunks of the
program's ``session.host`` span (``session.chunk``, from the pop to the
push, less ``session.wait``, the host blocked on the device), read from the
program's process-wide collector (``serve/metrics.py:process_samples``).
It counts the run's whole process: the warm-up chunks and the traced
slice's chunks besides the window, hence the median. None where the program
records no such span."""

from statistics import median


def read(ctx):
    try:
        from obs_rvc_tpu_torch.serve.metrics import process_samples
    except ImportError:
        return None
    samples = process_samples("session.host")
    return median(samples) if samples else None
