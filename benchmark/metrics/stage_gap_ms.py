"""The device's wait for the host between a step's stages, ms: the median
over the steps the program timed by CUDA events (every few steps, on the
timed path) of the summed time from each stage's end event to the next
stage's start event (the program's ``stage_gap``, read from its
process-wide collector, ``serve/metrics.py:process_samples``). It counts the
run's whole process: the warm-up steps and the traced slice's besides the
window, hence the median. None where the program records none (the CPU has
no stage events)."""

from statistics import median


def read(ctx):
    try:
        from obs_rvc_tpu_torch.serve.metrics import process_samples
    except ImportError:
        return None
    samples = process_samples("stage_gap")
    return median(samples) if samples else None
