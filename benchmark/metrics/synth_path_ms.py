"""Device ms of the ``synth`` stage on the timed path: the median over the
steps the program timed by CUDA events (every few steps) of the time
between the events around the stage's launches (the program's
``stage.synth``, read from its process-wide collector,
``serve/metrics.py:process_samples``); ``synth_ms`` replays the same graph
alone. It counts the run's whole process: the warm-up steps and the traced
slice's besides the window, hence the median. None where the program
records none (the CPU has no stage events)."""

from statistics import median


def read(ctx):
    try:
        from obs_rvc_tpu_torch.serve.metrics import process_samples
    except ImportError:
        return None
    samples = process_samples("stage.synth")
    return median(samples) if samples else None
