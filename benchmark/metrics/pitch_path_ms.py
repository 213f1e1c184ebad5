"""Device ms of the pitch stages on the timed path: ``mel``, ``salience``
and ``pitch_post``, each the median over the steps the program timed by
CUDA events (every few steps) of the time between the events around the
stage's launches (the program's ``stage.<stage>``, read from its
process-wide collector, ``serve/metrics.py:process_samples``), summed;
``pitch_ms`` replays the same graphs alone. It counts the run's whole
process: the warm-up steps and the traced slice's besides the window, hence
the medians. None where the program records none of a stage (the CPU has
no stage events)."""

from statistics import median

STAGES = ("mel", "salience", "pitch_post")


def read(ctx):
    try:
        from obs_rvc_tpu_torch.serve.metrics import process_samples
    except ImportError:
        return None
    samples = [process_samples(f"stage.{s}") for s in STAGES]
    return sum(median(v) for v in samples) if all(samples) else None
