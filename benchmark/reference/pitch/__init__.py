"""The reference's pitch networks, one file each: ``<name>.py`` beside this
one, found by the configuration's ``pitch``. A later network is a new file
here, and no file that is there changes.

A file imports nothing of the program and gives:

- ``Size``: a frozen dataclass of the network's sizes, read from the
  configuration's block named after the network (its ``program_only`` keys
  left out);
- ``Net(size, prec)``: the float32 reference, a module whose keys are the
  upstream checkpoint's (every product reads its activation through
  ``prec.act``, as :mod:`benchmark.reference.nets` does);
- ``inputs(window)``: the 16 kHz pitch window ``[B, pitch_window]`` → what
  ``Net`` takes;
- ``decode(salience)``: ``Net``'s output → f0 in Hz, 0 where unvoiced,
  ``[B, pitch_frames]``;
- ``HEADS``: the keys of the salience head's weights, which
  :func:`benchmark.weights.structure` gives a trained head's single peak;
- ``PROGRAM``: the program's names for the network, as strings:
  ``pitch_algorithm`` (``RvcPipeline``'s argument and the key of its
  ``modules()``), ``config`` (the config class in
  ``obs_rvc_tpu_torch.models``) and ``pipeline_kw`` (the ``RvcPipeline``
  keyword that takes it);
- ``TINY``: the configuration's block at the CPU tests' reduced widths.
"""

from __future__ import annotations

import importlib
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
#: a network's name: a file name that stays in this directory
NAME = re.compile(r"[a-z][a-z0-9_]*")


def load(name: str):
    """The module of pitch network ``name``; ``ValueError`` naming the file
    looked for where there is none."""
    path = HERE / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"no pitch network {name!r}: the reference looked for {path}")
    return importlib.import_module(f"{__name__}.{name}")
