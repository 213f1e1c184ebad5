"""Engine-level API: the plugin's ``RvcInfer`` surface (counterpart of
``obs_rvc_tpu/stream/engine.py``), which the reference RPC front door drives
as ``infer(input16k, n16k, pitch_shift, skip_head, return_length)``.

Each request carries its own geometry. A request at the launch geometry runs
on the launch pipeline; any other geometry gets a pipeline of its own from
:meth:`RvcPipeline.with_config`, which shares the launch pipeline's networks,
kept in a small bounded cache. Each geometry's request runs as one CUDA
graph (``RvcPipeline.jit_infer``, the counterpart of the JAX engine's
``jax.jit(run)``), captured at its first request; an evicted geometry's
pipeline goes with its graph and the graph's memory pool. With
``exec_cache=True`` the graphs go through
:func:`~obs_rvc_tpu_torch.utils.exec_cache.cached_capture`, keyed by the
pipeline's fingerprint and ``"|engine_infer"``. The ``cache_pitchf`` f0
history is engine state shared by every request, whatever its geometry, as
the plugin keeps one on its ``RvcInfer``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline, StepControls
from obs_rvc_tpu_torch.utils.exec_cache import cached_capture


class EngineError(RuntimeError):
    """A request the engine cannot serve (the plugin's RvcInferError)."""


class RvcEngine:
    def __init__(self, pipeline: RvcPipeline, max_geometries: int = 8, exec_cache: bool = False):
        self.pipeline = pipeline
        self.cache_pitchf = np.zeros(pipeline.cfg.pitch_cache_len, dtype=np.float32)
        self.max_geometries = max_geometries
        self.exec_cache = exec_cache
        self.loaded = True
        self._pipelines: dict[tuple, RvcPipeline] = {}
        #: exec_cache: each geometry's graph from cached_capture, evicted with its pipeline
        self._cached: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _launch_key(self) -> tuple:
        lc = self.pipeline.cfg
        return lc.input_buffer_16k_size, lc.sample_frame_16k_size, lc.skip_head, lc.return_length

    def prepare(self) -> None:
        """Capture the launch geometry's graph now, before the first request
        (a server calls this before it listens). Nothing to do without networks."""
        if self.pipeline.modules():
            with self._lock:
                self._infer_fn(self._launch_key()).capture()

    # --- model management ---

    def unload_model(self) -> None:
        self.loaded = False

    def load_model(self) -> None:
        self.loaded = True

    def _pipeline_for(self, key: tuple) -> RvcPipeline:
        input_len, n16k, skip_head, return_length = key
        launch = self.pipeline
        lc = launch.cfg
        if key == self._launch_key():
            return launch
        pipe = self._pipelines.get(key)
        if pipe is None:
            try:
                cfg = ChunkConfig.for_request(input_len, n16k, skip_head, return_length,
                                              model_sample_rate=lc.model_sample_rate,
                                              feature_dim=lc.feature_dim, sample_rate=lc.sample_rate)
                pipe = launch.with_config(cfg)
            except ValueError as e:
                raise EngineError(f"invalid request geometry {key}: {e}") from e
            if len(self._pipelines) >= self.max_geometries:
                # bounded: drop the oldest geometry (dicts keep insertion order), and its graph with it
                oldest = next(iter(self._pipelines))
                self._pipelines.pop(oldest)
                self._cached.pop(oldest, None)
            self._pipelines[key] = pipe
        return pipe

    def _infer_fn(self, key: tuple):
        """The graphed ``_infer`` of the geometry ``key``."""
        pipe = self._pipeline_for(key)
        if not self.exec_cache:
            return pipe.jit_infer
        fn = self._cached.get(key)
        if fn is None:
            fn, _ = cached_capture(pipe.jit_infer, pipe.jit_infer.static_args,
                                   semantic_key=pipe.fingerprint() + "|engine_infer")
            self._cached[key] = fn
        return fn

    # --- the RPC-visible call ---

    def infer(
        self,
        input_16k: np.ndarray,
        sample_frame_16k_size: int,
        pitch_shift: int,
        skip_head: int,
        return_length: int,
    ) -> np.ndarray:
        """Model-rate audio ``[return_length * model_sr / 100]`` for one 16 kHz
        input buffer; advances the shared f0 history."""
        if not self.loaded:
            raise EngineError("model not loaded")
        if not self.pipeline.modules():
            raise EngineError("the pipeline has no networks (it was built for the passthrough "
                              "geometry, skip_inference)")
        input_len = int(np.shape(input_16k)[-1])
        if skip_head + return_length > input_len // 160:
            raise EngineError(f"skip_head+return_length ({skip_head}+{return_length}) exceeds "
                              f"available feature frames ({input_len // 160})")
        key = (input_len, int(sample_frame_16k_size), int(skip_head), int(return_length))
        controls = StepControls.default(pitch_shift=float(pitch_shift))
        buf16 = torch.from_numpy(np.ascontiguousarray(input_16k, dtype=np.float32))
        with self._lock, torch.no_grad():
            fn = self._infer_fn(key)
            with fn.lock:  # the graph's outputs are read before anyone replays it again
                audio, new_cache = fn.run(torch.from_numpy(self.cache_pitchf), buf16, controls)
                self.cache_pitchf = new_cache.cpu().numpy()
                return audio.cpu().numpy()
