"""Engine-level API: the plugin's ``RvcInfer`` surface (counterpart of
``obs_rvc_tpu/stream/engine.py``), which the reference RPC front door drives
as ``infer(input16k, n16k, pitch_shift, skip_head, return_length)``.

Each request carries its own geometry. A request at the launch geometry runs
on the launch pipeline; any other geometry gets a pipeline of its own from
:meth:`RvcPipeline.with_config`, which shares the launch pipeline's networks,
kept in a small bounded cache. The ``cache_pitchf`` f0 history is engine
state shared by every request, whatever its geometry, as the plugin keeps
one on its ``RvcInfer``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.stream.pipeline import RvcPipeline, StepControls
from obs_rvc_tpu_torch.stream.state import StreamState


class EngineError(RuntimeError):
    """A request the engine cannot serve (the plugin's RvcInferError)."""


class RvcEngine:
    def __init__(self, pipeline: RvcPipeline, max_geometries: int = 8, exec_cache: bool = False):
        if exec_cache:
            raise NotImplementedError("exec_cache: persisted executables are not ported "
                                      "(ROADMAP.md queue 1 item 14)")
        self.pipeline = pipeline
        self.cache_pitchf = np.zeros(pipeline.cfg.pitch_cache_len, dtype=np.float32)
        self.max_geometries = max_geometries
        self.loaded = True
        self._pipelines: dict[tuple, RvcPipeline] = {}
        self._lock = threading.Lock()

    # --- model management ---

    def unload_model(self) -> None:
        self.loaded = False

    def load_model(self) -> None:
        self.loaded = True

    def _pipeline_for(self, key: tuple) -> RvcPipeline:
        input_len, n16k, skip_head, return_length = key
        launch = self.pipeline
        lc = launch.cfg
        if key == (lc.input_buffer_16k_size, lc.sample_frame_16k_size, lc.skip_head, lc.return_length):
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
                # bounded: drop the oldest geometry (dicts keep insertion order)
                self._pipelines.pop(next(iter(self._pipelines)))
            self._pipelines[key] = pipe
        return pipe

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
        with self._lock, torch.no_grad():
            pipe = self._pipeline_for(key)
            dev = pipe.device
            buf16 = torch.from_numpy(np.ascontiguousarray(input_16k, dtype=np.float32)).to(dev)
            state = StreamState(
                input_buffer=torch.zeros(pipe.cfg.input_buffer_size, device=dev),
                input_buffer_16k=buf16,
                sola_buffer=torch.zeros(pipe.cfg.sola_buffer_frame_size, device=dev),
                cache_pitchf=torch.from_numpy(self.cache_pitchf).to(dev),
            )
            audio, new_cache = pipe._infer(state.cache_pitchf, buf16, controls)
            self.cache_pitchf = new_cache.cpu().numpy()
            return audio.cpu().numpy()
