"""Which stage of the PyTorch port's float32 step is not bitwise repeatable
on a CUDA card, with cuDNN's default algorithms and with
``torch.backends.cudnn.deterministic``: each stage is run three times on the
same inputs at full width, and the largest difference is printed.

    PYTHONPATH=. python3 scripts/torch_cudnn_determinism.py     # from a checkout's root
"""
import numpy as np
import torch

import chip_smoke as cs
from obs_rvc_tpu_torch.config import ChunkConfig
from obs_rvc_tpu_torch.ops import _cuda
from obs_rvc_tpu_torch.stream import RvcPipeline, StepControls

_cuda.build()
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
cfg = ChunkConfig.build()
pipe = RvcPipeline(cfg)
pipe.init_params(0, std=None)
wav = torch.from_numpy(cs.voiced_signal(4 * cfg.sample_frame_size, cfg.sample_rate)).cuda()
controls = StepControls.default().on(pipe.device)
state = pipe.new_state()
with torch.no_grad():
    for i in range(3):
        state, _ = pipe.step(state, wav[i * cfg.sample_frame_size:(i + 1) * cfg.sample_frame_size], StepControls.default())
    chunk = wav[3 * cfg.sample_frame_size:]
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        outs = []
        for rep in range(3):
            buf, buf16 = pipe.stage_pre(state, chunk)
            phone = pipe.stage_features(buf16)
            mel = pipe.stage_mel(buf16)
            sal = pipe.stage_salience(mel)
            cache, pitch, pitchf = pipe.stage_pitch_post(state.cache_pitchf, sal, controls)
            audio = pipe.stage_synth(phone, pitch, pitchf, controls.sid)
            outs.append(dict(buf16=buf16, features=phone, mel=mel, salience=sal, pitchf=pitchf, audio=audio))
        # each stage fed the first run's inputs, so a difference is the stage's own
        own = {}
        for rep in range(3):
            own.setdefault("features", []).append(pipe.stage_features(outs[0]["buf16"]))
            own.setdefault("salience", []).append(pipe.stage_salience(outs[0]["mel"]))
            own.setdefault("synth", []).append(pipe.stage_synth(outs[0]["features"], *pipe.stage_pitch_post(state.cache_pitchf, outs[0]["salience"], controls)[1:], controls.sid))
        torch.cuda.synchronize()
        print(f"cudnn.deterministic={det}: chained stages equal across 3 runs:",
              {k: all(torch.equal(o[k], outs[0][k]) for o in outs) for k in outs[0]})
        print(f"cudnn.deterministic={det}: each stage on the same input, equal across 3 runs:",
              {k: all(torch.equal(v, vs[0]) for v in vs) for k, vs in own.items()},
              {k: float(max((v - vs[0]).abs().max() for v in vs)) for k, vs in own.items()})
