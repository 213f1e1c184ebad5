"""Where CREPE ``full``'s device time goes on one CUDA card, layer by layer,
at the streaming step's 64 frames, float32 (TF32 off) and bfloat16, and
what another layout of the same convolutions costs on cuDNN.

    python3 scripts/torch_crepe_probe.py       # from the repo root, on a card

Each row is device time by CUDA events around replays of a CUDA graph of
the call (``chip_smoke.graph_ms``). Layouts of each convolution:
``conv1d`` over ``[N, C, L]``; ``conv2d``, the port's module and
torchcrepe's (``Conv2d`` with a ``(k, 1)`` kernel over ``[N, C, L, 1]``);
``conv2d-nhwc`` the same in ``channels_last``; for conv2 (1024 → 128
channels) also ``split8``: eight convolutions over 128 input channels each,
their bf16 outputs summed in float32. Each with cuDNN's heuristics
(benchmark off, as the port runs) and with ``cudnn.benchmark`` on. Random
fan-in-scaled weights from seed 0. Writes ``chiprun_out/crepe_probe.json``.
"""

import json
import pathlib
import sys

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from obs_rvc_tpu_torch.models.crepe import _PADS, Crepe, CrepeConfig  # noqa: E402
from obs_rvc_tpu_torch.stream.pipeline import _random_state_dict  # noqa: E402
from obs_rvc_tpu_torch.models.weights import load_state_dict  # noqa: E402

N_FRAMES = 64


def layer_inputs(model, frames):
    """Each conv's padded input, by running the module's own forward."""
    x, out = frames.to(model.classifier.weight.dtype)[:, None, :], []
    for i in range(1, 7):
        x = F.pad(x, _PADS[i - 1])
        out.append(x)
        x = getattr(model, f"conv{i}")(x[..., None])[..., 0]
        x = F.max_pool1d(getattr(model, f"conv{i}_BN")(F.relu(x)), 2, 2)
    return out


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    print(smi)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.standard_normal((N_FRAMES, 1024)).astype(np.float32)).to(dev)
    base = Crepe(CrepeConfig("full"))
    load_state_dict(base, _random_state_dict(base, np.random.default_rng(0), None))
    report = {"device": smi, "frames": N_FRAMES, "rows": []}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            model = Crepe(CrepeConfig("full")).to(dev)
            model.load_state_dict(base.state_dict())
            model = model.to(dtype).eval()
            xs = layer_inputs(model, frames)
            cases = {"whole network": lambda: model(frames)}
            for i, x in enumerate(xs, 1):
                conv = getattr(model, f"conv{i}")
                w3, x4 = conv.weight[..., 0].contiguous(), x[..., None]
                w4n, x4n = (t.contiguous(memory_format=torch.channels_last) for t in (conv.weight, x4))
                s = conv.stride
                cases[f"conv{i} conv1d"] = lambda x=x, w=w3, c=conv, s=s: F.conv1d(x, w, c.bias, stride=s[0])
                cases[f"conv{i} conv2d"] = lambda x=x4, c=conv: c(x)
                cases[f"conv{i} conv2d-nhwc"] = lambda x=x4n, w=w4n, c=conv, s=s: F.conv2d(x, w, c.bias, stride=s)
                if conv.in_channels == 1024:
                    def split8(x=x4, c=conv):
                        parts = [F.conv2d(x[:, g : g + 128], c.weight[:, g : g + 128]).float()
                                 for g in range(0, 1024, 128)]
                        return (torch.stack(parts).sum(0) + c.bias.float()[:, None, None]).to(x.dtype)
                    cases[f"conv{i} split8"] = split8
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                for name, fn in cases.items():
                    ms = cs.graph_ms(fn)
                    row = {"dtype": str(dtype)[6:], "benchmark": bench, "case": name, "ms": ms}
                    if name.startswith("conv"):
                        i = int(name[4])
                        conv, x = getattr(model, f"conv{i}"), xs[i - 1]
                        if name.endswith("split8"):
                            row["max_abs_diff"] = float((fn().float() - cases[f"conv{i} conv2d"]().float()).abs().max())
                        out = (x.shape[-1] - conv.kernel_size[0]) // conv.stride[0] + 1
                        gflop = 2 * N_FRAMES * out * conv.in_channels * conv.out_channels * conv.kernel_size[0] / 1e9
                        row.update(gflop=gflop, tflops=gflop / ms)
                    report["rows"].append(row)
                    print(f"{row['dtype']:8s} benchmark={bench!s:5s} {name:22s} {ms:8.4f} ms"
                          + (f"  {row['gflop']:7.2f} GFLOP {row['tflops']:6.1f} TFLOP/s" if "gflop" in row else ""),
                          flush=True)
            torch.backends.cudnn.benchmark = False
    out = pathlib.Path(__file__).resolve().parents[1] / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "crepe_probe.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
