"""The serving front doors (counterpart of ``obs_rvc_tpu.serve``):

- :mod:`rpc`            the plugin's reference RPC protocol over stdio or TCP
- :mod:`stream_server`  the tag-framed duplex PCM stream over TCP
- :mod:`ws`             the same protocol over WebSocket
- :mod:`health`         ``/healthz`` and ``/metrics`` over HTTP
- :mod:`server`         one process that brings them up over one pipeline
- :mod:`cli`            offline conversion of a WAV file

Nothing here starts a thread or opens a socket at import time.
"""

from obs_rvc_tpu_torch.serve.metrics import ChunkMetrics

__all__ = ["ChunkMetrics"]
