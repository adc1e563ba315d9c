"""Paged-KV serving: block allocator, sampling, the continuous-batching
engine, the replica fleet with its lifecycle, the admission gateway and the
OpenAI-compatible HTTP server."""

from dlti_tpu_torch.serving.block_manager import BlockManager  # noqa: F401
from dlti_tpu_torch.serving.sampling import SamplingParams, sample_tokens  # noqa: F401
from dlti_tpu_torch.serving.engine import (  # noqa: F401
    EngineConfig,
    GenerationResult,
    InferenceEngine,
    NumericFault,
    Request,
)
from dlti_tpu_torch.serving.gateway import AdmissionError, AdmissionGateway  # noqa: F401
from dlti_tpu_torch.serving.replicas import ReplicatedEngine  # noqa: F401
from dlti_tpu_torch.serving.server import (  # noqa: F401
    ServerConfig,
    make_server,
    serve,
)
