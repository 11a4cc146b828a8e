"""Inference serving (counterpart of ``deeplearning4j_tpu/serving``):
``InferenceEngine`` (engine.py), a shape-bucketed forward with host-side
padding, warmup and optional weight quantization; ``DynamicBatcher``
(batcher.py), which coalesces concurrent requests into micro-batches;
continuous-batching decode serving (decode.py: ``DecodeEngine`` with
paged KV, the prefix store and speculative decoding,
``ContinuousBatcher``); ``Router`` (router.py), least-depth dispatch
over replicas with load shedding; and the fleet over it (router.py):
``AutoscalingRouter`` driven by an ``AutoscalePolicy``, the hot weight
swap (``swap_weights``, ``SwapFailed``), health-checked replacement
(``ReplicaHealth``) and the brownout ladder.  ``chaos_gate.py`` drills
the fleet under ``parallel.chaos.ServingChaos`` faults."""

from deeplearning4j_tpu_torch.serving.batcher import (  # noqa: F401
    DynamicBatcher,
)
from deeplearning4j_tpu_torch.serving.decode import (  # noqa: F401
    KV_PAGE_TOKENS, BatcherClosed, ContinuousBatcher, DeadlineExceeded,
    DecodeEngine, DecodeRequest, KVPagesExhausted, PageAllocator,
    PrefixCache, default_length_buckets,
)
from deeplearning4j_tpu_torch.serving.engine import (  # noqa: F401
    InferenceEngine, default_buckets, pad_rows, pick_bucket,
)
from deeplearning4j_tpu_torch.serving.router import (  # noqa: F401
    AutoscalePolicy, AutoscalingRouter, OverloadedError, ReplicaHealth,
    Router, RouterClosed, SwapFailed,
)
