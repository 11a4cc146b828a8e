"""Data-, tensor-, pipeline-, sequence- and expert-parallel training and
fault injection (counterpart of ``deeplearning4j_tpu/parallel``).

Ported: every axis of the mesh (data, model, pipe, seq, expert) over a
``torch.distributed`` group (``mesh.py``), their collectives
(``collectives.py``, the ring shift among them), the model axis's
hand-written collectives and layout helpers (``tensor_parallel.py``, no
reference counterpart: GSPMD inserts them there), the GPipe pipeline
(``pipeline.py``), ring and Ulysses attention (``ring_attention.py``),
the sharded-fit step factories with gradient accumulation and the bf16
loss scale (``sharded_fit.py``), the gradient-sharing and
parameter-averaging trainers (``data_parallel.py``), the experts
(``expert.py``) and the serving half of ``chaos.py``.  The elastic
re-mesh (ROADMAP A7.3), the multi-host runtime (A7.4), the scale-out
runner and the training fault injectors (A7) are not."""

from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, MeshSpec,
    auto_data_mesh, local_batch_size, make_mesh, mesh_signature,
    pad_global_batch,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataParallelTrainer, ParameterAveragingTrainer,
)
