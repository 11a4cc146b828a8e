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
(``expert.py``), the elastic re-mesh over the survivors of a loss
(``mesh.py``), the multi-process control plane (``multihost.py``'s
launcher, ``Cluster`` and ``HostHeartbeat``) and ``chaos.py``'s serving
and training injectors.  The multi-host data plane (ROADMAP A7.4) and the
scale-out runner with its chaos performer (A7.6) are not."""

from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, MeshSpec,
    auto_data_mesh, local_batch_size, make_mesh, mesh_signature,
    pad_global_batch,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataParallelTrainer, ParameterAveragingTrainer,
)
