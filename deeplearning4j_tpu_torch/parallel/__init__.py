"""Data- and tensor-parallel training and fault injection (counterpart
of ``deeplearning4j_tpu/parallel``).

Ported: the data and model axes of the mesh over a
``torch.distributed`` group (``mesh.py``), their collectives
(``collectives.py``), the model axis's hand-written collectives and
layout helpers (``tensor_parallel.py``, no reference counterpart: GSPMD
inserts them there), the sharded-fit step factories with gradient
accumulation and the bf16 loss scale (``sharded_fit.py``), the
gradient-sharing and parameter-averaging trainers
(``data_parallel.py``), the one-device half of the experts
(``expert.py``) and the serving half of ``chaos.py``.  The pipe and
expert axes (ROADMAP A7.1b), the seq axis (A7.5), the multi-host
runtime, the scale-out runner and the training fault injectors (A7) are
not."""

from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, MeshSpec,
    auto_data_mesh, local_batch_size, make_mesh, mesh_signature,
    pad_global_batch,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataParallelTrainer, ParameterAveragingTrainer,
)
