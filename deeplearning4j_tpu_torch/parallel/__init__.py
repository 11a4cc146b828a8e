"""Data-parallel training and fault injection (counterpart of
``deeplearning4j_tpu/parallel``).

Ported: the data axis of the mesh over a ``torch.distributed`` group
(``mesh.py``), its collectives (``collectives.py``), the sharded-fit step
factories with gradient accumulation and the bf16 loss scale
(``sharded_fit.py``), the gradient-sharing and parameter-averaging
trainers (``data_parallel.py``), the one-device half of the experts
(``expert.py``) and the serving half of ``chaos.py``.  The model, pipe,
seq and expert axes, the multi-host runtime, the scale-out runner and
the training fault injectors are ROADMAP A7."""

from deeplearning4j_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, MeshSpec,
    auto_data_mesh, local_batch_size, make_mesh, mesh_signature,
    pad_global_batch,
)
from deeplearning4j_tpu_torch.parallel.data_parallel import (  # noqa: F401
    DataParallelTrainer, ParameterAveragingTrainer,
)
