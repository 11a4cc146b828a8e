"""Cluster provisioning, config registry, and artifact movement
(counterpart of ``deeplearning4j_tpu/cloud``, exports as its
``__init__.py:11-19``).

``provision.py`` renders the pod bring-up, launch (with the
``DL4J_TPU_*`` coordinator trio the port's ``cli.py train`` reads) and
teardown scripts; ``registry.py`` is the shared config registry;
``artifacts.py`` holds the ``ArtifactStore`` SPI, the directory-backed
``LocalArtifactStore`` with the reference's key layout, and
``RemoteModelSaver``."""

from deeplearning4j_tpu_torch.cloud.provision import (  # noqa: F401
    TpuPodSpec, render_create_script, render_launch_script,
    render_teardown_script,
)
from deeplearning4j_tpu_torch.cloud.registry import ConfigRegistry  # noqa: F401
from deeplearning4j_tpu_torch.cloud.artifacts import (  # noqa: F401
    ArtifactStore, LocalArtifactStore, RemoteModelSaver,
)
