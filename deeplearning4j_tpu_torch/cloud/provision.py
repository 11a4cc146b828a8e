"""Cluster provisioning script generation (copy of
``deeplearning4j_tpu/cloud/provision.py``; it imports neither JAX nor
torch, and renders the same scripts as the reference).

Reference parity: ``deeplearning4j-aws/ec2/Ec2BoxCreator.java`` +
``ec2/provision/{ClusterSetup,HostProvisioner,
DistributedDeepLearningTrainer}.java`` — which spin up EC2 boxes over the
AWS SDK and push the Akka runtime onto them over jsch/ssh.

The equivalent here is declarative: a pod spec renders to gcloud scripts
the operator runs (we GENERATE the commands, we never call the cloud).
The launch script starts the SAME training entry point on every host
with the ``DL4J_TPU_*`` coordinator trio exported, which the port's
``cli.py train`` reads through ``parallel/multihost.resolve_cluster_config``
and joins with ``torch.distributed`` (the reference's master-URL cluster
join).
"""

from __future__ import annotations

import dataclasses
import shlex
from typing import Dict, List, Optional

# The wiring trio's single source of truth is
# ``parallel/multihost.py`` (``ENV_COORDINATOR`` etc. there): these
# scripts EXPORT the same names ``resolve_cluster_config`` consumes, and
# the cli.py launcher flags override them per field (flags > env).
# Spelled as LITERALS here so this shell-script renderer stays importable
# without torch (an operator laptop rendering launch scripts shouldn't
# need a working accelerator stack); tests/test_torch_periphery.py
# asserts the two spellings never drift.
ENV_COORDINATOR = "DL4J_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "DL4J_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "DL4J_TPU_PROCESS_ID"


@dataclasses.dataclass(frozen=True)
class TpuPodSpec:
    """What the reference's ClusterSetup took as worker count/AMI, as a TPU
    pod: accelerator type encodes chips, hosts derive from topology."""

    name: str = "dl4j-tpu"
    accelerator_type: str = "v5litepod-8"      # e.g. v5litepod-64 for pods
    zone: str = "us-central1-a"
    runtime_version: str = "v2-alpha-tpuv5-lite"
    project: Optional[str] = None
    network: Optional[str] = None
    preemptible: bool = False
    env: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def n_hosts(self) -> int:
        """v5e packs 8 chips/host: v5litepod-N => max(N//8, 1) hosts."""
        try:
            chips = int(self.accelerator_type.rsplit("-", 1)[1])
        except (IndexError, ValueError):
            return 1
        return max(chips // 8, 1)


def render_create_script(spec: TpuPodSpec) -> str:
    """gcloud bring-up (Ec2BoxCreator.create equivalent)."""
    args = [
        "gcloud", "compute", "tpus", "tpu-vm", "create", spec.name,
        f"--zone={spec.zone}",
        f"--accelerator-type={spec.accelerator_type}",
        f"--version={spec.runtime_version}",
    ]
    if spec.project:
        args.append(f"--project={spec.project}")
    if spec.network:
        args.append(f"--network={spec.network}")
    if spec.preemptible:
        args.append("--preemptible")
    return "#!/usr/bin/env bash\nset -euo pipefail\n" + \
        " ".join(shlex.quote(a) for a in args) + "\n"


def render_launch_script(spec: TpuPodSpec, train_cmd: str,
                         coordinator_port: int = 8476) -> str:
    """Run ``train_cmd`` on EVERY host (HostProvisioner/
    DistributedDeepLearningTrainer equivalent).  gcloud's --worker=all is
    the jsch loop; process wiring comes from the DL4J_TPU_* env vars
    consumed by parallel/multihost.resolve_cluster_config (exercised for
    real by the executable localhost simulation,
    render_local_launch_script)."""
    exports = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in spec.env.items())
    # the wiring trio resolve_cluster_config consumes, derived on each host
    # from the TPU-VM environment (worker 0's hostname is the
    # coordinator; TPU_WORKER_ID is this host's rank) — expanded by the
    # REMOTE shell, which is why the $ stays quoted here
    wiring = (f'export {ENV_COORDINATOR}='
              f'"${{TPU_WORKER_HOSTNAMES%%,*}}:{coordinator_port}" '
              f'{ENV_NUM_PROCESSES}={spec.n_hosts} '
              f'{ENV_PROCESS_ID}="${{TPU_WORKER_ID}}"')
    inner = f"{wiring}; {exports} {train_cmd}".strip()
    args = [
        "gcloud", "compute", "tpus", "tpu-vm", "ssh", spec.name,
        f"--zone={spec.zone}", "--worker=all",
        f"--command={inner}",
    ]
    if spec.project:
        args.insert(6, f"--project={spec.project}")
    return ("#!/usr/bin/env bash\nset -euo pipefail\n"
            f"# {spec.n_hosts} host(s), {spec.accelerator_type}\n"
            + " ".join(shlex.quote(a) for a in args) + "\n")


def render_local_launch_script(spec: TpuPodSpec, train_cmd: str,
                               coordinator_port: int = 8476) -> str:
    """Localhost SIMULATION of the pod launch that actually executes: one
    process per pod host, each exported the same
    ``DL4J_TPU_COORDINATOR``/``NUM_PROCESSES``/``PROCESS_ID`` wiring the
    real per-host command gets, so ``cli.py train`` forms a real
    ``torch.distributed`` cluster.  This is the zero-egress stand-in for
    the reference's jsch provisioner smoke-run (HostProvisioner connects
    to real boxes; we connect the processes locally) — and the e2e test
    executes this generated script."""
    n = spec.n_hosts
    env = dict(spec.env)
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
    lines = [
        "#!/usr/bin/env bash",
        "set -euo pipefail",
        f"# localhost simulation of {n} pod host(s), "
        f"{spec.accelerator_type}",
        f"COORD=\"127.0.0.1:{coordinator_port}\"",
        "pids=()",
        f"for p in $(seq 0 {n - 1}); do",
        # user env first: the per-process wiring must always win
        f"  env {exports} {ENV_COORDINATOR}=\"$COORD\" "
        f"{ENV_NUM_PROCESSES}={n} {ENV_PROCESS_ID}=$p "
        f"{train_cmd} &",
        "  pids+=($!)",
        "done",
        "rc=0",
        "for p in \"${pids[@]}\"; do wait \"$p\" || rc=$?; done",
        "exit $rc",
    ]
    return "\n".join(lines) + "\n"


def render_teardown_script(spec: TpuPodSpec) -> str:
    args = ["gcloud", "compute", "tpus", "tpu-vm", "delete", spec.name,
            f"--zone={spec.zone}", "--quiet"]
    if spec.project:
        args.append(f"--project={spec.project}")
    return "#!/usr/bin/env bash\nset -euo pipefail\n" + \
        " ".join(shlex.quote(a) for a in args) + "\n"


def write_cluster_scripts(spec: TpuPodSpec, train_cmd: str,
                          directory: str) -> List[str]:
    """ClusterSetup equivalent: create/launch/teardown scripts on disk."""
    import os
    import stat

    os.makedirs(directory, exist_ok=True)
    out = []
    for name, content in [
            ("create.sh", render_create_script(spec)),
            ("launch.sh", render_launch_script(spec, train_cmd)),
            ("launch_local_sim.sh",
             render_local_launch_script(spec, train_cmd)),
            ("teardown.sh", render_teardown_script(spec))]:
        path = os.path.join(directory, name)
        with open(path, "w") as fh:
            fh.write(content)
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR)
        out.append(path)
    return out
