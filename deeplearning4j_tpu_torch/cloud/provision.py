"""Pod cluster provisioning (port of ``deeplearning4j_tpu/cloud/
provision.py``).

Reference: ``aws/ec2/provision/ClusterSetup.java`` (spin N EC2 boxes,
SSH-provision each with ``HostProvisioner``), ``Ec2BoxCreator.java``.
The equivalent does not create machines (the platform allocates them); it
emits the per-host bootstrap that makes N hosts one training cluster: the
coordinator and process topology as environment exports, and a launch
script per host (the ``HostProvisioner`` role, minus SSH: the operator's
scheduler ships the script).

The variables are the JAX package's (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``), which the port's
``parallel.mesh.resolve_topology`` and ``scaleout.dcn`` read, so
``cluster.json`` and ``launch_host{i}.sh`` are the JAX provisioner's byte
for byte.  The class keeps its JAX name, ``TpuPodProvisioner``; the
command it launches is any entry point of the port, e.g. the pod worker
``python -m deeplearning4j_tpu_torch.parallel.main --pod-worker``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional


class TpuPodProvisioner:
    """Emit per-host launch material for an N-host pod.

    Parameters mirror the cluster-shape flags of the reference's
    ``ClusterSetup`` CLI (worker count, sizes) rebased onto pods:
    ``num_hosts``, ``coordinator_host`` (host 0's address),
    ``coordinator_port``, ``command`` (the training entry point to run on
    every host).
    """

    def __init__(self, num_hosts: int, coordinator_host: str,
                 coordinator_port: int = 8476,
                 command: str = "python train.py",
                 env: Optional[Dict[str, str]] = None):
        if num_hosts < 1:
            raise ValueError("num_hosts must be >= 1")
        self.num_hosts = num_hosts
        self.coordinator_host = coordinator_host
        self.coordinator_port = coordinator_port
        self.command = command
        self.env = dict(env or {})

    @property
    def coordinator_address(self) -> str:
        return f"{self.coordinator_host}:{self.coordinator_port}"

    def host_env(self, process_id: int) -> Dict[str, str]:
        """Environment for host ``process_id``: exactly the variables
        ``parallel.mesh.resolve_topology`` and
        ``scaleout.dcn.initialize_from_env`` consume."""
        if not 0 <= process_id < self.num_hosts:
            raise ValueError(f"process_id {process_id} out of range "
                             f"[0, {self.num_hosts})")
        env = {
            "COORDINATOR_ADDRESS": self.coordinator_address,
            "NUM_PROCESSES": str(self.num_hosts),
            "PROCESS_ID": str(process_id),
        }
        env.update(self.env)
        return env

    def launch_script(self, process_id: int) -> str:
        """One host's bootstrap script (the ``HostProvisioner`` payload)."""
        import shlex
        lines = ["#!/bin/sh", "set -eu"]
        for k, v in sorted(self.host_env(process_id).items()):
            lines.append(f"export {k}={shlex.quote(str(v))}")
        lines.append(f"exec {self.command}")
        return "\n".join(lines) + "\n"

    def cluster_spec(self) -> dict:
        """Machine-readable cluster description (the reference's instance-
        id bookkeeping equivalent)."""
        return {
            "coordinator_address": self.coordinator_address,
            "num_processes": self.num_hosts,
            "hosts": [{"process_id": i, "env": self.host_env(i)}
                      for i in range(self.num_hosts)],
            "command": self.command,
        }

    def write(self, out_dir: str) -> List[str]:
        """Write ``cluster.json`` + ``launch_host{i}.sh`` to ``out_dir``."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        spec_path = os.path.join(out_dir, "cluster.json")
        with open(spec_path, "w", encoding="utf-8") as f:
            json.dump(self.cluster_spec(), f, indent=2)
        paths.append(spec_path)
        for i in range(self.num_hosts):
            p = os.path.join(out_dir, f"launch_host{i}.sh")
            with open(p, "w", encoding="utf-8") as f:
                f.write(self.launch_script(i))
            os.chmod(p, 0o755)
            paths.append(p)
        return paths
