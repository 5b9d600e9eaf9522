"""The port's process launcher (port of the ``--fleet-worker`` dispatch of
``deeplearning4j_tpu/parallel/main.py``).

``python -m deeplearning4j_tpu_torch.parallel.main --fleet-worker
--device cuda [--rank R --model lstm --store-dir D --cache-root C]``
runs one serving-fleet worker (:func:`~deeplearning4j_tpu_torch.serving.
fleet.fleet_worker_main`); ``FleetRouter`` spawns it.  The JAX launcher's
other modes (the ``ParallelWrapper`` CLI, the pod launcher
``--spawn-local`` and the pod worker ``--pod-worker``/``--coordinator``)
wait for the parallel tier (ROADMAP A9) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    argv_list = list(sys.argv[1:] if argv is None else argv)
    if "--fleet-worker" in argv_list:
        from ..serving.fleet import fleet_worker_main
        return fleet_worker_main(argv_list)
    raise NotImplementedError(
        "only --fleet-worker is ported; the ParallelWrapper CLI and the pod "
        "launcher (--spawn-local, --pod-worker, --coordinator) wait for "
        "the parallel tier (ROADMAP A9)")


if __name__ == "__main__":
    sys.exit(main())
