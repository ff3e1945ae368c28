"""smp.resilience of the PyTorch port: preemption checkpointing, elastic
resume, chaos, and in-job failure recovery.

Counterpart of ``smdistributed_modelparallel_tpu/resilience/``:

- ``preemption``: the SIGTERM / ``SMP_PREEMPTION_FILE`` listener whose flag
  the step engine checks at every step edge; a trigger leads to a committed
  emergency partial checkpoint within ``SMP_PREEMPTION_GRACE_SECONDS``
  (``preemption.py``);
- elastic reshard-on-resume (``elastic.py``);
- ``supervisor``: the ``SMP_SUPERVISOR=on`` heartbeat failure detector and
  the shrink-to-survivors recovery protocol (``supervisor.py``); at world
  size 1 it arms no detector;
- ``chaos``: the ``SMP_CHAOS`` deterministic fault injector (``chaos.py``).
"""

from smdistributed_modelparallel_tpu_torch.resilience.chaos import chaos
from smdistributed_modelparallel_tpu_torch.resilience.elastic import (
    classify_mismatches,
)
from smdistributed_modelparallel_tpu_torch.resilience.preemption import preemption
from smdistributed_modelparallel_tpu_torch.resilience.supervisor import supervisor


def reset():
    """Session-teardown hook (``state.reset`` / ``smp.shutdown``): clear
    preemption triggers and chaos rule state, stop the failure detector,
    and give SIGTERM back its previous disposition: ``smp.init`` installs
    the deferring handler, so a process that has shut the session down
    must die normally on TERM instead of flagging an edge no step loop
    will ever reach."""
    preemption.reset()
    preemption.uninstall()
    supervisor.reset()
    chaos.reset()
