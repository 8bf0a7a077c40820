"""Fleet layer: one engine process -> a service that survives losing it.

The port of ``mxnet_tpu.fleet``'s replica/router core, over the port's
engine (torch, numpy and the standard library only; no HTTP path
initialises CUDA):

- ``replica``   — ``ReplicaServer``: a stdlib-HTTP front over one
  ``serve.Engine`` (``/generate``, ``/healthz``, ``/drain``,
  ``/statusz.json``, ``/metrics``, ``/flight_dump``, ``/handoff``,
  ``/handoff_probe``, ``/chain_export``, the adapter catalog
  endpoints), idempotent on client request ids, with the roles
  ``both`` / ``prefill`` / ``decode`` (``MXTPU_FLEET_ROLE``) and the
  wire records of a prefill->decode handoff or a peer pull.
- ``router``    — ``Router``: least-loaded routing on scraped statusz
  signals, per-hop timeout, capped exponential backoff,
  retry-on-sibling, per-replica circuit breaker, end-to-end deadlines,
  trace-id propagation, handoff orchestration and, with
  ``MXTPU_ROUTE_AFFINITY`` > 0, cache-aware routing on each replica's
  advertised ``RadixSummary`` with peer pull hints.
- ``supervisor``— ``Supervisor``: spawn/monitor/restart N replica
  slots, crash-restart with backoff, drain -> warm restart, rolling
  restarts, pool resizing; ``ProcessReplica`` runs the process front.
- ``serve_replica`` — the process front,
  ``python -m mxnet_tpu_torch.fleet.serve_replica``.
- ``faults``    — ``FaultInjector``: the deterministic chaos hook
  (``MXTPU_FAULT_SPEC``: kill/delay/refuse/hang at request k).

Not ported yet, raising on access with their ROADMAP items:
``FleetCollector``, ``SLOEvaluator`` (and ``Objective``,
``parse_slo_spec``) and ``/profilez`` are item 14b-2; ``Autoscaler``
(``parse_autoscale_spec``), ``Deployer`` and ``CatalogRebalancer`` are
item 14b-3.
"""

from .faults import Fault, FaultInjector, parse_fault_spec
from .replica import (DEAD, DRAINING, READY, ROLES, STARTING,
                      ReplicaServer, TRACE_HEADER)
from .router import (FleetError, NoReplicaAvailable, PermanentError,
                     Router, RouterResult)
from .supervisor import ProcessReplica, Supervisor, probe_health

__all__ = ["ReplicaServer", "Router", "RouterResult", "Supervisor",
           "ProcessReplica", "FaultInjector", "Fault",
           "parse_fault_spec", "probe_health", "FleetError",
           "PermanentError", "NoReplicaAvailable", "TRACE_HEADER",
           "ROLES", "STARTING", "READY", "DRAINING", "DEAD"]

# the reference's fleet names that wait for later ROADMAP items
_UNPORTED = {"FleetCollector": "14b-2", "SLOEvaluator": "14b-2",
             "Objective": "14b-2", "parse_slo_spec": "14b-2",
             "Autoscaler": "14b-3", "parse_autoscale_spec": "14b-3",
             "Deployer": "14b-3", "CatalogRebalancer": "14b-3"}


def __getattr__(name):
    item = _UNPORTED.get(name)
    if item is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    raise NotImplementedError(
        f"mxnet_tpu_torch.fleet.{name} is not ported yet "
        f"(ROADMAP §A item {item})")
