"""Fleet layer: one engine process -> a service that survives losing it.

The port of ``mxnet_tpu.fleet``'s replica/router core and sensor plane,
over the port's engine (torch, numpy and the standard library only; no
HTTP path initialises CUDA):

- ``replica``   — ``ReplicaServer``: a stdlib-HTTP front over one
  ``serve.Engine`` (``/generate``, ``/healthz``, ``/drain``,
  ``/statusz.json``, ``/metrics``, ``/flight_dump``, ``/profilez``,
  ``/handoff``, ``/handoff_probe``, ``/chain_export``, the adapter
  catalog endpoints), idempotent on client request ids, with the roles
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
- ``collector`` — ``FleetCollector``: scrapes every replica's
  ``/statusz.json`` + ``/metrics`` into per-replica time series,
  aggregates a role-keyed view at ``GET /fleetz`` (+``.json``),
  receives pushed request traces on ``POST /trace``, annotates the
  fleet timeline and opens ``/profilez`` windows fleet-wide
  (``capture_fleet``).
- ``slo``       — ``SLOEvaluator``: declarative objectives
  (``MXTPU_SLO_SPEC``) with multi-window burn-rate alerts whose fast
  burn captures a device trace on the offending replica and chains its
  id into that replica's flight dump.

Not ported yet, raising on access with their ROADMAP item 14b-3:
``Autoscaler`` (``parse_autoscale_spec``), ``Deployer`` and
``CatalogRebalancer``.
"""

from .collector import FleetCollector
from .faults import Fault, FaultInjector, parse_fault_spec
from .replica import (DEAD, DRAINING, READY, ROLES, STARTING,
                      ReplicaServer, TRACE_HEADER)
from .router import (FleetError, NoReplicaAvailable, PermanentError,
                     Router, RouterResult)
from .slo import Objective, SLOEvaluator, parse_slo_spec
from .supervisor import ProcessReplica, Supervisor, probe_health

__all__ = ["ReplicaServer", "Router", "RouterResult", "Supervisor",
           "ProcessReplica", "FleetCollector", "SLOEvaluator",
           "Objective", "parse_slo_spec", "FaultInjector", "Fault",
           "parse_fault_spec", "probe_health", "FleetError",
           "PermanentError", "NoReplicaAvailable", "TRACE_HEADER",
           "ROLES", "STARTING", "READY", "DRAINING", "DEAD"]

# the reference's fleet names that wait for later ROADMAP items
_UNPORTED = {"Autoscaler": "14b-3", "parse_autoscale_spec": "14b-3",
             "Deployer": "14b-3", "CatalogRebalancer": "14b-3"}


def __getattr__(name):
    item = _UNPORTED.get(name)
    if item is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    raise NotImplementedError(
        f"mxnet_tpu_torch.fleet.{name} is not ported yet "
        f"(ROADMAP §A item {item})")
