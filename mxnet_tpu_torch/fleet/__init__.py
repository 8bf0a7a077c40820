"""Fleet layer: one engine process -> a service that survives losing it.

The port of ``mxnet_tpu.fleet`` (replica/router core, sensor plane and
control plane) over the port's engine (torch, numpy and the standard
library only; no HTTP path initialises CUDA):

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
- ``autoscaler`` — ``Autoscaler``: the control plane's policy loop,
  scaling each role's ``Supervisor`` pool on the collector's role
  aggregates and SLO burns (``MXTPU_AUTOSCALE_SPEC``,
  ``parse_autoscale_spec``), with hysteresis and per-role cooldowns.
- ``deploy``    — ``Deployer``: rolling weight-reload deploys through
  ``Supervisor.replace_slot``, each replacement gated by a canary
  token-parity probe, the whole rollout rolled back on a parity
  failure, an unanswerable replacement or an SLO burn.
- ``catalog``   — ``CatalogRebalancer``: adapter placement follows
  traffic (``/adapter_export`` -> ``/load_adapter``,
  ``/unload_adapter``), behind ``Supervisor(catalog=)``'s
  ``rebalance_catalog``.
"""

from .autoscaler import Autoscaler, parse_autoscale_spec
from .catalog import CatalogRebalancer
from .collector import FleetCollector
from .deploy import Deployer
from .faults import Fault, FaultInjector, parse_fault_spec
from .replica import (DEAD, DRAINING, READY, ROLES, STARTING,
                      ReplicaServer, TRACE_HEADER)
from .router import (FleetError, NoReplicaAvailable, PermanentError,
                     Router, RouterResult)
from .slo import Objective, SLOEvaluator, parse_slo_spec
from .supervisor import ProcessReplica, Supervisor, probe_health

__all__ = ["ReplicaServer", "Router", "RouterResult", "Supervisor",
           "ProcessReplica", "Autoscaler", "parse_autoscale_spec",
           "Deployer", "CatalogRebalancer", "FleetCollector",
           "SLOEvaluator", "Objective", "parse_slo_spec", "FaultInjector",
           "Fault", "parse_fault_spec", "probe_health", "FleetError",
           "PermanentError", "NoReplicaAvailable", "TRACE_HEADER",
           "ROLES", "STARTING", "READY", "DRAINING", "DEAD"]
