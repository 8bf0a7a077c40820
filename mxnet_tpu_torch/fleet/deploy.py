"""Rolling weight-reload deploys with SLO-gated automatic rollback.

A copy of the reference's ``mxnet_tpu/fleet/deploy.py`` over the port's
telemetry and flight recorder; its slots are replaced through the
port's ``Supervisor.replace_slot``.

The deploy half of the fleet control plane (``autoscaler.py`` is the
scaling half): given a *factory* that spawns replicas on the new
checkpoint, replace the fleet's slots drain-by-drain — one slot at a
time per role, riding ``Supervisor.replace_slot``'s ``_rolling``
exclusive claim so a deploy never races the crash monitor — and gate
every replacement behind a **token-parity probe**: a canary prompt
set served greedily by the old fleet before the rollout starts, then
re-served by each replacement directly after it spawns.  A
weight-*reload* (re-exported/re-sharded checkpoint, config rollout of
identical weights) must serve byte-identical tokens; a mismatch means
the new checkpoint is NOT the weights it claims to be, and the whole
rollout rolls back automatically.  The second rollback trigger is the
SLO plane: any burn-rate alert firing mid-rollout aborts and restores
the old factory the same way.

Per-role canary signatures:

  both     POST /generate          -> greedy token lists
  decode   POST /handoff (no KV)   -> degrades to recompute-from-
                                      prompt, returns token lists
  prefill  POST /generate          -> handoff envelope; the signature
                                      is the per-record KV payload
                                      digests (weight-dependent —
                                      prefill replicas never emit
                                      client tokens)

Old and new versions COEXIST mid-rollout — the router already
tolerates mixed fleets (membership-driven, per-replica scrape), and
``/fleetz`` surfaces per-slot ``version`` so an operator watching
``tools/fleet_report.py`` sees the rollout front move.  Rollback
replays the same drain-by-drain replacement with the old factory, so
it is exactly as zero-downtime as the rollout itself.

Counters: ``mxtpu_deploy_slots_replaced_total`` /
``mxtpu_deploy_rollbacks_total``; every replacement and rollback also
lands on the collector timeline and flight-dumps the telemetry ring.

Env knobs: ``MXTPU_DEPLOY_CANARY_NEW`` (canary max_new_tokens, 8) and
``MXTPU_DEPLOY_PROBE_TIMEOUT`` (per-probe HTTP timeout seconds, 30).
"""

from __future__ import annotations

import json
import time
import urllib.request

from .. import telemetry
from ..base import env_float, env_int
from ..telemetry import flight as flight_mod

__all__ = ["Deployer", "ENV_CANARY_NEW", "ENV_PROBE_TIMEOUT"]

ENV_CANARY_NEW = "MXTPU_DEPLOY_CANARY_NEW"
ENV_PROBE_TIMEOUT = "MXTPU_DEPLOY_PROBE_TIMEOUT"

# small deterministic default canary set (token ids valid for every
# vocab the smoke models use); callers with a real tokenizer pass
# their own prompts
_DEFAULT_CANARY = ((1, 2, 3, 4), (5, 3, 7), (2, 9, 4, 6, 8))


def _post_json(url, path, body, timeout_s):
    req = urllib.request.Request(
        f"{url.rstrip('/')}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read())


class Deployer:
    """Rolling weight-reload over one or more role pools.

    Args:
      supervisors: ``{role: Supervisor}`` (a bare ``Supervisor`` is
        accepted as ``{"both": sup}``) — the pools to roll.
      collector: optional ``FleetCollector`` — supplies the SLO
        burn-rate rollback trigger and the timeline annotations.
      canary_prompts: token-id lists for the parity probe (default: a
        small deterministic built-in set).
      canary_max_new: greedy tokens per canary prompt
        (``MXTPU_DEPLOY_CANARY_NEW``, 8).
      probe_timeout_s: per-probe HTTP timeout
        (``MXTPU_DEPLOY_PROBE_TIMEOUT``, 30).
      clock: injectable monotonic clock (tests).
    """

    def __init__(self, supervisors, collector=None,
                 canary_prompts=None, canary_max_new=None,
                 probe_timeout_s=None, clock=time.monotonic):
        if hasattr(supervisors, "add_slot"):   # a bare Supervisor
            supervisors = {"both": supervisors}
        self.pools = dict(supervisors)
        self.collector = collector
        self.canary_prompts = tuple(
            tuple(p) for p in (canary_prompts or _DEFAULT_CANARY))
        self.canary_max_new = (
            int(canary_max_new) if canary_max_new is not None
            else env_int(ENV_CANARY_NEW, 8))
        self.probe_timeout_s = (
            float(probe_timeout_s) if probe_timeout_s is not None
            else env_float(ENV_PROBE_TIMEOUT, 30.0))
        self.clock = clock
        self._m_replaced = telemetry.counter(
            "mxtpu_deploy_slots_replaced_total",
            "slots moved to a new version by rolling deploys")
        self._m_rollbacks = telemetry.counter(
            "mxtpu_deploy_rollbacks_total",
            "rolling deploys aborted and rolled back")

    # -- probes --------------------------------------------------------------
    def probe(self, url, role):
        """The canary signature of one replica: a tuple per canary
        prompt — greedy tokens ("both"/"decode") or the handoff
        envelope's per-record KV digests ("prefill").  Raises
        ``OSError``/``ValueError`` when the replica cannot answer —
        an unanswerable replacement fails the gate."""
        sig = []
        for prompt in self.canary_prompts:
            body = {"prompt": list(prompt),
                    "max_new_tokens": self.canary_max_new}
            if role == "decode":
                # a decode-role replica only serves /handoff; with no
                # KV records it degrades to recompute-from-prompt and
                # returns tokens — exactly the weight probe we need
                body["records"] = []
                payload = _post_json(url, "/handoff", body,
                                     self.probe_timeout_s)
            else:
                payload = _post_json(url, "/generate", body,
                                     self.probe_timeout_s)
            if role == "prefill":
                recs = (payload.get("handoff") or {}).get(
                    "records") or ()
                if not recs:
                    raise ValueError("prefill canary exported no "
                                     "KV records")
                sig.append(tuple(r.get("digest") for r in recs))
            else:
                tokens = payload.get("tokens")
                if not tokens:
                    raise ValueError(f"canary returned no tokens: "
                                     f"{payload.get('error')}")
                sig.append(tuple(tokens))
        return sig

    def _reference(self):
        """Probe ONE live replica per pool before anything is
        replaced — the old version's canary signature that every
        replacement must match."""
        refs = {}
        for role, sup in self.pools.items():
            for slot in sup.active_slots():
                h = sup.handles()[slot]
                if h is not None and h.url:
                    refs[role] = self.probe(h.url, role)
                    break
        return refs

    def _burning(self):
        """True when any SLO objective is firing right now — the
        burn-rate rollback trigger (False without an SLO plane)."""
        if self.collector is None or self.collector.slo is None:
            return False
        try:
            return any(o.get("firing") for o in
                       self.collector.slo.statusz().get(
                           "objectives") or ())
        # mxtpu-lint: disable=swallowed-exception (a broken SLO
        # evaluator must not be able to veto OR force a rollback; the
        # parity gate still protects the rollout)
        except Exception:
            return False

    def _annotate(self, kind, **fields):
        if self.collector is None:
            return
        try:
            self.collector.annotate(kind, **fields)
        # mxtpu-lint: disable=swallowed-exception (the timeline is
        # observability; it must never abort a rollout step)
        except Exception:
            pass

    # -- the rollout ---------------------------------------------------------
    def rollout(self, factory, version=None, old_factory=None):
        """Roll every pool onto ``factory`` (``factory(slot) ->
        handle`` on the new checkpoint), one slot at a time per role,
        parity-probing each replacement; on a parity failure, an
        unanswerable replacement, or an SLO burn alert, roll every
        already-replaced slot back via ``old_factory`` (default: each
        supervisor's own spawn — the old version).  Returns a report
        dict (``status`` "ok" | "rolled_back")."""
        t0 = self.clock()
        report = {"version": version, "status": "ok", "reason": None,
                  "replaced": 0, "rolled_back": 0, "refs": {}}
        self._annotate("deploy_rollout", phase="start",
                       version=version)
        refs = self._reference()
        report["refs"] = {role: len(sig) for role, sig in refs.items()}
        replaced = []                   # (role, sup, slot) — in order
        failure = None
        for role, sup in self.pools.items():
            if failure:
                break
            ref = refs.get(role)
            for slot in sup.active_slots():
                handle = sup.replace_slot(slot, factory,
                                          reason="deploy")
                replaced.append((role, sup, slot))
                if handle is None or not handle.url:
                    failure = "spawn_failed"
                else:
                    self._m_replaced.inc()
                    report["replaced"] += 1
                    try:
                        sig = self.probe(handle.url, role)
                        if ref is not None and sig != ref:
                            failure = "parity"
                    except (OSError, ValueError):
                        failure = "probe_error"
                if failure is None and self._burning():
                    failure = "slo_burn"
                self._annotate("deploy_slot", role=role, slot=slot,
                               version=version,
                               ok=failure is None,
                               reason=failure)
                if failure:
                    break
        if failure:
            self._m_rollbacks.inc()
            report["status"] = "rolled_back"
            report["reason"] = failure
            self._annotate("deploy_rollback", phase="start",
                           reason=failure, version=version)
            flight_mod.recorder().dump(
                f"deploy_rollback_{failure}",
                extra={"version": version, "reason": failure,
                       "replaced": report["replaced"]})
            for role, sup, slot in replaced:
                sup.replace_slot(slot, old_factory, reason="rollback")
                report["rolled_back"] += 1
            self._annotate("deploy_rollback", phase="done",
                           slots=report["rolled_back"],
                           version=version)
        self._annotate("deploy_rollout", phase="done",
                       status=report["status"], version=version,
                       wall_s=round(self.clock() - t0, 3))
        flight_mod.recorder().dump(
            f"deploy_{report['status']}",
            extra={"version": version, "status": report["status"],
                   "replaced": report["replaced"]})
        return report
