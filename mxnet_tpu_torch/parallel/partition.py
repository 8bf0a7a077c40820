"""Regex-rule partitioning: ``match_partition_rules`` and the GPT rules.

The port of ``mxnet_tpu/parallel/partition.py``.  Sharding is always
expressed the same way: a dict of parameters, an ordered list of
``(pattern, PartitionSpec)`` rules, and a mesh whose axis names the
specs reference.  The rule matcher walks the parameter names in order
and returns the first matching spec a leaf, keyed off the
``models.gpt()`` checkpoint naming that ``normalize_gpt_params``
guarantees.

Consumer: ``serve.Engine``, whose tensor-parallel serving shards the
gpt() parameter dict with :func:`gpt_partition_rules` (or the operator's
``MXTPU_SERVE_PARTITION_RULES`` override parsed by :func:`parse_rules`)
over a ``{'tp': N}`` mesh, one shard a mesh device
(:func:`named_shardings`).

The default GPT rule set is the weight-stationary Megatron layout (Pope
et al., *Efficiently Scaling Transformer Inference*): attention q/k/v
projections and MLP in-projections split on their output (head /
hidden) dimension, the attention out-projection and the MLP
down-projection on their input dimension (their matmuls give partial
sums, reduced over the shards: two reductions a layer), everything else
(embeddings, norms, the down-projection biases, the LM head)
replicated.  :func:`rules_digest` is computed exactly as the
reference's, so equal rules give equal digests in both packages.
"""

from __future__ import annotations

import hashlib
import json
import re

import numpy as np

from .mesh import NamedSharding, PartitionSpec

__all__ = ["match_partition_rules", "gpt_partition_rules", "parse_rules",
           "rules_digest", "spec_tuple", "named_shardings"]


def spec_tuple(spec):
    """A ``PartitionSpec`` as a JSON-stable tuple (axis entries may be
    None, a name, or a tuple of names)."""
    return tuple(list(e) if isinstance(e, (tuple, list)) else e
                 for e in tuple(spec))


def _matches(pattern, name, mode):
    if mode == "full":
        # ShardedTrainer's historical param_specs contract: a key is an
        # exact parameter name OR a regex that must span the whole name
        return pattern == name or re.fullmatch(pattern, name) is not None
    return re.search(pattern, name) is not None


def match_partition_rules(rules, params, default=PartitionSpec(),
                          mode="search"):
    """Resolve ``rules`` against a parameter dict.

    Args:
      rules: ordered iterable of ``(pattern, PartitionSpec)``; the
        FIRST matching pattern wins.
      params: dict name -> array-like or shape tuple (only ``.shape``
        / the tuple itself is consulted — pass shapes to partition
        before materializing anything).
      default: spec for unmatched leaves — a ``PartitionSpec``, a
        callable ``(name, shape) -> PartitionSpec`` (the trainer's FSDP
        heuristic), or the string ``"raise"`` to make an unmatched
        parameter a hard error (the fmengine contract).
      mode: ``"search"`` (``re.search``, the GSPMD-repo convention) or
        ``"full"`` (exact name or fullmatch — ShardedTrainer
        ``param_specs`` compatibility).

    Returns ``{name: PartitionSpec}``.  Unmatched scalar / one-element
    leaves are always replicated (partitioning them is meaningless);
    an explicit rule still wins over that shortcut, exactly so the
    trainer's behavior is unchanged by the refactor onto this helper.
    """
    rules = list(rules or [])
    out = {}
    for name, leaf in params.items():
        shape = getattr(leaf, "shape", leaf)
        shape = tuple(shape) if shape is not None else ()
        spec = None
        for pattern, ps in rules:
            if _matches(pattern, name, mode):
                spec = ps
                break
        if spec is None:
            if len(shape) == 0 or int(np.prod(shape)) == 1:
                spec = PartitionSpec()
            elif isinstance(default, str) and default == "raise":
                raise ValueError(
                    f"no partition rule matches parameter {name!r} "
                    f"(shape {shape})")
            elif callable(default):
                spec = default(name, shape)
            else:
                spec = default
        out[name] = spec
    return out


def gpt_partition_rules(name="gpt", axis="tp"):
    """Default tensor-parallel rule set for a ``models.gpt()``
    checkpoint normalized by ``normalize_gpt_params``.

    Head-split q/k/v (rows of the (H*Dh, D) projection are heads),
    hidden-split MLP in-projections, input-split out/down projections
    (their partial-sum matmuls are the layer's two reductions over the
    shards), replicated embeddings/norms/LM-head.  The catch-all
    replicate rule is explicit so ``match_partition_rules`` covers
    every leaf without a fallback.
    """
    P = PartitionSpec
    L = rf"{re.escape(name)}_l\d+"
    return [
        (rf"{L}_(q|k|v)_weight$", P(axis, None)),
        (rf"{L}_(q|k|v)_bias$", P(axis)),
        (rf"{L}_proj_weight$", P(None, axis)),
        (rf"{L}_ff_(gate|up)_weight$", P(axis, None)),
        (rf"{L}_ff_(gate|up)_bias$", P(axis)),
        (rf"{L}_ff_down_weight$", P(None, axis)),
        (r".*", P()),     # embeddings, norms, proj/down bias, LM head
    ]


def parse_rules(text):
    """Parse the ``MXTPU_SERVE_PARTITION_RULES`` syntax into rules.

    One rule per ``;``-separated segment: ``<regex>=<spec>`` (split on
    the LAST ``=`` so regexes may contain one), where ``<spec>`` is a
    comma-separated axis entry per array dimension — an axis name, or
    ``-`` for an unsharded dimension.  An empty spec replicates::

        .*_(q|k|v)_weight$=tp,-;.*_proj_weight$=-,tp;.*=

    Returns a list of ``(pattern, PartitionSpec)`` (empty for empty /
    None input — callers fall back to :func:`gpt_partition_rules`).
    """
    rules = []
    for segment in (text or "").split(";"):
        segment = segment.strip()
        if not segment:
            continue
        if "=" not in segment:
            raise ValueError(
                f"bad partition rule {segment!r}: expected <regex>=<spec>")
        pattern, spec_str = segment.rsplit("=", 1)
        pattern = pattern.strip()
        entries = []
        if spec_str.strip():             # empty spec = replicate
            for entry in spec_str.split(","):
                entry = entry.strip()
                if not entry:
                    # a stray comma would silently SHIFT later axis
                    # names onto earlier dimensions — fail fast instead
                    # (unsharded dimensions are spelled '-')
                    raise ValueError(
                        f"bad partition spec {spec_str!r} in rule "
                        f"{segment!r}: empty entry (use '-' for an "
                        "unsharded dimension)")
                entries.append(None if entry == "-" else entry)
        re.compile(pattern)          # fail fast on a broken regex
        rules.append((pattern, PartitionSpec(*entries)))
    return rules


def rules_digest(rules):
    """Stable hex digest of a rule list — the AOT-fingerprint component
    that keys exported artifacts per sharding layout."""
    canon = [[pattern, list(spec_tuple(spec))] for pattern, spec in rules]
    return hashlib.sha256(
        json.dumps(canon, sort_keys=True).encode()).hexdigest()


def named_shardings(mesh, specs):
    """{name: PartitionSpec} -> {name: NamedSharding} on ``mesh``: each
    places its tensor as one shard a mesh device
    (``NamedSharding.place``)."""
    return {name: NamedSharding(mesh, spec) for name, spec in specs.items()}
