"""Context assignment over a Symbol's graph: the port of
``mxnet_tpu/graph.py``'s ``assign_contexts``.

:func:`assign_contexts` maps every node to a Context with the
reference's precedence: explicit ``ctx_group`` attrs resolved through
``group2ctx``, bound-array placements for variables, then forward and
backward propagation along edges, defaulting to the bind context.  The
port runs a graph whose nodes all land on one context as one segment;
:func:`one_context` raises when they span distinct contexts, since
splitting the graph across devices (the reference's ``SegmentedGraph``
with cross-device copies) is ROADMAP §A18.
"""

from __future__ import annotations

__all__ = ["assign_contexts", "one_context"]


def assign_contexts(symbol, default_ctx, group2ctx=None, var_ctx=None):
    """Per-node Context assignment (graph_executor.cc:391-508 precedence).

    Returns dict id(node) -> Context.
    """
    topo = symbol._topo()
    group2ctx = group2ctx or {}
    var_ctx = var_ctx or {}
    ctx_of = {}
    for node in topo:
        grp = node.attrs.get("ctx_group")
        if grp and grp in group2ctx:
            ctx_of[id(node)] = group2ctx[grp]
        elif node.is_variable and node.name in var_ctx:
            ctx_of[id(node)] = var_ctx[node.name]
    changed = True
    while changed:
        changed = False
        # forward: inherit first known input context
        for node in topo:
            if id(node) in ctx_of:
                continue
            for src, _ in node.inputs:
                if id(src) in ctx_of:
                    ctx_of[id(node)] = ctx_of[id(src)]
                    changed = True
                    break
        # backward: producers inherit consumer context
        for node in reversed(topo):
            if id(node) not in ctx_of:
                continue
            for src, _ in node.inputs:
                if id(src) not in ctx_of:
                    ctx_of[id(src)] = ctx_of[id(node)]
                    changed = True
    for node in topo:
        ctx_of.setdefault(id(node), default_ctx)
    return ctx_of


def one_context(ctx_of):
    """The one Context of an assignment; raises ``NotImplementedError``
    (ROADMAP §A18) when the graph spans distinct contexts."""
    distinct = set(ctx_of.values())
    if len(distinct) > 1:
        raise NotImplementedError(
            f"a graph over distinct contexts {sorted(map(str, distinct))} "
            "(model parallelism across devices) is not ported yet "
            "(ROADMAP §A18)")
    return next(iter(distinct))
