"""Topology generator library for sweep scenarios.

Scenarios are no longer limited to hand-built graphs or checked-in
GraphML: every generator here emits a network graph that
:meth:`repro_torch.core.spec.PipelineSpec.from_topology` consumes directly.

Generator contract (the determinism half is what the sweep runner's
content-hash cache relies on — see ``tests/test_topologies.py``):

- signature ``gen(n_hosts, *, seed=0, **kw) -> nx.Graph``;
- node attribute ``kind`` is ``"host"`` or ``"switch"``;
- edge attribute ``cfg`` is a valid :class:`~repro_torch.core.netem.LinkCfg`
  (positive latency and bandwidth, ``0 <= loss < 100``);
- ``g.graph["hosts"]`` lists hosts in deterministic creation order
  (component placement walks this list);
- the graph is connected, and a fixed ``(n_hosts, seed, kwargs)``
  reproduces the *identical* graph — nodes, edges and link attributes,
  **and node insertion order**: the vectorized routing tables in
  ``repro_torch.core.netem`` assign each node the dense integer index of its
  insertion position (see :func:`node_index`), so reordering node
  creation would shuffle the sweep runner's content-hash cache even
  though routing itself is order-independent.

Generators:

``star``      all hosts on one switch (the paper's Fig. 2 abstraction)
``chain``     hosts hanging off a linear switch backbone
``tree``      balanced switch tree, hosts round-robin on the leaves
``fat_tree``  k-ary fat-tree (core/aggregation/edge) sized to n_hosts
``geo_wan``   random geographic WAN: sites uniform in a square, MST
              backbone plus shortcut edges, latency from link distance;
              ``core_frac > 0`` adds a heterogeneous two-tier model
              (provisioned core fiber vs bandwidth/latency-drawn access
              links)
"""
from __future__ import annotations

import math
import random

import networkx as nx

from repro_torch.core.netem import LinkCfg


def _new_graph(name: str) -> nx.Graph:
    g = nx.Graph(topology=name)
    g.graph["hosts"] = []
    return g


def _add_host(g: nx.Graph, name: str) -> str:
    g.add_node(name, kind="host")
    g.graph["hosts"].append(name)
    return name


def _add_switch(g: nx.Graph, name: str) -> str:
    g.add_node(name, kind="switch")
    return name


def _link(g: nx.Graph, a: str, b: str, *, lat_ms: float, bw_mbps: float,
          loss_pct: float = 0.0) -> None:
    g.add_edge(a, b, cfg=LinkCfg(lat_ms=lat_ms, bw_mbps=bw_mbps,
                                 loss_pct=loss_pct))


def star(n_hosts: int, *, seed: int = 0, lat_ms: float = 1.0,
         bw_mbps: float = 1_000.0, loss_pct: float = 0.0) -> nx.Graph:
    """All hosts on one switch."""
    g = _new_graph("star")
    s = _add_switch(g, "s0")
    for i in range(n_hosts):
        _link(g, _add_host(g, f"h{i}"), s, lat_ms=lat_ms, bw_mbps=bw_mbps,
              loss_pct=loss_pct)
    return g


def chain(n_hosts: int, *, seed: int = 0, lat_ms: float = 1.0,
          bw_mbps: float = 1_000.0, loss_pct: float = 0.0) -> nx.Graph:
    """Hosts hanging off a linear backbone of switches."""
    g = _new_graph("chain")
    prev = None
    for i in range(n_hosts):
        s = _add_switch(g, f"s{i}")
        _link(g, _add_host(g, f"h{i}"), s, lat_ms=lat_ms, bw_mbps=bw_mbps,
              loss_pct=loss_pct)
        if prev is not None:
            _link(g, prev, s, lat_ms=lat_ms, bw_mbps=bw_mbps,
                  loss_pct=loss_pct)
        prev = s
    return g


def tree(n_hosts: int, *, seed: int = 0, fanout: int = 4,
         lat_ms: float = 1.0, bw_mbps: float = 1_000.0,
         loss_pct: float = 0.0) -> nx.Graph:
    """Balanced switch tree; hosts attach round-robin to the leaves."""
    assert fanout >= 2, fanout
    g = _new_graph("tree")
    n_leaves = max(1, math.ceil(n_hosts / fanout))
    depth = 1
    while fanout ** depth < n_leaves:
        depth += 1
    level = [_add_switch(g, "s0")]
    idx = 1
    for _ in range(depth):
        nxt = []
        for s in level:
            for _ in range(fanout):
                c = _add_switch(g, f"s{idx}")
                idx += 1
                _link(g, s, c, lat_ms=lat_ms, bw_mbps=bw_mbps,
                      loss_pct=loss_pct)
                nxt.append(c)
        level = nxt
    for i in range(n_hosts):
        _link(g, _add_host(g, f"h{i}"), level[i % len(level)],
              lat_ms=lat_ms, bw_mbps=bw_mbps, loss_pct=loss_pct)
    return g


def fat_tree(n_hosts: int, *, seed: int = 0, k: int = 0,
             lat_ms: float = 0.5, bw_mbps: float = 1_000.0,
             loss_pct: float = 0.0) -> nx.Graph:
    """Classic k-ary fat-tree (k pods, (k/2)^2 cores, k^3/4 host slots).

    ``k`` (even) is chosen automatically as the smallest size fitting
    ``n_hosts`` unless given.  Hosts fill edge switches in order.
    """
    if not k:
        k = 2
        while k ** 3 // 4 < n_hosts:
            k += 2
    assert k % 2 == 0 and k ** 3 // 4 >= n_hosts, (k, n_hosts)
    g = _new_graph("fat_tree")
    half = k // 2
    cores = [_add_switch(g, f"c{i}") for i in range(half * half)]
    edges = []
    for p in range(k):
        aggs = [_add_switch(g, f"a{p}_{j}") for j in range(half)]
        pod_edges = [_add_switch(g, f"e{p}_{j}") for j in range(half)]
        for e in pod_edges:
            for a in aggs:
                _link(g, e, a, lat_ms=lat_ms, bw_mbps=bw_mbps,
                      loss_pct=loss_pct)
        for j, a in enumerate(aggs):
            for c in cores[j * half:(j + 1) * half]:
                _link(g, a, c, lat_ms=lat_ms, bw_mbps=bw_mbps,
                      loss_pct=loss_pct)
        edges.extend(pod_edges)
    for i in range(n_hosts):
        _link(g, _add_host(g, f"h{i}"), edges[i // half],
              lat_ms=lat_ms, bw_mbps=bw_mbps, loss_pct=loss_pct)
    return g


def geo_wan(n_hosts: int, *, seed: int = 0, extent_km: float = 5_000.0,
            extra_edge_frac: float = 0.3, bw_mbps: float = 1_000.0,
            loss_pct: float = 0.0, km_per_ms: float = 200.0,
            core_frac: float = 0.0, core_bw_mbps: float = 10_000.0,
            access_bw_range: tuple = (100.0, 400.0),
            access_extra_lat_ms: tuple = (0.2, 2.0)) -> nx.Graph:
    """Random geographic WAN with latency drawn from link distance.

    Sites are placed uniformly in an ``extent_km`` square; the backbone
    is the Euclidean minimum spanning tree (always connected) plus
    ``extra_edge_frac * n_hosts`` random shortcut edges for path
    redundancy.  Link latency is distance over the fiber propagation
    speed (~200 km/ms); site coordinates live in ``g.graph["pos"]``.

    **Heterogeneous tiers** (``core_frac > 0``): a seed-drawn sample of
    ``core_frac * n_hosts`` sites (min 2) forms the *core* tier.  Links
    between two core sites are provisioned backbone fiber — fixed
    ``core_bw_mbps``, pure propagation latency — while every other
    (*access*) link draws its bandwidth uniformly from
    ``access_bw_range`` and adds a last-mile latency penalty drawn from
    ``access_extra_lat_ms``.  All draws come from the one seeded stream
    in deterministic wiring order, so a fixed (n_hosts, seed, kwargs)
    still reproduces the identical graph; ``core_frac=0`` (default)
    draws nothing extra and reproduces the homogeneous legacy graph
    bit-for-bit.  Core site names live in ``g.graph["core"]``.
    """
    rng = random.Random(seed)
    g = _new_graph("geo_wan")
    pos: dict[str, tuple[float, float]] = {}
    for i in range(n_hosts):
        h = _add_host(g, f"h{i}")
        pos[h] = (rng.uniform(0.0, extent_km), rng.uniform(0.0, extent_km))
    g.graph["pos"] = pos
    hosts = g.graph["hosts"]
    core: set[str] = set()
    if core_frac > 0 and n_hosts >= 2:
        k = min(n_hosts, max(2, round(core_frac * n_hosts)))
        core = set(rng.sample(hosts, k))
    g.graph["core"] = sorted(core)
    if n_hosts <= 1:
        return g

    def dist(a: str, b: str) -> float:
        (ax, ay), (bx, by) = pos[a], pos[b]
        return math.hypot(ax - bx, ay - by)

    def wire(a: str, b: str) -> None:
        lat = max(0.05, dist(a, b) / km_per_ms)
        if not core:
            bw = bw_mbps
        elif a in core and b in core:
            bw = core_bw_mbps
        else:
            lat += rng.uniform(*access_extra_lat_ms)
            bw = rng.uniform(*access_bw_range)
        _link(g, a, b, lat_ms=lat, bw_mbps=bw, loss_pct=loss_pct)

    # Prim's MST (deterministic: distance then name tie-break)
    best = {h: (dist(hosts[0], h), hosts[0]) for h in hosts[1:]}
    while best:
        h = min(best, key=lambda x: (best[x][0], x))
        _, parent = best.pop(h)
        wire(parent, h)
        for o in best:
            nd = dist(h, o)
            if nd < best[o][0]:
                best[o] = (nd, h)
    n_extra = int(extra_edge_frac * n_hosts)
    added = tries = 0
    while added < n_extra and tries < 50 * max(1, n_extra):
        tries += 1
        a, b = rng.sample(hosts, 2)
        if not g.has_edge(a, b):
            wire(a, b)
            added += 1
    return g


GENERATORS = {
    "star": star,
    "chain": chain,
    "tree": tree,
    "fat_tree": fat_tree,
    "geo_wan": geo_wan,
}


def generate(name: str, n_hosts: int, *, seed: int = 0, **kw) -> nx.Graph:
    """Dispatch to a registered generator by name."""
    try:
        gen = GENERATORS[name]
    except KeyError:
        raise ValueError(
            f"unknown topology {name!r}; known: {sorted(GENERATORS)}")
    return gen(n_hosts, seed=seed, **kw)


def hosts_of(g: nx.Graph) -> list[str]:
    """Hosts in deterministic creation order (placement contract)."""
    return list(g.graph["hosts"])


def node_index(g: nx.Graph) -> dict[str, int]:
    """Node name -> dense integer index, in graph insertion order.

    This is the exact index space the per-epoch routing tables
    (``repro_torch.core.netem``, ``route_mode="table"``) key their distance /
    latency / bottleneck rows on — switches included, not just hosts.
    Exposed so benchmarks and analysis code can translate vectorized
    routing state back to names without re-deriving the convention.
    """
    return {n: i for i, n in enumerate(g.nodes)}
