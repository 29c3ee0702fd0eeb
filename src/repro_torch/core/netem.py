"""Network emulation model: links, paths, transfer times, loss.

The paper's Mininet substrate provides per-link latency/bandwidth/loss via
``tc``/netem.  On a CPU-only container we model the network analytically:
an undirected topology graph whose edges carry ``LinkCfg``; message delivery
time = path propagation latency + serialization time at the bottleneck
link; loss composes per-link Bernoulli draws.  Faults toggle per-link /
per-host ``up`` flags and reachability is recomputed on demand.

Routing runs in one of two modes, selected by ``route_mode``:

``"table"`` (default)
    Per-epoch **vectorized routing tables**: the first query after an
    epoch bump runs one ``scipy.sparse.csgraph.dijkstra`` pass over
    integer host indices (all-pairs distances + predecessors), then one
    global level-order tree accumulation over the predecessor forest
    derives the full latency / bottleneck-bandwidth / loss-keep
    matrices.  ``transfer``/``path_latency_s`` become O(1) matrix
    lookups; hop paths are reconstructed from the predecessor matrix
    only when actually requested.  Equal-cost ties (multiple
    float-exact shortest paths) are detected per source and fall back
    to ``networkx`` SSSP for that source, so the chosen paths — and
    therefore every delay/loss value — are **bit-identical** to the
    on-demand path.  Counters (``n_path_queries``/``n_graph_builds``)
    are emulated one-for-one against the on-demand accounting so
    fingerprints match across modes.

``"ondemand"``
    The legacy per-source ``networkx`` SSSP cache, kept as the parity
    baseline (the routing-table test suite asserts bit-identical event
    streams between the modes).  ``reach_cache=False`` always implies
    on-demand behavior: the recompute-every-query baseline is the whole
    point of that knob.

Invalidation contract: topology transitions (``add_host``/``add_link``/
``set_link_up``/``set_host_up``) bump ``epoch`` and drop the tables.
Loss changes ride a separate ``loss_epoch`` (``set_link_loss``) that
invalidates only the loss-keep rows — gray-loss faults must go through
that seam, never mutate ``LinkCfg.loss_pct`` mid-run directly.
``set_host_slow`` bumps nothing by design: slow extras apply at query
time on top of the table lookup.
"""
from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass
from typing import Optional

import networkx as nx
import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra as _apsp_dijkstra

from repro_torch.kernels import netcalc

# The reference's TPU chip/interconnect constants and its
# ``collective_time_s`` roofline helper are not copied: they serve the
# roofline analysis (ROADMAP A12a) and the dry run that prices the step
# bundles (A12c), neither of which is ported yet.  The bundles themselves,
# train, prefill and decode, are (``train/steps.py``).


@dataclass
class LinkCfg:
    """Table I link attributes: lat (ms), bw (Mbps), loss (%), ports."""

    lat_ms: float = 0.1
    bw_mbps: float = 1_000.0
    loss_pct: float = 0.0
    src_port: int = 0
    dst_port: int = 0
    up: bool = True

    @property
    def lat_s(self) -> float:
        return self.lat_ms * 1e-3

    @property
    def bw_Bps(self) -> float:
        return self.bw_mbps * 1e6 / 8.0


class _EdgeStatic:
    """Topology-static edge arrays, shared across epoch rebuilds.

    Node order and link latency/bandwidth never change after
    ``add_host``/``add_link`` (fault hooks only flip ``LinkCfg.up`` and
    ``loss_pct``), so each :class:`_RouteTables` build filters these
    precomputed arrays instead of re-walking ``g.edges`` in Python.
    Hop values are the exact ``LinkCfg`` property expressions, captured
    once.  Invalidated by the ``Network`` on any graph mutation.
    """

    __slots__ = ("nodes", "idx", "cfgs", "l_a", "l_b", "fe_src",
                 "fe_dst", "fe_w_ms", "fe_lat_s", "fe_bw", "fe_link")

    def __init__(self, g: "nx.Graph") -> None:
        self.nodes = list(g.nodes)
        self.idx = {name: i for i, name in enumerate(self.nodes)}
        idx = self.idx
        src, dst, w_ms, lat_s, bw, link_of = [], [], [], [], [], []
        l_a, l_b = [], []
        self.cfgs: list[LinkCfg] = []
        for a, b, d in g.edges(data=True):
            cfg = d["cfg"]
            ia, ib = idx[a], idx[b]
            k = len(self.cfgs)
            self.cfgs.append(cfg)
            l_a.append(ia)
            l_b.append(ib)
            for u, v in ((ia, ib), (ib, ia)):
                src.append(u)
                dst.append(v)
                w_ms.append(cfg.lat_ms)
                lat_s.append(cfg.lat_s)
                bw.append(cfg.bw_Bps)
                link_of.append(k)
        self.l_a = np.asarray(l_a, dtype=np.int64)
        self.l_b = np.asarray(l_b, dtype=np.int64)
        self.fe_src = np.asarray(src, dtype=np.int64)
        self.fe_dst = np.asarray(dst, dtype=np.int64)
        self.fe_w_ms = np.asarray(w_ms, dtype=np.float64)
        self.fe_lat_s = np.asarray(lat_s, dtype=np.float64)
        self.fe_bw = np.asarray(bw, dtype=np.float64)
        self.fe_link = np.asarray(link_of, dtype=np.int64)


class _RouteTables:
    """Per-epoch vectorized routing state (``route_mode="table"``).

    One scipy all-pairs Dijkstra at build time, then one global
    depth-ordered sweep over the predecessor forest derives the full
    latency (``LAT``) and bottleneck-bandwidth (``BNECK``) matrices —
    every source at once, no per-source lazy rebuild on the hot path.
    The loss-keep matrix replays the same level decomposition and is
    rebuilt wholesale when the network's ``loss_epoch`` moves (gray
    ramps), leaving the routing tables untouched.

    Float contract: the sweep reproduces the on-demand hop walk
    **bitwise** — latency accumulates left-to-right along each path
    (``lat[u] = lat[pred[u]] + hop_lat_s``), bottleneck bandwidth is an
    exact ``min`` chain, and keep multiplies hop factors in path order.
    Hop values use the exact ``LinkCfg`` property expressions
    (``lat_ms * 1e-3``, ``bw_mbps * 1e6 / 8.0``, ``1 - loss_pct/100``).
    Equal-cost ties (multiple float-exact candidate predecessors) are
    detected per source in one vectorized pass; tie sources get their
    predecessor row replaced by networkx's choice, which defines the
    tie-break contract.
    """

    __slots__ = ("nodes", "idx", "n", "live_node", "live_list", "e_src",
                 "e_dst", "e_w_ms", "e_lat_s", "e_bw", "e_link",
                 "edge_cfgs", "_eidx", "D", "P", "HOPE", "LAT", "BNECK",
                 "KEEP", "keep_epoch", "_sf", "_sb", "_bounds",
                 "_nx_paths", "_row_cache")

    def __init__(self, net: "Network") -> None:
        st = net._edge_static
        if st is None:
            st = net._edge_static = _EdgeStatic(net.g)
        self.nodes = st.nodes
        self.idx = st.idx
        n = self.n = len(st.nodes)
        live = np.fromiter((net._host_up.get(nm, True)
                            for nm in st.nodes), dtype=bool, count=n)
        self.live_node = live
        self.live_list = live.tolist()      # plain bools for hot lookups
        # scalar-query row caches (python floats, filled lazily per
        # queried source: numpy scalar extraction is ~10x a list index)
        self._row_cache: dict[int, tuple] = {}
        # filter the topology-static edge arrays down to live up edges
        # (same g.edges order as a direct walk, so every downstream
        # float lands in the identical position)
        n_links = len(st.cfgs)
        up = np.fromiter((c.up for c in st.cfgs), dtype=bool,
                         count=n_links)
        keep_l = up & live[st.l_a] & live[st.l_b]
        kept = np.flatnonzero(keep_l)
        new_id = np.full(n_links, -1, dtype=np.int64)
        new_id[kept] = np.arange(kept.size)
        ke = keep_l[st.fe_link]
        self.edge_cfgs = [st.cfgs[i] for i in kept.tolist()]
        self.e_src = st.fe_src[ke]
        self.e_dst = st.fe_dst[ke]
        self.e_w_ms = st.fe_w_ms[ke]
        self.e_lat_s = st.fe_lat_s[ke]
        self.e_bw = st.fe_bw[ke]
        self.e_link = new_id[st.fe_link[ke]]
        # dense directed-edge index (hop attribute gathers); n is a few
        # thousand at most, so n^2 int32 stays small
        self._eidx = np.full((n, n), -1, dtype=np.int32)
        if self.e_src.size:
            self._eidx[self.e_src, self.e_dst] = \
                np.arange(self.e_src.size, dtype=np.int32)
        graph = csr_matrix((self.e_w_ms, (self.e_src, self.e_dst)),
                           shape=(n, n))
        # distances are the min-plus fixpoint of the relaxation — the
        # same float64 values networkx Dijkstra produces, bitwise
        # (fuzzed in tests/test_routing_table.py); predecessors are
        # only trusted for tie-free sources
        self.D, pred = _apsp_dijkstra(
            graph, directed=True, return_predecessors=True)
        net.n_route_solves += 1
        finite = np.isfinite(self.D)
        P = pred.astype(np.int32, copy=True)
        P[~finite] = -1
        np.fill_diagonal(P, -1)
        # tie detection, all sources at once: count float-exact
        # candidate predecessors per (source, node); any node with >1
        # has equal-cost shortest paths, and which one wins depends on
        # relaxation order — networkx's choice defines the contract
        for si in self._tie_sources(finite):
            net.n_route_solves += 1
            paths = nx.single_source_dijkstra_path(
                net._live_graph(), self.nodes[si], weight="weight")
            self._nx_paths[si] = paths
            row = np.full(n, -1, dtype=np.int32)
            for name, p in paths.items():
                if len(p) >= 2:
                    row[self.idx[name]] = self.idx[p[-2]]
            P[si] = row
        self.P = P
        has = P >= 0
        HOPE = np.full((n, n), -1, dtype=np.int32)
        fr, fc = np.nonzero(has)
        # flat linear indices: every sweep op below indexes one raveled
        # (n*n,) array instead of recomputing row*n+col per fancy index
        flat = fr * n + fc
        base = fr * n
        HOPE.ravel()[flat] = self._eidx.ravel()[P.ravel()[flat] * n + fc]
        self.HOPE = HOPE
        self._sweep(flat, base)
        self._rebuild_keep(net.loss_epoch)

    def _tie_sources(self, finite: np.ndarray) -> np.ndarray:
        self._nx_paths: dict[int, dict[str, list[str]]] = {}
        n = self.n
        if not self.e_src.size:
            return np.zeros(0, dtype=np.int64)
        # (n, E) relaxation-equality mask, reduced per destination node
        M = ((self.D[:, self.e_src] + self.e_w_ms
              == self.D[:, self.e_dst])
             & finite[:, self.e_src] & finite[:, self.e_dst])
        order = np.argsort(self.e_dst, kind="stable")
        gd = self.e_dst[order]
        starts = np.flatnonzero(np.r_[True, gd[1:] != gd[:-1]])
        cand = np.add.reduceat(M[:, order], starts, axis=1)
        # a node is never its own-source candidate
        cand[gd[starts], np.arange(starts.size)] = 0
        return np.flatnonzero((cand > 1).any(axis=1))

    def _sweep(self, flat: np.ndarray, base: np.ndarray) -> None:
        """One global level-order accumulation over every source's
        predecessor tree: a node's value derives from its (already
        final) predecessor, which is exactly the on-demand hop walk's
        left-to-right float order — just batched across sources.

        ``flat``/``base`` are the raveled pair indices (``row*n + col``
        and ``row*n``) of every finite non-diagonal pair.
        """
        n = self.n
        Pf = self.P.ravel()
        HOPEf = self.HOPE.ravel()
        # exact tree depth per (source, node) via pointer doubling:
        # O(log depth) passes instead of one pass per level
        depthf = np.zeros(n * n, dtype=np.int32)
        ptrf = Pf.copy()
        depthf[flat] = 1
        cur, cb = flat, base
        while cur.size:
            a = ptrf[cur]
            alive = a >= 0
            cur, cb, a = cur[alive], cb[alive], a[alive]
            pf = cb + a
            depthf[cur] += depthf[pf]
            ptrf[cur] = ptrf[pf]
            alive = ptrf[cur] >= 0
            cur, cb = cur[alive], cb[alive]
        fd = depthf[flat]
        # depth-major order: each level's predecessors are final before
        # the level is applied, so one vectorized pass per level
        dm = np.argsort(fd, kind="stable")
        sf, sb, sd = flat[dm], base[dm], fd[dm]
        LATf = np.zeros(n * n)
        BNECKf = np.full(n * n, math.inf)
        e_lat, e_bw = self.e_lat_s, self.e_bw
        bounds = sd.searchsorted(
            np.arange(1, (int(sd[-1]) if sd.size else 0) + 2))
        for li in range(len(bounds) - 1):
            s, e = bounds[li], bounds[li + 1]
            f = sf[s:e]
            pf = sb[s:e] + Pf[f]
            he = HOPEf[f]
            LATf[f] = LATf[pf] + e_lat[he]
            BNECKf[f] = np.minimum(BNECKf[pf], e_bw[he])
        self.LAT = LATf.reshape(n, n)
        self.BNECK = BNECKf.reshape(n, n)
        # the level decomposition, kept for loss-epoch keep rebuilds
        self._sf, self._sb, self._bounds = sf, sb, bounds

    def _rebuild_keep(self, loss_epoch: int) -> None:
        """Path-composed keep probability, all pairs — replays the
        stored level decomposition with the current per-edge keep
        factors (``set_link_loss`` bumps ``loss_epoch`` to get here)."""
        e_keep = np.asarray([1.0 - cfg.loss_pct / 100.0
                             for cfg in self.edge_cfgs])[self.e_link] \
            if self.edge_cfgs else np.zeros(0)
        n = self.n
        KEEPf = np.ones(n * n)
        Pf, HOPEf = self.P.ravel(), self.HOPE.ravel()
        sf, sb, bounds = self._sf, self._sb, self._bounds
        for li in range(len(bounds) - 1):
            s, e = bounds[li], bounds[li + 1]
            f = sf[s:e]
            KEEPf[f] = KEEPf[sb[s:e] + Pf[f]] * e_keep[HOPEf[f]]
        self.KEEP = KEEPf.reshape(n, n)
        self.keep_epoch = loss_epoch
        # keep factors ride the merged scalar row cache — drop it all
        self._row_cache.clear()

    def keep_row(self, net: "Network", si: int) -> np.ndarray:
        """Keep-probability row for one source (rebuilds the matrix if
        a gray-loss transition moved ``loss_epoch``)."""
        if self.keep_epoch != net.loss_epoch:
            self._rebuild_keep(net.loss_epoch)
        return self.KEEP[si]

    def hop_path(self, net: "Network", si: int,
                 di: int) -> Optional[list[str]]:
        """Hop list src..dst, identical to the networkx path."""
        if si == di:
            return [self.nodes[si]]
        if not np.isfinite(self.D[si, di]):
            return None
        nxp = self._nx_paths.get(si)
        if nxp is not None:
            return nxp.get(self.nodes[di])
        pred_row = self.P[si]
        out = [self.nodes[di]]
        j = di
        while j != si:
            j = int(pred_row[j])
            out.append(self.nodes[j])
        out.reverse()
        return out


class Network:
    """Topology + reachability + message timing.

    Reachability and routes are memoized **per network epoch**: the epoch
    counter bumps on every topology transition (link/host up-down, new
    links), which invalidates a connected-components map (O(1)
    ``reachable`` lookups — the controller's O(topics × brokers) probe
    loop stops dominating at several hundred nodes) and the routing
    state: vectorized per-epoch tables (``route_mode="table"``, the
    default — see the module docstring) or a per-source SSSP cache
    (``route_mode="ondemand"``, the parity baseline).
    ``reach_cache=False`` keeps the exact same algorithms but recomputes
    on every query — the "before" baseline the scale benchmark compares
    against; results must be bit-identical either way (asserted there
    via engine event counts).
    """

    def __init__(self) -> None:
        self.g = nx.Graph()
        self._host_up: dict[str, bool] = {}
        # gray degradation: per-host extra transfer delay (slow-broker
        # ack model).  Empty in healthy runs — the hot path pays one
        # falsy check and reachability/routing are untouched, so no
        # epoch bump is needed when a host slows down or recovers.
        self.slow_extra_s: dict[str, float] = {}
        self.reach_cache = True     # per-epoch memoization toggle
        self.route_mode = "table"   # "table" | "ondemand" (parity knob)
        self.epoch = 0              # bumps on every topology transition
        self.loss_epoch = 0         # bumps on set_link_loss only
        self._live: Optional[nx.Graph] = None
        self._comp_id: Optional[dict[str, int]] = None
        self._sssp: dict[str, dict[str, list[str]]] = {}
        self._tables: Optional[_RouteTables] = None
        # topology-static edge arrays (see _EdgeStatic): survive epoch
        # bumps, dropped only when the graph itself gains nodes/links
        self._edge_static: Optional[_EdgeStatic] = None
        # table-build wall accrued inside the current accounted call,
        # moved to the "netem_build" bucket by _accounted
        self._build_wall_pending = 0.0
        # sources queried this epoch (table mode): emulates the
        # on-demand per-source build accounting one-for-one
        self._tab_seen: set[str] = set()
        # (src, dst) -> (latency,) memo for path_latency_s in on-demand
        # mode (satellite: the parity baseline skips recomputation the
        # tables obviously avoid; counters stay pinned — see the method)
        self._lat_memo: dict[tuple[str, str], tuple] = {}
        # instrumentation (benchmarks / regression gates)
        self.n_reach_queries = 0    # reachable() calls
        self.n_path_queries = 0     # route queries (path/transfer/latency)
        self.n_graph_builds = 0     # expensive recomputes (SSSP/components)
        # actual shortest-path solver invocations — one nx SSSP in
        # on-demand mode, one vectorized all-pairs pass (or tie-source
        # fallback) in table mode.  Deliberately NOT fingerprinted: the
        # whole point is that it differs between route modes, and the
        # scale benchmark gates on its deterministic reduction ratio.
        self.n_route_solves = 0
        # opt-in wall-clock accounting (core/telemetry.Profiler); the
        # engine attaches it when TelemetryCfg(profile=True)
        self.profiler = None

    def _invalidate(self) -> None:
        self.epoch += 1
        self._live = None
        self._comp_id = None
        self._sssp.clear()
        self._tables = None
        self._tab_seen.clear()
        self._lat_memo.clear()

    # --- construction ----------------------------------------------------

    def add_host(self, name: str) -> None:
        self.g.add_node(name)
        self._host_up[name] = True
        self._edge_static = None
        self._invalidate()

    def add_link(self, a: str, b: str, cfg: Optional[LinkCfg] = None) -> None:
        for n in (a, b):
            if n not in self.g:
                self.add_host(n)
        self.g.add_edge(a, b, cfg=cfg or LinkCfg())
        self._edge_static = None
        self._invalidate()

    def link(self, a: str, b: str) -> LinkCfg:
        return self.g.edges[a, b]["cfg"]

    def hosts(self) -> list[str]:
        return list(self.g.nodes)

    # --- fault hooks -------------------------------------------------------

    def set_link_up(self, a: str, b: str, up: bool) -> None:
        self.link(a, b).up = up
        self._invalidate()

    def set_host_up(self, name: str, up: bool) -> None:
        self._host_up[name] = up
        self._invalidate()

    def set_link_loss(self, a: str, b: str, loss_pct: float) -> None:
        """Change a link's loss rate mid-run (gray faults).

        The accounted seam for loss mutations: reachability and latency
        tables stay valid (loss does not move routes), but the composed
        keep rows are keyed by ``loss_epoch`` and rebuild on next use.
        Mutating ``LinkCfg.loss_pct`` directly after the first query
        would leave table mode serving stale keep values.
        """
        self.link(a, b).loss_pct = loss_pct
        self.loss_epoch += 1

    def set_host_slow(self, name: str, extra_s: float) -> None:
        """Gray-degrade a host: every transfer touching it as an endpoint
        pays ``extra_s`` additional delay (0 clears the degradation).
        Applied at query time on top of the table/SSSP lookup, so no
        routing invalidation is needed."""
        if extra_s > 0:
            self.slow_extra_s[name] = extra_s
        else:
            self.slow_extra_s.pop(name, None)

    def host_up(self, name: str) -> bool:
        return self._host_up.get(name, False)

    # --- reachability / timing ---------------------------------------------

    def _live_graph(self) -> nx.Graph:
        if self._live is None:
            live = nx.Graph()
            for n in self.g.nodes:
                if self._host_up.get(n, True):
                    live.add_node(n)
            for a, b, d in self.g.edges(data=True):
                if d["cfg"].up and live.has_node(a) and live.has_node(b):
                    live.add_edge(a, b, weight=d["cfg"].lat_ms)
            self._live = live
        return self._live

    def _components(self) -> dict[str, int]:
        if self._comp_id is None:
            self.n_graph_builds += 1
            self._comp_id = {}
            for i, comp in enumerate(
                    nx.connected_components(self._live_graph())):
                for n in comp:
                    self._comp_id[n] = i
        return self._comp_id

    # -- the single accounted routing seam ---------------------------------
    # Every external entry point (path / transfer / transfer_many /
    # path_latency_s, and reachable's uncached fallback) funnels its
    # routing work through exactly one wall-accounted call, in both
    # route modes: "netem_path" wall is never double-counted and its
    # count (profile_counts) is n_path_queries either way.  Per-epoch
    # table (re)builds happen lazily inside the first query after an
    # invalidation; their wall lands under "netem_build" so the path
    # bucket measures steady-state lookup cost, not the amortized
    # solver pass it pays for.

    def _accounted(self, fn, *args):
        prof = self.profiler
        if prof is None:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        b = self._build_wall_pending
        if b:
            self._build_wall_pending = 0.0
            prof.add_wall("netem_build", b)
            dt -= b
        prof.add_wall("netem_path", dt)
        return out

    def _use_tables(self) -> bool:
        return self.route_mode == "table" and self.reach_cache

    def _tables_ready(self) -> _RouteTables:
        t = self._tables
        if t is None:
            if self.profiler is None:
                t = self._tables = _RouteTables(self)
            else:
                t0 = time.perf_counter()
                t = self._tables = _RouteTables(self)
                self._build_wall_pending += time.perf_counter() - t0
        return t

    def _touch_source(self, src: str) -> None:
        """Emulate the on-demand build accounting: the first route query
        for a source in an epoch is one expensive build there (SSSP
        cache miss), and a cache hit afterwards."""
        if src not in self._tab_seen:
            self._tab_seen.add(src)
            self.n_graph_builds += 1

    # -- on-demand internals ------------------------------------------------

    def _sssp_paths(self, src: str) -> dict[str, list[str]]:
        if not self.reach_cache:        # baseline: recompute every query
            self._live = None
            self._sssp.clear()
        paths = self._sssp.get(src)
        if paths is None:
            self.n_graph_builds += 1
            self.n_route_solves += 1
            try:
                paths = nx.single_source_dijkstra_path(
                    self._live_graph(), src, weight="weight")
            except nx.NodeNotFound:     # src host is down
                paths = {}
            self._sssp[src] = paths
        return paths

    # -- public API ----------------------------------------------------------

    def path(self, src: str, dst: str) -> Optional[list[str]]:
        """Lowest-latency live path, or None if partitioned."""
        return self._accounted(self._path_q, src, dst)

    def _path_q(self, src: str, dst: str) -> Optional[list[str]]:
        self.n_path_queries += 1
        if self._use_tables():
            self._touch_source(src)
            t = self._tables_ready()
            si = t.idx.get(src)
            di = t.idx.get(dst)
            if si is None or di is None or \
                    not (t.live_node[si] and t.live_node[di]):
                return None
            return t.hop_path(self, si, di)
        return self._sssp_paths(src).get(dst)

    def reachable(self, src: str, dst: str) -> bool:
        self.n_reach_queries += 1
        if not self.reach_cache:
            return self.path(src, dst) is not None
        comp = self._components()
        ci = comp.get(src)
        return ci is not None and ci == comp.get(dst)

    def transfer(self, src: str, dst: str, nbytes: int,
                 rng: Optional[random.Random] = None
                 ) -> tuple[Optional[float], bool]:
        """(delivery_delay_seconds, lost).  delay=None when partitioned.

        delay = sum(per-hop latency) + nbytes / bottleneck_bw; loss is a
        single Bernoulli draw with the path-composed loss probability.
        """
        if self.route_mode == "table" and self.reach_cache:
            # the seam contract holds: _accounted is a straight call
            # when no profiler is attached, so skipping it here is pure
            # call-overhead removal on the hottest path in the engine
            if self.profiler is None:
                return self._transfer_t(src, dst, nbytes, rng)
            return self._accounted(self._transfer_t, src, dst, nbytes, rng)
        p = self.path(src, dst)
        if p is None:
            return None, True
        if src == dst:
            return 0.0, False
        lat = 0.0
        bw = math.inf
        keep = 1.0
        for a, b in zip(p, p[1:]):
            cfg = self.link(a, b)
            lat += cfg.lat_s
            bw = min(bw, cfg.bw_Bps)
            keep *= 1.0 - cfg.loss_pct / 100.0
        delay = lat + (nbytes / bw if bw < math.inf else 0.0)
        if self.slow_extra_s:
            delay += (self.slow_extra_s.get(src, 0.0)
                      + self.slow_extra_s.get(dst, 0.0))
        lost = bool(rng and rng.random() > keep)
        return delay, lost

    def _transfer_t(self, src: str, dst: str, nbytes: int,
                    rng) -> tuple[Optional[float], bool]:
        self.n_path_queries += 1
        seen = self._tab_seen
        if src not in seen:        # _touch_source, inlined (hot path)
            seen.add(src)
            self.n_graph_builds += 1
        t = self._tables
        if t is None:
            t = self._tables_ready()    # accounts build wall when profiled
        idx = t.idx
        si = idx.get(src)
        di = idx.get(dst)
        live = t.live_list
        if si is None or di is None or not (live[si] and live[di]):
            return None, True
        if si == di:
            return 0.0, False
        # python-float row cache: same values as the matrices (tolist is
        # exact), minus the numpy scalar-extraction overhead per query.
        # The delay expression is netcalc.delay_s verbatim (x/inf == 0.0
        # keeps unreachable-bandwidth parity with the hop walk).
        if t.keep_epoch != self.loss_epoch:
            t._rebuild_keep(self.loss_epoch)     # also drops _row_cache
        rc = t._row_cache.get(si)
        if rc is None:
            rc = t._row_cache[si] = (t.D[si].tolist(), t.LAT[si].tolist(),
                                     t.BNECK[si].tolist(),
                                     t.KEEP[si].tolist())
        if rc[0][di] == math.inf:
            return None, True
        delay = rc[1][di] + nbytes / rc[2][di]
        if self.slow_extra_s:
            delay += (self.slow_extra_s.get(src, 0.0)
                      + self.slow_extra_s.get(dst, 0.0))
        lost = bool(rng and rng.random() > rc[3][di])
        return delay, lost

    def transfer_many(self, src: str, dsts: list[str], nbytes: int,
                      rng: Optional[random.Random] = None
                      ) -> list[tuple[Optional[float], bool]]:
        """Cohort-fused transfer: one homogeneous (src, nbytes) fan-out.

        Bit-identical to calling :meth:`transfer` once per destination
        in order — same counters, same single-draw-per-live-destination
        RNG order — but the delay arithmetic for the whole cohort runs
        as one vectorized :mod:`repro_torch.kernels.netcalc` computation in
        table mode (the broker's replication fan-out rides this).
        """
        if not self._use_tables():
            return [self.transfer(src, d, nbytes, rng) for d in dsts]
        return self._accounted(self._transfer_many_t, src, dsts,
                               nbytes, rng)

    def _transfer_many_t(self, src, dsts, nbytes, rng):
        k = len(dsts)
        self.n_path_queries += k
        if k == 0:
            return []
        self._touch_source(src)
        t = self._tables_ready()
        si = t.idx.get(src)
        out: list[tuple[Optional[float], bool]] = []
        if si is None or not t.live_node[si]:
            return [(None, True)] * k
        di = np.fromiter((t.idx.get(d, -1) for d in dsts),
                         dtype=np.int64, count=k)
        known = di >= 0
        ok = known.copy()
        ok[known] &= t.live_node[di[known]]
        ok[known] &= np.isfinite(t.D[si, di[known]])
        lat_row, bneck_row = t.LAT[si], t.BNECK[si]
        keep_row = t.keep_row(self, si)
        dj = np.where(ok, di, 0)
        extra = None
        if self.slow_extra_s:
            g = self.slow_extra_s.get
            e_src = g(src, 0.0)
            extra = np.fromiter((e_src + g(d, 0.0) for d in dsts),
                                dtype=np.float64, count=k)
        delays = netcalc.delay_many(lat_row[dj], bneck_row[dj],
                                    nbytes, extra)
        keeps = keep_row[dj]
        for i, d in enumerate(dsts):
            if not ok[i]:
                out.append((None, True))
            elif di[i] == si:
                out.append((0.0, False))
            else:
                lost = bool(rng and rng.random() > float(keeps[i]))
                out.append((float(delays[i]), lost))
        return out

    def path_latency_s(self, src: str, dst: str) -> Optional[float]:
        """Propagation latency of the current route (no serialization).

        Memoized per (epoch, src, dst) in both modes: table mode is an
        O(1) row lookup; on-demand keeps a small memo so the parity
        baseline skips recomputation.  Counters stay pinned either way —
        every call is one logical route query (``n_path_queries``) and
        only the first per source per epoch is a build.
        """
        return self._accounted(self._latency_q, src, dst)

    def _latency_q(self, src: str, dst: str) -> Optional[float]:
        if self._use_tables():
            self.n_path_queries += 1
            self._touch_source(src)
            t = self._tables_ready()
            si = t.idx.get(src)
            di = t.idx.get(dst)
            if si is None or di is None or \
                    not (t.live_node[si] and t.live_node[di]):
                return None
            if t.D[si, di] == math.inf:
                return None
            return float(t.LAT[si, di])
        if self.reach_cache:
            hit = self._lat_memo.get((src, dst))
            if hit is not None:
                # the memo only skips the hop walk: the logical query
                # still counts, and the source's SSSP is necessarily
                # cached already (same epoch), so build counts match
                # the unmemoized sequence exactly
                self.n_path_queries += 1
                return hit[0]
        self.n_path_queries += 1
        p = self._sssp_paths(src).get(dst)
        val = None if p is None else \
            sum(self.link(a, b).lat_s for a, b in zip(p, p[1:]))
        if self.reach_cache:
            self._lat_memo[(src, dst)] = (val,)
        return val


def one_big_switch(hosts: list[str], *, lat_ms: float = 0.1,
                   bw_mbps: float = 1_000.0, switch: str = "s1") -> Network:
    """The paper's Fig. 2 'one big switch' abstraction."""
    net = Network()
    net.add_host(switch)
    for h in hosts:
        net.add_link(h, switch, LinkCfg(lat_ms=lat_ms, bw_mbps=bw_mbps))
    return net


def star(center: str, leaves: list[str], **kw) -> Network:
    return one_big_switch(leaves, switch=center, **kw)
