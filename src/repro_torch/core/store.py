"""Data store components (MySQL / RocksDB / KV stand-ins).

The paper's maritime-monitoring pipeline writes windowed results to an
*external* key-value store.  Stores here are in-memory dicts with a network
hop + per-op service-time model; a JSON persistence option covers the
"persistent storage" feature of Table II.
"""
from __future__ import annotations

import json
from typing import Any

from repro_torch.core.spec import Component

PUT_COST_S = 100e-6
GET_COST_S = 50e-6

_REGISTRY: dict[str, "StoreRuntime"] = {}


class StoreRuntime:
    def __init__(self, comp: Component, host: str):
        self.comp = comp
        self.host = host
        self.name = comp.name
        self.data: dict[Any, Any] = {}
        self.n_puts = 0
        _REGISTRY[comp.get("storeName", comp.name)] = self
        _REGISTRY[host] = self          # addressable by host too

    def start(self, eng) -> None:
        pass

    # --- remote API (called by SPEs/consumers through the engine) ---------

    def remote_put(self, eng, src_host: str, key: Any, value: Any,
                   size: int = 64) -> None:
        delay, lost = eng.net.transfer(src_host, self.host, size,
                                       eng.client_rng("store:" + self.name))
        if delay is None or lost:
            return

        def _apply():
            def _commit():
                self.data[key] = value
                self.n_puts += 1
            eng.execute_on(self.host, PUT_COST_S, _commit)

        eng.schedule(delay, _apply)

    def persist(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({str(k): v for k, v in self.data.items()},
                      f, default=str)


def make_store(comp: Component, host: str) -> StoreRuntime:
    return StoreRuntime(comp, host)


def lookup(name: str) -> StoreRuntime:
    return _REGISTRY[name]


def reset_registry() -> None:
    _REGISTRY.clear()
