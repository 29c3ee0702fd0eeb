"""One loop per kind of traffic (``"kind"`` in ``traffic/*.json``): it
makes the cell's inputs from the seed, drives the program's entry
through set-up and the window, keeps what the timed path produced, and
works out the same from the plain reference.

A loop is ``Loop(run)`` with:

- ``setup()``: weights, state and warm-up (counted in ``setup_s``);
- ``window(seconds)``: whole units of work until ``seconds`` have passed;
  then ``e2e()`` (the end-to-end metrics it can give), ``attempted``,
  ``failed``, ``units``, ``per_unit`` (launches expected a unit) and
  ``least_s`` (the least time of the window's work at the card's peaks);
- ``kept()``: the program's outputs for the check, on the host;
- ``release()``: drop the program's state;
- ``reference(lp, prog)``: the reference's outputs in the same form, and
  ``compare(prog, ref)``: {number: value}.
"""
from __future__ import annotations

import importlib


def loop_for(kind: str):
    return importlib.import_module(f"benchlib.loops.{kind}").Loop
