"""The layers of a configuration, each made of two kinds: a mixer and a
feed-forward layer (ffn), each kind a module of its own,
``layers/<kind>.py``, found by name.

A configuration file may state its period, ``"layers": [[mixer, ffn],
...]``, in the port's kind names (``attn``, ``attn_local``, ``mamba``,
``mlp``, ``moe``, ``none``, ...).  Without it the period is one layer of
attention and a SwiGLU (``mlp``), or routed experts (``moe``) where the
file has ``num_local_experts``.  ``num_hidden_layers`` is a whole number
of periods; layer ``l`` is index ``i = l % P`` of group ``g = l // P`` (P
the period's length), its leaves named ``groups.{g}.l{i}.`` as the port's
``state_dict`` names them.

Every kind gives (``c`` a configuration file):

- ``ROLE``: ``"mixer"`` or ``"ffn"``, its place in a layer;
- ``leaves(c, p)``: its sublayer's weights, its norm first, under the
  prefix ``p`` (``weights.Leaf``);
- ``check(c, arch)``: {setting: (the port's value, the file's)} of what
  it reads from the file, against the port's ``ArchConfig``;
- ``matrix(c)``, ``params(c)``: the matrix parameters a token passes
  through, and all of the sublayer's parameters;
- ``launches(unit)``: {kernel: launches} a layer makes in a ``train``
  forward, a ``prefill`` or a ``decode`` step, each kernel a module
  ``repro_torch.kernels.<kernel>`` with a ``launches`` counter.

A mixer holds decode state (every mixer of the port does) and also gives:

- ``flops(c, B, sq, sk)``: its FLOPs beyond the matrix products, for B
  rows of sq queries that end sk positions;
- ``state_read(c, B, pos)``, ``state_written(c, S)``: the bytes of state
  a decode step at ``pos`` reads and a prefill of S writes;
- ``history(c, seed, layer, B, length, device)``: the state before a
  decode, drawn from the seed on the streams ``(2, layer, ...)``, as
  {name: tensor} in the port's cache layout, rows first;
- ``CARRIED``: the names of the state that a decode step overwrites in
  place rather than at its own position: the decode loop puts their
  history back before each request;
- ``CHECK``: the check number its state is compared under;
- what the checks compare, in one layout, rows first: ``port_prefill(
  state, P)`` and ``ref_prefill(state, P)`` (a prefill's state at the
  sampled positions P, from the port's cache and from the reference's
  layer), ``port_decode(state, rows, new)`` (the rows' state at the
  positions ``new``, a slice, from the port's cache) and
  ``ref_history(state, rows, start)`` (the history's first ``start``
  positions of the rows, float32, as the reference's layer takes it).
"""
from __future__ import annotations

from dataclasses import dataclass

from benchlib import spec

DIR = spec.BENCH_DIR / "layers"


def kind(name: str):
    """``layers/<name>.py``."""
    path = DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"layer kind {name!r}: no module cardbench/layers/{name}.py")
    return spec.load_module(path, f"cardbench_layer_{name}")


def period(c: dict) -> list[tuple[str, str]]:
    """The configuration's period of (mixer, ffn) kind names."""
    if "layers" in c:
        return [tuple(x) for x in c["layers"]]
    return [("attn", "moe" if c.get("num_local_experts") else "mlp")]


@dataclass(frozen=True)
class Layer:
    index: int
    g: int                  # its group (a repetition of the period)
    i: int                  # its index in the period
    mixer: object           # layers/<mixer>.py
    ffn: object             # layers/<ffn>.py

    @property
    def prefix(self) -> str:
        return f"groups.{self.g}.l{self.i}."

    @property
    def kinds(self) -> tuple:
        return (self.mixer, self.ffn)


def layers(c: dict) -> list[Layer]:
    """Every layer of ``c``, in order."""
    per = period(c)
    L, P = c["num_hidden_layers"], len(per)
    if not P or L % P:
        raise ValueError(f"{c.get('name', c.get('arch'))}: "
                         f"num_hidden_layers {L} is not a whole number of "
                         f"periods of {P} layers")
    mods = []
    for mixer, ffn in per:
        pair = (kind(mixer), kind(ffn))
        for name, mod, role in zip((mixer, ffn), pair, ("mixer", "ffn")):
            if mod.ROLE != role:
                raise ValueError(f"layer kind {name!r} is a {mod.ROLE}, "
                                 f"stated as a layer's {role}")
        mods.append(pair)
    return [Layer(l, l // P, l % P, *mods[l % P]) for l in range(L)]


def launches(c: dict, unit: str) -> dict:
    """{kernel: launches} of all layers in one ``unit``."""
    out: dict = {}
    for layer in layers(c):
        for k in layer.kinds:
            for name, n in k.launches(unit).items():
                out[name] = out.get(name, 0) + n
    return out
