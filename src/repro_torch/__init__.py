"""PyTorch/CUDA port of the stream2gym reproduction (``repro``).

Module names mirror ``repro``: ``core`` (the emulator, copied), ``configs``,
``kernels`` (hand-written CUDA attention kernels for Hopper, with plain
torch versions), ``models`` (dense decoder LMs and xLSTM), ``optim``,
``train``, ``data``, ``checkpoint``, ``runtime``, ``launch.serve`` and
``launch.train``.  The package imports neither ``jax`` nor ``repro``.

Importing it is light: no torch import, no kernel build, no GPU touched.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
