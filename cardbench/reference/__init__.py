"""The benchmark's plain references: ``plain.py`` holds the decoder's
math in float32 PyTorch, and ``<config>.py`` each configuration's layer.
Nothing here imports the program under test or JAX."""
