"""dalle_mtf_tpu_torch — the PyTorch/CUDA port of ``dalle_mtf_tpu`` for one
NVIDIA H100.

Module names mirror the JAX package (``models/dalle.py`` here is the port of
``dalle_mtf_tpu/models/dalle.py``, and so on) and parameter trees keep the
JAX tree's names and shapes, so weights cross between the two as plain
numpy mappings (``utils/convert.py``). The port imports ``torch`` and numpy,
never ``jax``.

Nothing is imported eagerly: importing a submodule pulls in only what it
needs.
"""

__version__ = "0.1.0"
