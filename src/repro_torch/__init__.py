"""PyTorch + CUDA port of the sparse-transformer serving stack.

The layout mirrors ``src/repro/`` module for module: ``core/`` (TwELL
format, sparse FFN), ``kernels/`` (hand-written Hopper kernels in
``kernels/csrc/`` beside their plain PyTorch versions), ``models/``
(layers, paged LM), ``serving/`` (paged KV cache, scheduler, engine) and
``launch/serve.py``. ``bridge.py`` loads the JAX package's parameters.

The package imports torch, numpy and the standard library only. Its entry
points run on the CUDA card unless the caller passes ``device="cpu"``;
a CPU tensor takes each kernel's plain version, a CUDA tensor launches the
kernel.
"""
