"""PyTorch/CUDA port of the ERA suffix-tree system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core``, ``kernels``, ``data``, ``launch``) and its module and function
names, imports only ``torch`` and ``numpy``, and runs its hot kernels as
hand-written CUDA for Hopper (``kernels/csrc``).  Entry points take an
explicit ``device`` argument that defaults to ``"cuda"``; ``device="cpu"``
runs every kernel's plain PyTorch version instead.
"""
