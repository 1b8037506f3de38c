"""Check-N-Run in PyTorch for one NVIDIA H100: the port of ``src/repro``.

Mirrors the reference package's layout (``core/``, ``kernels/``,
``models/``, ``optim/``, ``train/``, ``data/``, ``configs/``, ``serve/``,
``launch/``). It imports neither JAX nor the reference package. Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
